"""The port's LM serving engine against the JAX package's on the CPU.

Both engines serve the same prompts with the same parameters
(``reduced_config("qwen2-1.5b")``, 3 slots, chunks of 8), in chunked and
in sequential prefill mode; the JAX engine runs its Pallas serving
kernels in interpret mode.  Every prefill launch and decode step of the
port is held against the JAX engine's at the same point: the logits of
the active slots within 1e-4 of their largest magnitude (f32 both sides),
and the greedy token equal wherever the top-2 margin of the JAX logits
exceeds that tolerance (random weights make near-ties, and a tie is not a
fault).  The port then continues with the JAX engine's token, so one tie
cannot desynchronise the rest of the run.  Within the port, chunked
prefill is token-identical to sequential prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-4
PROMPTS = (5, 12, 3, 9, 17)
MAX_NEW = 6


@pytest.fixture(scope="module")
def params():
    cfg = jbase.reduced_config("qwen2-1.5b")
    return jax.device_get(jlm.init(jax.random.key(0), cfg))


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in PROMPTS]


def _jax_run(params, mode):
    """The JAX engine, recording (kind, active rows, logits, tokens) of
    every launch."""
    cfg = dataclasses.replace(jbase.reduced_config("qwen2-1.5b"),
                              use_pallas_attn=True)
    eng = JEngine(cfg, params, slots=3, max_len=64, prefill=mode,
                  prefill_chunk=8)
    log = []
    dec = jax.jit(lambda p, t, c, pos: jlm.decode_step(
        p, t, c, pos, cfg, policy=eng.policy))
    pre = jax.jit(lambda p, t, c, pos, lens: jlm.prefill_chunk(
        p, t, c, pos, lens, cfg, policy=eng.policy))

    def decode(p, t, c, pos, extra):
        logits, c = dec(p, t, c, pos)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        active = np.array([r is not None for r in eng.slot_req])
        log.append(("decode", active, np.asarray(logits[:, -1]),
                    np.asarray(tok)))
        return tok, c

    def prefill(p, t, c, pos, lens, extra):
        logits, c = pre(p, t, c, pos, lens)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        log.append(("prefill", np.asarray(lens) > 0,
                    np.asarray(logits[:, -1]), np.asarray(tok)))
        return tok, c

    eng._decode = decode
    if mode == "chunked":
        eng._prefill_fn = prefill
    for i, p in enumerate(_prompts()):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    done = {r.rid: r.tokens for r in eng.run()}
    return log, done


def _port_engine(params, mode, **kw):
    cfg = tbase.reduced_config("qwen2-1.5b")
    return ServeEngine(cfg, lm_from_numpy(params, "cpu"), slots=3,
                       max_len=64, prefill=mode, prefill_chunk=8,
                       device="cpu", **kw), cfg


@pytest.mark.parametrize("mode", ["chunked", "sequential"])
def test_engine_matches_jax_engine(params, mode):
    want, want_done = _jax_run(params, mode)
    eng, cfg = _port_engine(params, mode)
    assert eng.prefill_mode == mode
    seen = []

    def check(kind, active, logits):
        i = len(seen)
        assert i < len(want), "the port made more launches than JAX"
        w_kind, w_active, w_logits, w_tok = want[i]
        assert kind == w_kind and np.array_equal(active, w_active), i
        lt = logits[:, -1].numpy()
        scale = np.abs(w_logits[active]).max()
        err = np.abs(lt[active] - w_logits[active]).max()
        assert err <= TOL * scale, (i, kind, err, scale)
        top2 = np.sort(w_logits, axis=-1)[:, -2:]
        sure = active & (top2[:, 1] - top2[:, 0] > TOL * scale)
        assert np.array_equal(lt.argmax(-1)[sure], w_tok[sure]), i
        seen.append(i)
        return torch.from_numpy(w_tok.copy())

    def decode(p, t, c, pos):
        active = np.array([r is not None for r in eng.slot_req])
        logits, c = tlm.decode_step(p, t, c, pos, cfg, policy=eng.policy)
        return check("decode", active, logits), c

    def prefill(p, t, c, pos, lens):
        logits, c = tlm.prefill_chunk(p, t, c, pos, lens, cfg,
                                      policy=eng.policy)
        return check("prefill", np.asarray(lens) > 0, logits), c

    eng._decode = decode
    if mode == "chunked":
        eng._prefill_fn = prefill
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    done = {r.rid: r.tokens for r in eng.run()}
    assert len(seen) == len(want) and done == want_done
    assert eng.stats["decode_steps"] == sum(k == "decode" for k, *_ in want)
    assert eng.stats["prefill_launches"] == sum(k == "prefill"
                                                for k, *_ in want)


def test_chunked_prefill_matches_sequential(params):
    """The chunked batched prefill path emits the same tokens as
    sequential prefill, with mid-run slot refills (5 requests through 3
    slots)."""
    results = {}
    for mode in ("sequential", "chunked"):
        eng, _ = _port_engine(params, mode)
        for i, p in enumerate(_prompts()):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        results[mode] = {r.rid: r.tokens for r in eng.run()}
        assert all(len(t) == MAX_NEW for t in results[mode].values())
    assert results["chunked"] == results["sequential"]


def test_chunked_prefill_freezes_other_slots(params):
    """A chunked prefill of a newly filled slot leaves the position, next
    token and cache rows of a slot mid-decode untouched."""
    eng, cfg = _port_engine(params, "chunked")
    rng = np.random.default_rng(2)
    eng.submit(Request(rid=0, prompt=rng.integers(0, 512, 6, dtype=np.int32),
                       max_new_tokens=10))
    eng._fill_slots()
    eng._step()
    pos0, tok0 = int(eng.pos[0]), int(eng.cur_tok[0, 0])
    rows0 = {k: t[:, 0].clone() for k, t in eng.cache.items()}
    eng.submit(Request(rid=1, prompt=rng.integers(0, 512, 11, dtype=np.int32),
                       max_new_tokens=10))
    eng._fill_slots()            # chunked prefill of slot 1 only
    assert int(eng.pos[0]) == pos0 and int(eng.cur_tok[0, 0]) == tok0
    assert all(torch.equal(eng.cache[k][:, 0], rows0[k]) for k in rows0)
    assert int(eng.pos[1]) == 11
    done = eng.run()
    assert sorted(len(r.tokens) for r in done) == [10, 10]


def test_sequential_prefill_restores_other_slots(params):
    eng, _ = _port_engine(params, "sequential")
    rng = np.random.default_rng(4)
    eng.submit(Request(rid=0, prompt=rng.integers(0, 512, 4, dtype=np.int32),
                       max_new_tokens=8))
    eng._fill_slots()
    eng._step()
    rows0 = {k: t[:, 0].clone() for k, t in eng.cache.items()}
    eng.submit(Request(rid=1, prompt=rng.integers(0, 512, 7, dtype=np.int32),
                       max_new_tokens=8))
    eng._fill_slots()
    assert all(torch.equal(eng.cache[k][:, 0], rows0[k]) for k in rows0)
    assert eng.stats["prefill_launches"] == 0


def test_idle_slots_past_the_cache_do_not_stop_prefill(params):
    """An idle slot's position keeps advancing with every decode step (as
    in the reference) and passes the cache capacity in a long-running
    engine; a later chunked prefill of another slot must still run, and
    give the tokens sequential prefill gives."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, 2, dtype=np.int32) for _ in range(3)]
    out = {}
    for mode in ("chunked", "sequential"):
        eng = ServeEngine(tbase.reduced_config("qwen2-1.5b"),
                          lm_from_numpy(params, "cpu"), slots=3, max_len=16,
                          prefill=mode, prefill_chunk=8, device="cpu")
        toks = []
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=14))
            toks.append(eng.run()[-1].tokens)
        # slot 2 sat idle through all three; the last prefill saw it at 26
        assert int(eng.pos[2]) > 2 * 16 and eng.slot_req == [None] * 3
        out[mode] = toks
    assert out["chunked"] == out["sequential"]


def test_engine_deadline_expires_in_flight_request(params):
    t = [0.0]
    eng, _ = _port_engine(params, "chunked", clock=lambda: t[0])
    r = Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=50, deadline_s=1.0)
    eng.submit(r)
    eng._fill_slots()
    eng._step()
    t[0] = 2.0
    eng.run()
    assert r.status == "rejected" and r.error["reason"] == "deadline"
    assert eng.slot_req == [None] * 3 and r in eng.rejected


def test_engine_rejects_bad_modes_and_missing_card(params):
    with pytest.raises(ValueError):
        _port_engine(params, "bulk")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            ServeEngine(tbase.reduced_config("qwen2-1.5b"),
                        lm_from_numpy(params, "cpu"), device="cuda")


def test_launcher_serves_lm_on_cpu(capsys):
    eng = tlaunch.main(["--model", "lm", "--device", "cpu", "--reduced",
                        "--requests", "5", "--slots", "2", "--max-new", "4",
                        "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert "served 5 requests, 20 tokens" in out
    assert "chunk_kernel_launches=0 decode_kernel_launches=0" in out
    assert eng.stats["prefill_launches"] > 0 and eng.stats["decode_steps"] > 0
    assert eng.cache["k"].dtype == torch.float32


# ---------------------------------------------------------------------------
# chip_smoke.py's pure LM helpers
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("window", [0, 5])
def test_chip_smoke_attention_work_counts_visible_pairs(window):
    """The pairs the smoke's bound counts are those the plain versions'
    masks let through, row by row; the K/V positions those any row sees."""
    from repro_torch.kernels.flash_attention import ref
    cs = _chip_smoke()
    B, C, T, H, KH, D = 3, 6, 20, 4, 2, 8
    off = np.asarray([0, 4, 9], np.int64)
    lens = np.asarray([6, 3, 0], np.int64)
    kvl = np.where(lens > 0, off + lens, 0)
    pairs, live = cs.attention_work("chunk", (B, C, H, D), (B, T, KH, D),
                                    kvl, off, window)
    qpos = off[:, None] + np.arange(C)[None]
    t = np.arange(T)
    vis = (t[None, None] < kvl[:, None, None]) \
        & (t[None, None] <= qpos[:, :, None])
    if window:
        vis &= t[None, None] > qpos[:, :, None] - window
    assert pairs == int(vis.sum())
    assert live == int(vis.any(axis=1).sum())
    # the plain version's output is exactly 0 where a row sees nothing
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, C, H, D), (B, T, KH, D), (B, T, KH, D)))
    out = ref.flash_chunk_ref(q, k, v, torch.from_numpy(off),
                              torch.from_numpy(kvl), window=window)
    assert np.array_equal(out.abs().sum(dim=(2, 3)).numpy() > 0,
                          vis.any(axis=2))
    pairs, live = cs.attention_work("decode", (3, 1, H, D), (3, T, KH, D),
                                    [0, 7, 99], window=window)
    want = [0, min(7, window or 7), min(T, window or T)]
    assert pairs == live == sum(want)


def test_chip_smoke_attention_bound():
    cs = _chip_smoke()
    kvl = [500] * 8
    ms, by, nbytes, flops = cs.attention_bound(
        "decode", (8, 1, 12, 128), (8, 1024, 2, 128), kvl, "float32")
    assert nbytes == (2 * 8 * 12 * 128 + 2 * 8 * 500 * 2 * 128) * 4
    assert flops == 4 * 128 * 12 * 8 * 500
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    ms, by, nbytes, flops = cs.attention_bound(
        "chunk", (8, 128, 12, 128), (8, 1024, 2, 128), [1024] * 8,
        "float32", q_offset=[896] * 8)
    assert flops == 4 * 128 * 12 * 8 * sum(896 + i + 1 for i in range(128))
    assert by == "operations" and ms == pytest.approx(flops / 67e12 * 1e3)
    ms16, by16, nbytes16, _ = cs.attention_bound(
        "chunk", (8, 128, 12, 128), (8, 1024, 2, 128), [1024] * 8,
        "bfloat16", q_offset=[896] * 8)
    assert nbytes16 * 2 == nbytes and ms16 < ms


def test_chip_smoke_lm_launch_arithmetic():
    cs = _chip_smoke()
    ok = {"prefill_launches": 2, "decode_steps": 3, "flash_chunk": 56,
          "flash_decode": 84}
    assert cs.lm_launches_ok(ok, 28)
    assert not cs.lm_launches_ok(dict(ok, flash_decode=83), 28)
    assert not cs.lm_launches_ok(dict(ok, flash_chunk=28), 28)
    assert not cs.lm_launches_ok(dict(ok, decode_steps=0, flash_decode=0),
                                 28)


def test_chip_smoke_sdpa_yardstick_is_the_same_function():
    """The SDPA call the smoke times beside the kernels computes what the
    plain versions compute, on every row that sees a key."""
    from repro_torch.kernels.flash_attention import ref
    cs = _chip_smoke()
    rng = np.random.default_rng(1)
    B, C, T, H, KH, D = 3, 5, 24, 6, 2, 8
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, C, H, D), (B, T, KH, D), (B, T, KH, D)))
    off = torch.tensor([0, 3, 7], dtype=torch.int32)
    kvl = torch.tensor([5, 8, 0], dtype=torch.int32)
    want = ref.flash_chunk_ref(q, k, v, off, kvl)
    mask = cs.attention_masks("chunk", B, C, T, kvl, off, "cpu")
    got = cs.sdpa_call(*(t.transpose(1, 2) for t in (q, k, v)),
                       mask).transpose(1, 2)
    np.testing.assert_allclose(got[:2].numpy(), want[:2].numpy(), atol=1e-5)
    dl = torch.tensor([1, 24, 9], dtype=torch.int32)
    want = ref.flash_decode_ref(q[:, :1], k, v, dl, block_kv=8, num_splits=2)
    mask = cs.attention_masks("decode", B, 1, T, dl, None, "cpu")
    got = cs.sdpa_call(*(t.transpose(1, 2) for t in (q[:, :1], k, v)),
                       mask).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_chip_smoke_sharpen_scales_only_queries_and_keys(params):
    cs = _chip_smoke()
    p = lm_from_numpy(params, "cpu")
    s = cs.sharpen(p, 3.0)
    for a, b in zip(p["blocks"], s["blocks"]):
        for n in ("wq", "wk"):
            assert torch.equal(b["attn"][n]["w"], 3.0 * a["attn"][n]["w"])
        assert b["attn"]["wv"]["w"] is a["attn"]["wv"]["w"]
        assert b["ffn"] is a["ffn"]
    assert torch.equal(p["blocks"][0]["attn"]["wq"]["w"],
                       lm_from_numpy(params, "cpu")["blocks"][0]["attn"]
                       ["wq"]["w"])
