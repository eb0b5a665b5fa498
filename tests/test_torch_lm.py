"""The port's dense language model against the JAX package on the CPU:
``reduced_config("qwen2-1.5b")`` (2 layers, d 256, 4 heads over 2 KV
heads, vocab 512), parameters from the reference's ``lm.init`` carried
over by ``convert.lm_from_numpy``; one ``prefill_chunk`` with ragged
``lens`` (a 0 among them), then 4 ``decode_step``s at ragged positions.
The reference runs with its Pallas serving kernels in interpret mode
(``use_pallas_attn=True``) and with its pure-JAX route.

Tolerance: logits within 1e-4 of the largest |logit| and the live cache
within 1e-4 of its largest value (f32 both sides; matmul and attention
sums in another order).  Rows with lens = 0 keep their cache bit for bit.
An inactive row's logits are not compared against the pure-JAX route,
whose masked softmax averages the values where the kernels give zeros.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.substrate.precision import get_policy as j_policy
from repro_torch.configs import base as tbase
from repro_torch.configs import calo3dgan as tcalo
from repro_torch.convert import lm_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.substrate.precision import get_policy as t_policy

TOL = 1e-4
B, C, T = 4, 16, 64


@pytest.fixture(scope="module")
def params():
    cfg = jbase.reduced_config("qwen2-1.5b")
    return jax.device_get(jlm.init(jax.random.key(0), cfg))


def _run_jax(params, pallas, tokens, pos, lens, dec_tokens):
    cfg = dataclasses.replace(jbase.reduced_config("qwen2-1.5b"),
                              use_pallas_attn=pallas)
    pol = j_policy("f32")
    cache = jlm.init_cache(cfg, B, T, jnp.float32)
    cache = jax.tree.map(lambda a: a + 0.5, cache)   # not-yet-written rows
    out = []
    logits, cache = jlm.prefill_chunk(params, jnp.asarray(tokens), cache,
                                      jnp.asarray(pos), jnp.asarray(lens),
                                      cfg, policy=pol)
    out.append((np.asarray(logits), jax.device_get(cache)))
    p = pos + lens
    for t in dec_tokens:
        logits, cache = jlm.decode_step(params, jnp.asarray(t), cache,
                                        jnp.asarray(p), cfg, policy=pol)
        out.append((np.asarray(logits), jax.device_get(cache)))
        p = p + 1
    return out


def _run_port(params, tokens, pos, lens, dec_tokens):
    cfg = tbase.reduced_config("qwen2-1.5b")
    pol = t_policy("f32")
    tp = lm_from_numpy(params, "cpu")
    cache = tlm.init_cache(cfg, B, T, torch.float32, "cpu")
    for t in cache.values():
        t += 0.5
    out = []
    logits, cache = tlm.prefill_chunk(tp, tokens, cache, pos, lens, cfg,
                                      policy=pol)
    out.append((logits.numpy(), {k: v.numpy().copy()
                                 for k, v in cache.items()}))
    p = pos + lens
    for t in dec_tokens:
        logits, cache = tlm.decode_step(tp, t, cache, p, cfg, policy=pol)
        out.append((logits.numpy(), {k: v.numpy().copy()
                                     for k, v in cache.items()}))
        p = p + 1
    return out


def _inputs():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (B, C)).astype(np.int32)
    pos = np.asarray([0, 5, 20, 9], np.int32)
    lens = np.asarray([16, 11, 0, 3], np.int32)     # row 2 inactive
    dec = [rng.integers(0, 512, (B, 1)).astype(np.int32) for _ in range(4)]
    return tokens, pos, lens, dec


@pytest.mark.parametrize("pallas", [True, False])
def test_prefill_then_decode_matches_jax(params, pallas):
    tokens, pos, lens, dec = _inputs()
    want = _run_jax(params, pallas, tokens, pos, lens, dec)
    got = _run_port(params, tokens, pos, lens, dec)
    live = lens > 0
    for step, ((lj, cj), (lt, ct)) in enumerate(zip(want, got)):
        assert lt.shape == lj.shape == (B, 1, 512) and lt.dtype == np.float32
        rows = live if step == 0 and not pallas else np.ones(B, bool)
        scale = np.abs(lj[rows]).max()
        err = np.abs(lt[rows] - lj[rows]).max()
        assert err <= TOL * scale, (step, err, scale)
        for name in ("k", "v"):
            cerr = np.abs(ct[name] - cj[name]).max()
            assert cerr <= TOL * np.abs(cj[name]).max(), (step, name, cerr)


def test_prefill_leaves_inactive_rows_and_tails_bit_identical(params):
    """lens = 0 rows keep every cache entry bit for bit, and no row is
    written outside [pos, pos + lens)."""
    tokens, pos, lens, dec = _inputs()
    cfg = tbase.reduced_config("qwen2-1.5b")
    tp = lm_from_numpy(params, "cpu")
    g = torch.Generator().manual_seed(0)
    cache = {n: torch.randn((cfg.n_layers, B, T, cfg.n_kv_heads, cfg.d_head),
                            generator=g) for n in ("k", "v")}
    before = {n: t.clone() for n, t in cache.items()}
    _, after = tlm.prefill_chunk(tp, tokens, cache, pos, lens, cfg,
                                 policy=t_policy("f32"))
    assert after["k"] is cache["k"]           # updated in place
    for n in ("k", "v"):
        for b in range(B):
            written = np.zeros(T, bool)
            written[pos[b]:pos[b] + lens[b]] = True
            same = torch.equal(after[n][:, b, ~written],
                               before[n][:, b, ~written])
            assert same, (n, b)
            assert not torch.equal(after[n][:, b, written],
                                   before[n][:, b, written]) or not lens[b]
    with pytest.raises(ValueError):
        tlm.prefill_chunk(tp, tokens, cache, np.full(B, T - 2, np.int32),
                          lens, cfg, policy=t_policy("f32"))


def test_decode_writes_each_row_at_its_own_position(params):
    cfg = tbase.reduced_config("qwen2-1.5b")
    tp = lm_from_numpy(params, "cpu")
    cache = tlm.init_cache(cfg, B, T, torch.float32, "cpu")
    pos = np.asarray([0, 7, T - 1, 30], np.int32)
    tok = np.asarray([[1], [2], [3], [4]], np.int32)
    logits, cache = tlm.decode_step(tp, tok, cache, pos, cfg,
                                    policy=t_policy("f32"))
    nz = (cache["k"][0].abs().sum(dim=(2, 3)) > 0).nonzero().tolist()
    assert nz == [[b, int(p)] for b, p in enumerate(pos)]
    assert torch.isfinite(logits).all()


def test_bf16_policy_runs_in_bf16(params):
    """The bf16 policy computes in bf16 and keeps a bf16 cache; its logits
    stay near the f32 ones (one bf16 rounding per op; 5e-2 of the
    largest)."""
    tokens, pos, lens, dec = _inputs()
    cfg = tbase.reduced_config("qwen2-1.5b")
    tp = lm_from_numpy(params, "cpu")
    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cache = tlm.init_cache(cfg, B, T, dt, "cpu")
        logits, cache = tlm.prefill_chunk(tp, tokens, cache, pos, lens, cfg,
                                          policy=t_policy(name))
        assert cache["k"].dtype == dt and logits.dtype == torch.float32
        out[name] = logits[lens > 0]
    scale = out["f32"].abs().max()
    assert (out["bf16"] - out["f32"]).abs().max() <= 5e-2 * scale


def test_configs_and_model_api():
    full = tbase.get_config("qwen2-1.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.d_ff, full.vocab) == (28, 1536, 12, 2, 128,
                                                    8960, 151_936)
    assert full.qkv_bias and full.tie_embeddings and full.rope_theta == 1e6
    assert full.q_dim == 1536 and full.kv_dim == 256
    red = tbase.reduced_config("qwen2-1.5b")
    # every field the port defines equals the reference's
    for mine, ref in ((red, jbase.reduced_config("qwen2-1.5b")),
                      (full, jbase.get_config("qwen2-1.5b"))):
        for name, value in dataclasses.asdict(mine).items():
            assert getattr(ref, name) == value, name
    assert tbase.get_config("calo3dgan") == tcalo.config()
    with pytest.raises(NotImplementedError, match="not ported"):
        tbase.get_config("dbrx-132b")
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")
    model = tapi.get_model(full)
    assert model.prefill_chunk is tlm.prefill_chunk
    for family in ("moe", "ssm", "vlm", "audio"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tapi.get_model(dataclasses.replace(red, family=family))
    # the hybrid family (Zamba2) trains through models/zamba.py
    hybrid = tapi.get_model(tbase.reduced_config("zamba2-1.2b"))
    assert hybrid.loss_fn.__module__ == "repro_torch.models.zamba"
    # what the port's dense LM does not run raises instead of being ignored
    for change in (dict(sliding_window=256), dict(ffn_type="gelu"),
                   dict(rope_theta=0.0), dict(tie_embeddings=False)):
        with pytest.raises(NotImplementedError, match="not ported"):
            tapi.get_model(dataclasses.replace(red, **change))
    with pytest.raises(NotImplementedError, match="not ported"):
        tapi.get_model(tcalo.config())


def test_init_and_convert_keep_the_reference_tree(params):
    cfg = tbase.reduced_config("qwen2-1.5b")
    mine = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    conv = lm_from_numpy(params, "cpu")
    assert len(mine["blocks"]) == len(conv["blocks"]) == cfg.n_layers

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(mine) == shapes(conv)
    stacked = jax.tree.map(lambda a: a.shape[1:], params["blocks"])
    assert shapes(conv["blocks"][0]) == stacked
    np.testing.assert_array_equal(conv["blocks"][1]["attn"]["wq"]["w"],
                                  params["blocks"]["attn"]["wq"]["w"][1])
