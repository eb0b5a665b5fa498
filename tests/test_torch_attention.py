"""The port's serving attention against the JAX package on the CPU: the
plain versions of the split-KV decode kernel, of ``combine_splits`` and
of the chunked-prefill kernel against the reference's Pallas kernels in
interpret mode (ragged GQA / MQA / MHA / window cases, several split
schedules, per-row offsets, an inactive row), plus rotary embeddings,
projections, the layers and the ``attend`` router.

Tolerances: f32 1e-5 absolute (both sides do the same f32 score and
softmax math; only the order of the sums differs); bf16 1e-2 absolute and
relative (both round the same f32 result to bf16 once, and two f32 values
a few ulp apart can round to neighbouring bf16 values, 2^-8 relative
apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode as jdecode
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_chunk as j_chunk)
from repro.substrate import attention as jattn
from repro.substrate import layers as jlayers
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import decode as tdecode
from repro_torch.kernels.flash_attention import flash_attention as tchunk
from repro_torch.kernels.flash_attention import ref
from repro_torch.substrate import attention as tattn
from repro_torch.substrate import layers as tlayers

F32_TOL = 1e-5
BF16_TOL = 1e-2

# the ragged cases of tests/test_kernel_flash_decode.py
DECODE_CASES = [
    # B, T, H, KH, D, kv_lens
    (3, 96, 8, 2, 32, (1, 37, 96)),      # GQA, ragged
    (2, 64, 4, 1, 16, (5, 64)),          # MQA
    (1, 200, 4, 4, 64, (123,)),          # MHA, non-block T
    (4, 128, 6, 3, 32, (128, 1, 64, 7)),  # 3-way GQA, full spread
]


def _randn(rng, shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _decode_case(seed, B, T, H, KH, D):
    rng = np.random.default_rng(seed)
    return (_randn(rng, (B, 1, H, D)), _randn(rng, (B, T, KH, D)),
            _randn(rng, (B, T, KH, D)))


def _close(a, b, dtype):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)
    else:
        np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL)


_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(_JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrays]
    return j, t


@pytest.mark.parametrize("block_kv,num_splits,dtype", [
    (32, 2, "f32"), (16, 4, "f32"), (64, 1, "f32"), (32, 2, "bf16")])
@pytest.mark.parametrize("B,T,H,KH,D,kv_lens", DECODE_CASES)
def test_plain_decode_matches_jax_kernel(B, T, H, KH, D, kv_lens, block_kv,
                                         num_splits, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_decode_case(0, B, T, H, KH, D), dtype)
    kvl = np.asarray(kv_lens, np.int32)
    want = jdecode.flash_decode(jq, jk, jv, jnp.asarray(kvl),
                                block_kv=block_kv, num_splits=num_splits,
                                interpret=True)
    got = tdecode.flash_decode(tq, tk, tv, torch.from_numpy(kvl),
                               block_kv=block_kv, num_splits=num_splits)
    assert got.shape == want.shape and got.dtype == _TDT[dtype]
    _close(got.float(), jnp.asarray(want, jnp.float32), dtype)


def test_plain_decode_window_matches_jax_kernel():
    B, T, H, KH, D, w = 3, 128, 4, 2, 32, 48
    (jq, jk, jv), (tq, tk, tv) = _both(_decode_case(1, B, T, H, KH, D), "f32")
    kvl = np.asarray([128, 60, 13], np.int32)
    want = jdecode.flash_decode(jq, jk, jv, jnp.asarray(kvl), window=w,
                                block_kv=32, num_splits=2, interpret=True)
    got = tdecode.flash_decode(tq, tk, tv, torch.from_numpy(kvl), window=w,
                               block_kv=32, num_splits=2)
    _close(got, want, "f32")


def test_plain_decode_default_schedule_is_numerics_free():
    """The port's own schedule (decode_schedule of T and D) against the
    reference kernel at another split count."""
    jq, jk, jv = _decode_case(2, 2, 256, 8, 2, 64)
    kvl = np.asarray([256, 77], np.int32)
    want = jdecode.flash_decode(jnp.asarray(jq), jnp.asarray(jk),
                                jnp.asarray(jv), jnp.asarray(kvl),
                                block_kv=128, num_splits=1, interpret=True)
    got = tdecode.flash_decode(torch.from_numpy(jq), torch.from_numpy(jk),
                               torch.from_numpy(jv), torch.from_numpy(kvl))
    assert tdecode.decode_schedule(256, 64) == (64, 4)
    _close(got, want, "f32")


def test_decode_schedule_depends_on_capacity_and_head_only():
    assert tdecode.decode_schedule(1024, 128) == (64, 16)
    assert tdecode.decode_schedule(4096, 128) == (64, 16)
    assert tdecode.decode_schedule(100, 128) == (64, 2)
    assert tdecode.decode_schedule(1024, 256) == (32, 16)
    assert ref.split_geometry(1024, 64, 16) == (64, 16)
    assert ref.split_geometry(4096, 64, 16) == (256, 16)
    assert ref.split_geometry(200, 32, 2) == (128, 2)


def test_plain_partials_and_combine_match_jax():
    """The per-split (acc, m, l) of the plain version against the JAX
    kernel's own partials (its pallas_call, interpret mode, taken apart
    with the combine replaced by an identity capture), and the plain
    combine against the JAX combine on the same partials, an empty split
    included."""
    B, T, H, KH, D = 2, 96, 4, 2, 16
    q, k, v = _decode_case(3, B, T, H, KH, D)
    kvl = np.asarray([90, 20], np.int32)      # row 1: splits 2 and 3 empty
    captured = {}
    orig = jdecode.combine_splits

    def capture(acc, m, l):
        captured.update(acc=np.asarray(acc), m=np.asarray(m),
                        l=np.asarray(l))
        return orig(acc, m, l)

    jdecode.combine_splits = capture
    try:
        jdecode.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(kvl), block_kv=16, num_splits=4,
                             interpret=True)
    finally:
        jdecode.combine_splits = orig
    acc, m, l = ref.decode_partials_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kvl), block_kv=16, num_splits=4)
    assert acc.shape == captured["acc"].shape
    np.testing.assert_allclose(acc.numpy(), captured["acc"], atol=F32_TOL)
    np.testing.assert_allclose(l.numpy(), captured["l"], atol=F32_TOL)
    live = captured["l"] > 0
    np.testing.assert_allclose(m.numpy()[live], captured["m"][live],
                               atol=F32_TOL)
    assert np.all(m.numpy()[~live] == ref.NEG_INF) and (~live).any()
    want = orig(*(jnp.asarray(captured[n]) for n in ("acc", "m", "l")))
    got = ref.combine_splits_ref(*(torch.from_numpy(captured[n])
                                   for n in ("acc", "m", "l")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def _chunk_case(seed, B, C, T, H, KH, D):
    rng = np.random.default_rng(seed)
    return (_randn(rng, (B, C, H, D)), _randn(rng, (B, T, KH, D)),
            _randn(rng, (B, T, KH, D)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 20])
def test_plain_chunk_matches_jax_kernel(window, dtype):
    """Per-row offsets, a short row, an inactive row (kv_len 0, exact
    zeros), a chunk past the first block, and a window."""
    B, C, T, H, KH, D = 4, 24, 96, 6, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_chunk_case(4, B, C, T, H, KH, D),
                                       dtype)
    off = np.asarray([0, 10, 40, 7], np.int32)
    lens = np.asarray([24, 24, 13, 0], np.int32)
    kvl = np.where(lens > 0, off + lens, 0).astype(np.int32)
    want = j_chunk(jq, jk, jv, jnp.asarray(off), jnp.asarray(kvl),
                   window=window, block_q=16, block_kv=32, interpret=True)
    got = tchunk.flash_attention_chunk(tq, tk, tv, torch.from_numpy(off),
                                       torch.from_numpy(kvl), window=window)
    assert got.shape == want.shape and got.dtype == _TDT[dtype]
    _close(got.float(), jnp.asarray(want, jnp.float32), dtype)
    assert torch.all(got[3] == 0) and torch.isfinite(got.float()).all()


def test_plain_chunk_live_rows_match_dot_attention():
    """The plain chunk against the reference's plain dot_attention on the
    rows of each slot's live prompt."""
    B, C, T, H, KH, D = 3, 16, 64, 4, 2, 16
    q, k, v = _chunk_case(5, B, C, T, H, KH, D)
    off = np.asarray([0, 9, 30], np.int32)
    lens = np.asarray([16, 16, 5], np.int32)
    kvl = off + lens
    qpos = off[:, None] + np.arange(C)[None]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tchunk.flash_attention_chunk(tq, tk, tv, torch.from_numpy(off),
                                       torch.from_numpy(kvl))
    jdot = np.asarray(jattn.dot_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_len=jnp.asarray(kvl), q_positions=jnp.asarray(qpos)))
    for b in range(B):
        n = int(lens[b])
        np.testing.assert_allclose(got[b, :n].numpy(), jdot[b, :n],
                                   atol=F32_TOL)


def test_attend_routes_serving_calls():
    """A single query without q_offset is decode; with q_offset it is the
    chunk; without kv_len (training) it is the causal flash attention of
    the reference's Pallas route."""
    q, k, v = (torch.from_numpy(a) for a in _decode_case(6, 2, 64, 4, 2, 16))
    kvl = torch.tensor([30, 64], dtype=torch.int32)
    out = tattn.attend(q, k, v, kv_len=kvl)
    want = tdecode.flash_decode(q, k, v, kvl)
    assert torch.equal(out, want)
    off = kvl - 1
    out_c = tattn.attend(q, k, v, kv_len=kvl, q_offset=off)
    np.testing.assert_allclose(out_c.numpy(), want.numpy(), atol=F32_TOL)
    jout = jattn.attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        causal=False, kv_len=jnp.asarray(kvl.numpy()),
                        use_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_TOL)
    out_t = tattn.attend(q, k, v)
    jout_t = jattn.attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          use_pallas=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(jout_t),
                               atol=F32_TOL)


def test_wrappers_check_their_inputs():
    q, k, v = (torch.from_numpy(a) for a in _decode_case(7, 2, 32, 4, 2, 16))
    kvl = torch.tensor([3, 32], dtype=torch.int32)
    with pytest.raises(ValueError):
        tdecode.flash_decode(q, k[:, :, :1].expand(2, 32, 3, 16), v, kvl)
    with pytest.raises(ValueError):
        tdecode.flash_decode(q, k.double(), v, kvl)
    with pytest.raises(ValueError):
        tdecode.flash_decode(q, k, v, kvl[:1])
    with pytest.raises(ValueError):
        tdecode.flash_decode(torch.cat([q, q], 1), k, v, kvl)
    with pytest.raises(ValueError):
        tchunk.flash_attention_chunk(q, k, v, kvl.float(), kvl)
    with pytest.raises(ValueError):
        tdecode.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                             kvl.to("meta"))
    assert tdecode.LAUNCHES == 0 and tchunk.LAUNCHES == 0


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_and_projections_match_jax(theta):
    rng = np.random.default_rng(8)
    B, S, H, D = 2, 5, 4, 32
    pos = rng.integers(0, 1000, (B, S)).astype(np.int32)
    jc, js = jattn.rope_cos_sin(jnp.asarray(pos), D, theta)
    tc, ts = tattn.rope_cos_sin(torch.from_numpy(pos), D, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    x = _randn(rng, (B, S, H, D))
    np.testing.assert_allclose(
        tattn.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)

    cfg = tbase.reduced_config("qwen2-1.5b")
    p = jax.device_get(jattn.init_attn(jax.random.key(1), cfg))
    p = jax.tree.map(lambda a: a + 0.01 * _randn(rng, a.shape), p)
    h = _randn(rng, (B, S, cfg.d_model))
    want = jattn.project_qkv(p, jnp.asarray(h), cfg)
    tp = {n: {k: torch.from_numpy(np.asarray(a)) for k, a in leaf.items()}
          for n, leaf in p.items()}
    got = tattn.project_qkv(tp, torch.from_numpy(h), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert set(tattn.init_attn(torch.Generator().manual_seed(0), cfg,
                               "cpu")["wq"]) == {"w", "b"}


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_layers_match_jax(norm_type):
    rng = np.random.default_rng(9)
    x = _randn(rng, (3, 4, 64))
    p = {"scale": 1 + 0.1 * _randn(rng, (64,))}
    if norm_type == "layernorm":
        p["bias"] = 0.1 * _randn(rng, (64,))
    want = jlayers.apply_norm({k: jnp.asarray(a) for k, a in p.items()},
                              jnp.asarray(x), norm_type)
    got = tlayers.apply_norm({k: torch.from_numpy(a) for k, a in p.items()},
                             torch.from_numpy(x), norm_type=norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert set(tlayers.init_norm(64, "cpu", norm_type)) == set(p)
    fp = {n: 0.1 * _randn(rng, (64, 96) if n != "w_out" else (96, 64))
          for n in ("w_gate", "w_in", "w_out")}
    want = jlayers.apply_ffn({k: jnp.asarray(a) for k, a in fp.items()},
                             jnp.asarray(x), "swiglu")
    got = tlayers.apply_ffn({k: torch.from_numpy(a) for k, a in fp.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert set(tlayers.init_ffn(torch.Generator().manual_seed(0), 64, 96,
                                "cpu")) == set(fp)
    emb = _randn(rng, (50, 8))
    tok = rng.integers(0, 50, (2, 3))
    np.testing.assert_array_equal(
        tlayers.apply_embed({"emb": torch.from_numpy(emb)},
                            torch.from_numpy(tok)).numpy(),
        np.asarray(jlayers.apply_embed({"emb": jnp.asarray(emb)},
                                       jnp.asarray(tok))))
