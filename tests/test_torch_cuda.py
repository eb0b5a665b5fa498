"""The port's CUDA kernels on the card: each held against its plain
version over dtypes, activations and geometries (strides, dilation,
cropping pads, Ci=1, Co=1), their launch counters and input checks, the
ops' gradients, the engine and a training step on the card; the serving
attention kernels (split-KV decode, chunked prefill) over ragged GQA /
MQA / MHA shapes, windows and inactive rows, and the LM and its engine on
the card against the CPU; the training attention kernels (forward, dq,
dk/dv) over S = 1, odd S, D 16-128, G 1-6, windows and rows that see no
key, bit-for-bit repeats and input checks, and a reduced LM training
step on the card against the CPU; the SSD scan's forward and backward
kernels over chunk-multiple, ragged, many-chunk and odd shapes, bit for
bit on a repeat, their input checks, and a reduced Zamba2 training step
on the card against the CPU; the standalone tiled GEMM over shapes that
straddle its tiles and rows that break 16-byte alignment, bit for bit on
a repeat, one launch a call, and no allocation beside its output.  Every
test
needs a card and skips elsewhere; this file imports no JAX, so on the
machine with the card it runs without the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

TF32 is off for every comparison.  Tolerances: the forward kernel f32
1e-4 (summation order), bf16/fp16 one rounding of the same f32 sum
(1e-2 / 2e-3); the dw kernel 1e-4 of the largest |dw| in every dtype
(both sides sum the same rounded inputs in f32, in another order); the
attention kernels f32 1e-5, bf16 1e-2 absolute and relative (one bf16
rounding of the same f32 result); the training attention kernels 1e-5
(f32) and 1e-2 (bf16) of the larger of each output's largest magnitude
and 1; the LM's logits 1e-4 of the largest; the SSD kernels 1e-5
(forward) and 1e-4 (backward, whose dla is a reverse cumsum of terms
that cancel) of the larger of each output's largest magnitude and 1; the
GEMM's f32 output 1e-5 of its largest |output|, a bf16 output one bf16
spacing plus 1e-5 of the largest (``ref.gemm_err``), and bit for bit its
own f32 output rounded to bf16.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import calo3dgan
from repro_torch.core import adversarial, gan
from repro_torch.data.calo import CaloSimulator, CaloSpec
from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.kernels.conv3d import ops
from repro_torch.kernels.conv3d.ref import (conv_core_ref, conv_dw_core_ref,
                                            gemm_err, gemm_ref)
from repro_torch.configs import base as lm_base
from repro_torch.kernels.flash_attention import decode as tdecode
from repro_torch.kernels.flash_attention import flash_attention as tchunk
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.kernels.ssm_scan import ssm_scan as tssm
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.optim import optimizers as opt_lib
from repro_torch.serve.simulate import SimRequest, SimulateEngine, event_noise
from repro_torch.substrate import precision
from repro_torch.train import engine as engine_lib

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}
GEOMS = [
    # x shape, Co, stride, pads, in_dilation
    ((2, 7, 9, 5, 3), 5, 1, ((1, 1),) * 3, 1),
    ((2, 7, 9, 5, 1), 4, 2, ((1, 1), (1, 1), (0, 1)), 1),      # Ci=1
    ((1, 4, 5, 3, 6), 1, 1, ((2, 1),) * 3, 2),                 # Co=1, t-conv
    ((1, 6, 5, 4, 3), 2, 3, ((1, -1), (2, 0), (-1, 1)), 2),    # cropping
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.parametrize("act", ["none", "leaky_relu", "softplus"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("xs,co,stride,pads,dil", GEOMS)
def test_kernel_matches_plain(cuda, xs, co, stride, pads, dil, dtype, act):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(xs, generator=g, device=cuda).to(dtype)
    w = 0.2 * torch.randn((3, 3, 3, xs[-1], co), generator=g, device=cuda)
    b = 0.1 * torch.randn((co,), generator=g, device=cuda)
    before = tconv.LAUNCHES
    got = tconv.conv_core(x, w, b, stride=stride, pads=pads, in_dilation=dil,
                          activation=act)
    assert tconv.LAUNCHES == before + 1
    want = conv_core_ref(x, w, b, stride=stride, pads=pads, in_dilation=dil,
                         activation=act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn((1, 4, 4, 4, 2), device=cuda)
    w = torch.randn((3, 3, 3, 2, 3), device=cuda)
    pads = ((1, 1),) * 3
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv_core(x.transpose(1, 2), w, None, stride=1, pads=pads)
    with pytest.raises(TypeError, match="f32"):
        tconv.conv_core(x.double(), w, None, stride=1, pads=pads)
    with pytest.raises(ValueError, match="shapes"):
        tconv.conv_core(x, w[:, :, :, :1], None, stride=1, pads=pads)


def test_engine_on_card_matches_plain_generator_and_counts_launches(cuda):
    """The card's engine against the plain generator on the CPU fed the
    card's own noise (the card draws it with CUDA generators, whose numbers
    differ from the CPU's), plus launches and packing invariance."""
    cfg = calo3dgan.bench()
    params = gan.init_generator(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = SimulateEngine(cfg, params, buckets=(4, 16), device="cuda")
    reqs = [SimRequest(rid=i, primary_energy=80.0 + i, n_events=n, seed=i)
            for i, n in enumerate((3, 5, 17, 1))]
    for r in reqs:
        eng.submit(r)
    before = tconv.LAUNCHES
    eng.run()
    assert tconv.LAUNCHES - before == \
        len(cfg.gen_channels) * eng.stats["steps"]
    for r in reqs:
        noise = event_noise([r.seed] * r.n_events, range(r.n_events),
                            cfg.latent_dim, cuda, torch.float32).cpu()
        with torch.inference_mode():
            want = gan.generate(params, noise,
                                torch.full((r.n_events,), r.primary_energy),
                                torch.full((r.n_events,), r.theta),
                                cfg).numpy()
        np.testing.assert_allclose(r.images, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    alone = SimulateEngine(cfg, params, buckets=(4, 8),
                           device="cuda").generate_events(80.0 + 2, 17, 2)
    np.testing.assert_array_equal(alone, reqs[2].images)


DW_GEOMS = [
    # x shape, Co, stride, pads, in_dilation (stride 1 sums over input
    # positions, stride > 1 over output positions)
    ((2, 7, 9, 5, 3), 5, 1, ((1, 1),) * 3, 1),
    ((2, 7, 9, 5, 1), 4, 2, ((1, 1), (1, 1), (0, 1)), 1),      # Ci=1
    ((1, 4, 5, 3, 6), 1, 1, ((2, 1),) * 3, 2),                 # Co=1, t-conv
    ((1, 6, 5, 4, 3), 2, 3, ((1, -1), (2, 0), (-1, 1)), 2),    # cropping
    ((2, 5, 6, 4, 3), 3, 1, ((-1, 1), (1, -1), (0, 0)), 2),    # cropping
    ((1, 3, 3, 3, 40), 300, 2, ((1, 1),) * 3, 1),              # wide tiles
]


def _dw_inputs(cuda, xs, co, stride, pads, dil, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=cuda).to(dtype)
    outs = tconv.out_dims(xs[1:4], (3, 3, 3), stride=stride, pads=pads,
                          in_dilation=dil)
    gy = torch.randn((xs[0], *outs, co), generator=g, device=cuda).to(dtype)
    return x, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("xs,co,stride,pads,dil", DW_GEOMS)
def test_dw_kernel_matches_plain(cuda, xs, co, stride, pads, dil, dtype):
    x, gy = _dw_inputs(cuda, xs, co, stride, pads, dil, dtype)
    before = tconv.DW_LAUNCHES
    got = tconv.conv_dw_core(x, gy, (3, 3, 3), stride=stride, pads=pads,
                             in_dilation=dil)
    assert tconv.DW_LAUNCHES == before + 1
    want = conv_dw_core_ref(x, gy, (3, 3, 3), stride=stride, pads=pads,
                            in_dilation=dil)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_dw_kernel_is_deterministic(cuda):
    """Split-K with a fixed second pass: two launches, the same bits."""
    x, gy = _dw_inputs(cuda, (8, 14, 14, 8, 32), 16, 1, ((2, 1),) * 3, 2,
                       torch.bfloat16, seed=3)
    a = tconv.conv_dw_core(x, gy, (3, 3, 3), stride=1, pads=((2, 1),) * 3,
                           in_dilation=2)
    b = tconv.conv_dw_core(x, gy, (3, 3, 3), stride=1, pads=((2, 1),) * 3,
                           in_dilation=2)
    assert torch.equal(a, b)


def test_dw_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn((1, 4, 4, 4, 2), device=cuda)
    gy = torch.randn((1, 4, 4, 4, 3), device=cuda)
    pads = ((1, 1),) * 3
    before = tconv.DW_LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv_dw_core(x.transpose(1, 2), gy, (3, 3, 3), stride=1,
                           pads=pads)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv_dw_core(x, gy.transpose(1, 2), (3, 3, 3), stride=1,
                           pads=pads)
    with pytest.raises(TypeError, match="f32"):
        tconv.conv_dw_core(x.double(), gy, (3, 3, 3), stride=1, pads=pads)
    with pytest.raises(ValueError, match="do not fit"):
        tconv.conv_dw_core(x, gy[:, :3], (3, 3, 3), stride=1, pads=pads)
    assert tconv.DW_LAUNCHES == before


@pytest.mark.parametrize("act", ["none", "leaky_relu", "softplus"])
@pytest.mark.parametrize("transpose", [False, True])
def test_op_gradients_on_card_match_cpu(cuda, transpose, act):
    """dx, dw, db through the autograd ops: kernels on the card, plain
    versions on the CPU, the same inputs (f32)."""
    gen = torch.Generator().manual_seed(1)
    xs, co = ((2, 4, 5, 3, 3), 4) if transpose else ((2, 7, 6, 5, 3), 4)
    x = torch.randn(xs, generator=gen)
    w = 0.2 * torch.randn((3, 3, 3, 3, co), generator=gen)
    b = 0.1 * torch.randn((co,), generator=gen)
    fn = ops.conv3d_transpose_bias_act if transpose else ops.conv3d_bias_act
    grads = {}
    for dev in ("cpu", cuda):
        args = [t.to(dev).requires_grad_(True) for t in (x, w, b)]
        y = fn(*args, 2, act)
        gy = torch.ones_like(y) * torch.linspace(-1, 1, y.numel(),
                                                 device=dev).reshape(y.shape)
        grads[str(dev)] = [t.cpu() for t in torch.autograd.grad(y, args, gy)]
    for a, c in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, c, atol=1e-4 * float(c.abs().max()),
                                   rtol=1e-4)


def test_training_step_on_card_matches_cpu_and_counts_launches(cuda):
    """One f32 step at a small config from the same state and inputs:
    card against the CPU's plain route; SGD, so the params move linearly
    with the gradients.  Then the launches of a step and its
    determinism."""
    cfg = calo3dgan.bench()
    opt = opt_lib.sgd(0.05)
    batch = next(CaloSimulator(CaloSpec(image_shape=cfg.image_shape),
                               seed=0).batches(4))
    rng = np.random.default_rng(0)
    inputs = [(rng.normal(size=(4, cfg.latent_dim)).astype(np.float32),
               rng.uniform(10, 500, 4).astype(np.float32),
               rng.uniform(1.0, 2.1, 4).astype(np.float32))
              for _ in range(1 + cfg.gen_steps_per_disc)]
    out = {}
    for dev in ("cpu", "cuda"):
        state = adversarial.init_state(torch.Generator().manual_seed(0), cfg,
                                       opt, opt, device=dev)
        step = adversarial.make_fused_step(
            cfg, opt, opt, policy=precision.FULL,
            sample_inputs=lambda i, mb: inputs[i])
        f0, d0 = tconv.LAUNCHES, tconv.DW_LAUNCHES
        out[dev] = step(state, batch, None)
        if dev == "cuda":
            assert (tconv.LAUNCHES - f0, tconv.DW_LAUNCHES - d0) == \
                adversarial.conv_launches_per_step(cfg)
            again = step(state, batch, None)
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for k in cm:
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-4 * max(
            abs(float(cm[k])), 1.0), k
    for which in ("g_params", "d_params"):
        for a, c, p0 in zip(precision.tree_leaves(getattr(gs, which)),
                            precision.tree_leaves(getattr(cs, which)),
                            precision.tree_leaves(getattr(
                                adversarial.init_state(
                                    torch.Generator().manual_seed(0), cfg,
                                    opt, opt, device="cpu"), which))):
            upd_card, upd_cpu = a.cpu() - p0, c - p0
            assert float((upd_card - upd_cpu).abs().max()) <= 1e-3 * float(
                upd_cpu.abs().max()) + 1e-7
    for which in ("g_params", "d_params", "g_opt", "d_opt"):
        for a, b in zip(precision.tree_leaves(getattr(gs, which)),
                        precision.tree_leaves(getattr(again[0], which))):
            assert torch.equal(a, b), which


def test_engine_fit_on_card_resumes_bit_for_bit(cuda):
    """Engine.fit on the card (pinned prefetch on a side stream, bf16,
    RMSprop): finite metrics, the step's launch counts, and a fit resumed
    at step 2 replays the uninterrupted one."""
    cfg = calo3dgan.bench()
    opt = opt_lib.rmsprop(1e-3)
    task = engine_lib.gan_task(cfg, opt, opt,
                               policy=precision.get_policy("bf16"))

    def fit(steps, state=None, start=0):
        sim = CaloSimulator(CaloSpec(image_shape=cfg.image_shape), seed=4)
        eng = engine_lib.Engine("cuda")
        return eng.fit(task, sim.batches(cfg.batch_size, skip=start), steps,
                       seed=9, state=state, start_step=start)

    f0, d0 = tconv.LAUNCHES, tconv.DW_LAUNCHES
    full, m = fit(4)
    torch.cuda.synchronize()
    fwd, dw = adversarial.conv_launches_per_step(cfg)
    assert (tconv.LAUNCHES - f0, tconv.DW_LAUNCHES - d0) == (4 * fwd, 4 * dw)
    assert all(np.isfinite(float(v)) for v in m.values())
    half, _ = fit(2)
    resumed, _ = fit(2, state=half, start=2)
    for which in ("g_params", "d_params", "g_opt", "d_opt"):
        for a, b in zip(precision.tree_leaves(getattr(full, which)),
                        precision.tree_leaves(getattr(resumed, which))):
            assert torch.equal(a, b), which


ATTN_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
# training attention kernels vs plain, of the larger of each output's
# largest magnitude and 1 (the scale of the N(0, 1) inputs: a gradient that
# cancels to 0 in exact arithmetic, as dq does at S = 1, holds only a
# rounding residue): f32 sums in another order; bf16 one rounding of the
# same f32 result
TOL_TRAIN = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DECODE_GEOMS = [
    # B, T, H, KH, D, kv_lens, window
    (8, 1024, 12, 2, 128, (1, 64, 65, 500, 1023, 1024, 0, 7), 0),  # qwen2
    (3, 96, 8, 2, 32, (1, 37, 96), 0),
    (2, 64, 4, 1, 16, (5, 64), 0),                                 # MQA
    (1, 200, 4, 4, 64, (123,), 0),                                 # MHA
    (3, 128, 4, 2, 32, (128, 60, 13), 48),                         # window
    (2, 300, 40, 1, 256, (300, 129), 0),                           # G=40
]


def _attn_close(got, want, dtype):
    atol, rtol = ATTN_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), \
        float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KH,D,kv_lens,window", DECODE_GEOMS)
def test_flash_decode_kernel_matches_plain(cuda, B, T, H, KH, D, kv_lens,
                                           window, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, 1, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KH, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, KH, D), generator=g, device=cuda).to(dtype)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    own = tdecode.decode_schedule(T, D)
    for kw in (dict(block_kv=own[0], num_splits=own[1]),
               dict(block_kv=32, num_splits=3),
               dict(block_kv=16, num_splits=1)):
        n0 = tdecode.LAUNCHES
        got = tdecode.flash_decode(q, k, v, kvl, window=window, **kw)
        torch.cuda.synchronize()
        assert tdecode.LAUNCHES == n0 + 1
        want = attn_ref.flash_decode_ref(q, k, v, kvl, window=window, **kw)
        assert got.shape == want.shape and got.dtype == dtype
        _attn_close(got, want, dtype)
        empty = kvl == 0
        assert bool((got[empty] == 0).all())


CHUNK_GEOMS = [
    # B, C, T, H, KH, D, offsets, lens, window
    (8, 128, 1024, 12, 2, 128, (0, 128, 384, 0, 512, 896, 3, 0),
     (128, 128, 100, 0, 64, 128, 1, 0), 0),                       # qwen2
    (4, 24, 96, 6, 2, 32, (0, 10, 40, 7), (24, 24, 13, 0), 0),
    (4, 24, 96, 6, 2, 32, (0, 10, 40, 7), (24, 24, 13, 0), 20),   # window
    (2, 37, 75, 4, 1, 16, (0, 30), (37, 20), 0),                  # MQA, odd
    (2, 9, 40, 64, 1, 64, (5, 0), (9, 3), 0),                     # G = 64
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,T,H,KH,D,offs,lens,window", CHUNK_GEOMS)
def test_flash_chunk_kernel_matches_plain(cuda, B, C, T, H, KH, D, offs,
                                          lens, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, C, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KH, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, KH, D), generator=g, device=cuda).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kvl = torch.where(ln > 0, off + ln, torch.zeros_like(ln))
    n0 = tchunk.LAUNCHES
    got = tchunk.flash_attention_chunk(q, k, v, off, kvl, window=window)
    torch.cuda.synchronize()
    assert tchunk.LAUNCHES == n0 + 1
    want = attn_ref.flash_chunk_ref(q, k, v, off, kvl, window=window)
    assert got.shape == want.shape and got.dtype == dtype
    _attn_close(got, want, dtype)
    assert bool((got[kvl == 0] == 0).all())
    assert bool(torch.isfinite(got.float()).all())


def test_attention_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((2, 1, 4, 16), device=cuda, dtype=torch.float16)
    k = torch.zeros((2, 8, 2, 16), device=cuda, dtype=torch.float16)
    kvl = torch.ones((2,), dtype=torch.int32, device=cuda)
    n0, c0 = tdecode.LAUNCHES, tchunk.LAUNCHES
    with pytest.raises(TypeError):
        tdecode.flash_decode(q, k, k, kvl)
    with pytest.raises(TypeError):
        tchunk.flash_attention_chunk(q, k, k, kvl, kvl)
    with pytest.raises(ValueError):
        tdecode.flash_decode(q.float(), k.float(), k.float(), kvl.cpu())
    with pytest.raises(ValueError):
        tdecode.flash_decode(torch.zeros((1, 1, 512, 512), device=cuda),
                             torch.zeros((1, 4, 1, 512), device=cuda),
                             torch.zeros((1, 4, 1, 512), device=cuda),
                             kvl[:1])
    with pytest.raises(ValueError, match="D in"):
        tchunk.flash_attention_chunk(torch.zeros((1, 4, 2, 80), device=cuda),
                                     torch.zeros((1, 8, 1, 80), device=cuda),
                                     torch.zeros((1, 8, 1, 80), device=cuda),
                                     kvl[:1], kvl[:1])
    assert (tdecode.LAUNCHES, tchunk.LAUNCHES) == (n0, c0)


def test_lm_on_card_matches_cpu_and_counts_launches(cuda):
    """The reduced qwen2-1.5b on the card (kernels) against the CPU (plain
    versions): a ragged prefill chunk and 3 decodes, logits within 1e-4
    of the largest; one launch of each kernel per layer per call."""
    cfg = lm_base.reduced_config("qwen2-1.5b")
    params = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    pol = precision.get_policy("f32")
    B, C, T = 4, 16, 64
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, C)).astype(np.int32)
    pos = np.asarray([0, 5, 20, 9], np.int32)
    lens = np.asarray([16, 11, 0, 3], np.int32)
    dec = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
           for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = precision.tree_map(lambda t: t.to(dev), params)
        cache = tlm.init_cache(cfg, B, T, torch.float32, dev)
        c0, d0 = tchunk.LAUNCHES, tdecode.LAUNCHES
        logits, cache = tlm.prefill_chunk(p, tokens, cache, pos, lens, cfg,
                                          policy=pol)
        got = [logits.cpu()]
        at = pos + lens
        for t in dec:
            logits, cache = tlm.decode_step(p, t, cache, at, cfg, policy=pol)
            got.append(logits.cpu())
            at = at + 1
        outs[dev] = got
        if dev == "cuda":
            assert tchunk.LAUNCHES - c0 == cfg.n_layers
            assert tdecode.LAUNCHES - d0 == 3 * cfg.n_layers
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_lm_engine_on_card_chunked_matches_sequential(cuda):
    cfg = lm_base.reduced_config("qwen2-1.5b")
    params = tlm.init(torch.Generator().manual_seed(1), cfg, "cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 12, 3, 9, 17)]
    out = {}
    for mode in ("sequential", "chunked"):
        eng = ServeEngine(cfg, params, slots=3, max_len=64, prefill=mode,
                          prefill_chunk=8, device="cuda")
        c0, d0 = tchunk.LAUNCHES, tdecode.LAUNCHES
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        out[mode] = {r.rid: r.tokens for r in eng.run()}
        assert tchunk.LAUNCHES - c0 == \
            cfg.n_layers * eng.stats["prefill_launches"]
        assert tdecode.LAUNCHES - d0 == \
            cfg.n_layers * eng.stats["decode_steps"]
    assert out["chunked"] == out["sequential"]


TRAIN_GEOMS = [
    # B, S, T, H, KH, D, causal, window
    (8, 256, 256, 12, 2, 128, True, 0),                            # qwen2
    (2, 1, 1, 6, 1, 64, True, 0),                                  # S = 1
    (2, 77, 77, 6, 1, 64, True, 0),                                # MQA, odd
    (2, 100, 100, 4, 4, 128, True, 0),                             # G = 1
    (1, 130, 130, 12, 2, 64, True, 33),                            # window
    (2, 70, 45, 8, 2, 32, False, 0),                               # T != S
    (1, 40, 10, 2, 1, 16, True, 4),                                # no key
]


def _train_inputs(cuda, B, S, T, H, KH, D, dtype, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, S, H, D), (B, T, KH, D), (B, T, KH, D),
                      (B, S, H, D))]


def _rel_close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(float(want.float().abs().max()), 1.0), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KH,D,causal,window", TRAIN_GEOMS)
def test_flash_train_kernels_match_plain(cuda, B, S, T, H, KH, D, causal,
                                         window, dtype):
    """Forward (O, lse), dq and dk/dv kernels against their plain versions
    on the card (TOL_TRAIN; lse elementwise 1e-5), one launch each, and a
    second run of each bit for bit."""
    q, k, v, do = _train_inputs(cuda, B, S, T, H, KH, D, dtype)
    kw = dict(causal=causal, window=window)
    n0 = (tchunk.FWD_LAUNCHES, tchunk.DQ_LAUNCHES, tchunk.DKV_LAUNCHES)
    o, lse = tchunk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    delta = attn_ref.attention_delta(o, do)
    dq = tchunk.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tchunk.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (tchunk.FWD_LAUNCHES, tchunk.DQ_LAUNCHES,
            tchunk.DKV_LAUNCHES) == tuple(n + 1 for n in n0)
    po, plse = attn_ref.flash_fwd_ref(q, k, v, **kw)
    pdq = attn_ref.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    pdk, pdv = attn_ref.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    tol = TOL_TRAIN[dtype]
    for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)):
        assert got.shape == want.shape and got.dtype == dtype
        _rel_close(got, want, tol)
    assert bool(((lse - plse).abs() <= 1e-5 + 1e-5 * plse.abs()).all())
    empty = ~attn_ref.train_mask(S, T, causal, window, cuda).any(dim=1)
    assert bool((o[:, empty] == 0).all()) and bool((dq[:, empty] == 0).all())
    o2, lse2 = tchunk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    dq2 = tchunk.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = tchunk.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


def test_flash_train_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _train_inputs(cuda, 1, 8, 8, 4, 2, 16, torch.float32)
    lse = torch.zeros((1, 8, 4), device=cuda)
    n0 = (tchunk.FWD_LAUNCHES, tchunk.DQ_LAUNCHES, tchunk.DKV_LAUNCHES)
    with pytest.raises(TypeError):
        tchunk.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="D in"):
        z = torch.zeros((1, 4, 2, 80), device=cuda)
        tchunk.flash_attention_fwd(z, z[:, :, :1], z[:, :, :1])
    with pytest.raises(ValueError, match="H / KH"):
        z = torch.zeros((1, 4, 65, 16), device=cuda)
        tchunk.flash_attention_fwd(z, z[:, :, :1], z[:, :, :1])
    with pytest.raises(ValueError, match="lse"):
        tchunk.flash_bwd_dq(q, k, v, do, lse.bfloat16(), lse)
    with pytest.raises(ValueError, match="delta"):
        tchunk.flash_bwd_dkv(q, k, v, do, lse, lse.cpu())
    assert (tchunk.FWD_LAUNCHES, tchunk.DQ_LAUNCHES,
            tchunk.DKV_LAUNCHES) == n0


def test_lm_train_step_on_card_matches_cpu_and_counts_launches(cuda):
    """One f32 AdamW step of the reduced qwen2-1.5b (remat on) on the card
    (kernels) against the CPU (plain versions) from the same parameters
    and tokens: loss and grad norm within 1e-5 relative, each AdamW
    moment leaf within 1e-4 of its largest, each update element (new
    param minus param) within 1e-3 of its leaf's largest, one f32 spacing
    at the param, and what the two sides' gradients a, b make of it
    through Adam's first step -lr * g / (|g| + eps): at most
    lr * eps |a - b| / (d + eps)^2, d the distance from 0 to [a, b],
    which rounding decides where |g| is near eps; 2L forward (remat) and L
    of each backward kernel launches; a second step from the same state
    bit for bit."""
    from repro_torch.models import api
    from repro_torch.train import steps as steps_lib
    cfg = lm_base.reduced_config("qwen2-1.5b")
    params = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    lr, eps = 1e-3, 1e-8
    opt = opt_lib.adamw(opt_lib.warmup_cosine(lr, 1, 4), eps=eps)
    step = steps_lib.make_train_step(api.get_model(cfg), cfg, opt,
                                     precision.get_policy("f32"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = precision.tree_map(lambda t: t.to(dev), params)
        n0 = (tchunk.FWD_LAUNCHES, tchunk.DQ_LAUNCHES, tchunk.DKV_LAUNCHES)
        out[dev] = step(p, opt.init(p), {"tokens": tokens.to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
            L = cfg.n_layers
            assert (tchunk.FWD_LAUNCHES - n0[0], tchunk.DQ_LAUNCHES - n0[1],
                    tchunk.DKV_LAUNCHES - n0[2]) == (2 * L, L, L)
            again = step(p, opt.init(p), {"tokens": tokens.to(dev)})
    (cp, cs, cm), (gp, gs, gm) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-5 * abs(float(cm[k]))
    for a, b in zip(precision.tree_leaves([gs["m"], gs["v"]]),
                    precision.tree_leaves([cs["m"], cs["v"]])):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    for new_g, new_c, p0, mg, mc in zip(*(precision.tree_leaves(t) for t in
                                          (gp, cp, params, gs["m"],
                                           cs["m"]))):
        a, b = mg.cpu() / 0.1, mc / 0.1   # each side's gradient (b1 = 0.9)
        d = torch.where(a * b > 0, torch.minimum(a.abs(), b.abs()),
                        torch.zeros_like(a))
        allow = (lr * eps * (a - b).abs() / (d + eps) ** 2
                 + 2.0 ** -23 * p0.abs())
        upd_g, upd_c = new_g.cpu() - p0, new_c - p0
        assert bool(((upd_g - upd_c).abs() <= 1e-3 * upd_c.abs().max()
                     + allow).all())
    for a, b in zip(precision.tree_leaves([gp, gs]),
                    precision.tree_leaves([again[0], again[1]])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the SSD scan kernels
# ---------------------------------------------------------------------------

SSD_GEOMS = [
    # Bt, S, H, P, N, chunk
    (8, 256, 64, 64, 64, 128),     # the zamba2-1.2b training shapes
    (2, 200, 4, 64, 64, 128),      # ragged S
    (1, 1024, 3, 64, 64, 128),     # many chunks
    (2, 64, 16, 32, 32, 128),      # reduced zamba: chunk clamped to S
    (1, 37, 3, 8, 4, 16),          # odd S, odd H, small P and N
    (2, 100, 5, 16, 8, 32),        # ragged, P != N
]
TOL_SSD = {"fwd": 1e-5, "bwd": 1e-4}


def _ssd_inputs(cuda, Bt, S, H, P, N, seed=3):
    """N(0, 1) x, B, C and dy; dt = softplus(N(-2, 1)) and A from -1 to -16
    (the model's A_log init): the log-decay reaches hundreds within a
    chunk, so exp(F_t - F_s) above the diagonal would overflow."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x, dy = (torch.randn((Bt, S, H, P), generator=g, device=cuda)
             for _ in range(2))
    B, C = (torch.randn((Bt, S, N), generator=g, device=cuda)
            for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, S, H), generator=g, device=cuda) - 2.0)
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    return x, B, C, dt, A, dy


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", SSD_GEOMS)
def test_ssd_kernels_match_plain(cuda, Bt, S, H, P, N, chunk):
    """Forward (y, final and entry states) and backward (dx, dB, dC, ddt,
    dA) kernels against their plain versions on the card (TOL_SSD), one
    launch each, all finite, and a second run of each bit for bit."""
    x, B, C, dt, A, dy = _ssd_inputs(cuda, Bt, S, H, P, N)
    n0 = (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES)
    fwd = tssm.ssm_scan_fwd(x, B, C, dt, A, chunk=chunk,
                            return_chunk_states=True)
    bwd = tssm.ssm_scan_bwd(x, B, C, dt, A, fwd[2], dy, chunk=chunk)
    torch.cuda.synchronize()
    assert (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES) == (n0[0] + 1, n0[1] + 1)
    pf = ssm_ref.ssd_fwd_ref(x, B, C, dt, A, chunk=chunk)
    pb = ssm_ref.ssd_bwd_ref(x, B, C, dt, A, pf[2], dy, chunk=chunk)
    for kind, got, want in (("fwd", fwd, pf), ("bwd", bwd, pb)):
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == torch.float32
            assert bool(torch.isfinite(a).all())
            _rel_close(a, b, TOL_SSD[kind])
    fwd2 = tssm.ssm_scan_fwd(x, B, C, dt, A, chunk=chunk,
                             return_chunk_states=True)
    bwd2 = tssm.ssm_scan_bwd(x, B, C, dt, A, fwd[2], dy, chunk=chunk)
    for a, b in zip(fwd + bwd, fwd2 + bwd2):
        assert torch.equal(a, b)


def test_ssd_op_gradients_on_card_match_the_sequential_scan(cuda):
    """The autograd Function on the card against torch.autograd through the
    sequential oracle, on a ragged two-chunk shape: y 1e-5, every
    gradient 1e-4 of the larger of its largest and 1."""
    x, B, C, dt, A, dy = _ssd_inputs(cuda, 2, 150, 4, 32, 16, seed=5)
    leaves = [t.detach().requires_grad_() for t in (x, B, C, dt, A)]
    y = ssm_ops.ssm_scan(*leaves, chunk=128)
    got = torch.autograd.grad(y, leaves, dy)
    ref_leaves = [t.detach().requires_grad_() for t in (x, B, C, dt, A)]
    yr = ssm_ref.ssm_scan_seq_ref(*ref_leaves)[0]
    want = torch.autograd.grad(yr, ref_leaves, dy)
    _rel_close(y, yr, 1e-5)
    for a, b in zip(got, want):
        _rel_close(a, b, 1e-4)


def test_ssd_kernels_reject_what_they_do_not_take(cuda):
    x, B, C, dt, A, dy = _ssd_inputs(cuda, 1, 64, 2, 16, 8)
    si = torch.zeros((1, 2, 1, 16, 8), device=cuda)
    n0 = (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="x must be f32"):
        tssm.ssm_scan_fwd(x.bfloat16(), B, C, dt, A, chunk=128)
    with pytest.raises(ValueError, match="A must be f32"):
        tssm.ssm_scan_fwd(x, B, C, dt, A.cpu(), chunk=128)
    with pytest.raises(ValueError, match="chunk <= 128"):
        z = torch.zeros((1, 256, 2, 16), device=cuda)
        tssm.ssm_scan_fwd(z, B.new_zeros((1, 256, 8)),
                          B.new_zeros((1, 256, 8)), dt.new_zeros((1, 256, 2)),
                          A, chunk=256)
    with pytest.raises(ValueError, match="P <= 64"):
        tssm.ssm_scan_fwd(torch.zeros((1, 64, 2, 80), device=cuda), B, C, dt,
                          A, chunk=128)
    with pytest.raises(ValueError, match="chunk_states"):
        tssm.ssm_scan_bwd(x, B, C, dt, A, si[..., :4], dy, chunk=128)
    with pytest.raises(ValueError, match="dy must be f32"):
        tssm.ssm_scan_bwd(x, B, C, dt, A, si, dy.cpu(), chunk=128)
    assert (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES) == n0


def test_zamba_train_step_on_card_matches_cpu_and_counts_launches(cuda):
    """One f32 AdamW step of the reduced zamba2-1.2b (remat on) on the card
    (kernels) against the CPU (plain versions) from the same parameters
    and tokens: loss and grad norm within 1e-5 relative, each AdamW
    moment leaf within 1e-4 of its largest (the unread shared attn/wo
    has zero moments on both sides); 2L SSD forward (remat) and L
    backward launches, 2 and 1 of each attention kernel per shared
    application; a second step from the same state bit for bit."""
    from repro_torch.models import api, zamba
    from repro_torch.train import steps as steps_lib
    cfg = lm_base.reduced_config("zamba2-1.2b")
    params = zamba.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    opt = opt_lib.adamw(opt_lib.warmup_cosine(1e-3, 1, 4))
    step = steps_lib.make_train_step(api.get_model(cfg), cfg, opt,
                                     precision.get_policy("f32"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = precision.tree_map(lambda t: t.to(dev), params)
        n0 = (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES, tchunk.FWD_LAUNCHES,
              tchunk.DQ_LAUNCHES, tchunk.DKV_LAUNCHES)
        out[dev] = step(p, opt.init(p), {"tokens": tokens.to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
            L = cfg.n_layers
            n_shared = len(range(0, L, cfg.shared_attn_every))
            n = (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES, tchunk.FWD_LAUNCHES,
                 tchunk.DQ_LAUNCHES, tchunk.DKV_LAUNCHES)
            assert tuple(a - b for a, b in zip(n, n0)) == (
                2 * L, L, 2 * n_shared, n_shared, n_shared)
            again = step(p, opt.init(p), {"tokens": tokens.to(dev)})
    (cp, cs, cm), (gp, gs, gm) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-5 * abs(float(cm[k]))
    for a, b in zip(precision.tree_leaves([gs["m"], gs["v"]]),
                    precision.tree_leaves([cs["m"], cs["v"]])):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    for a, b in zip(precision.tree_leaves([gp, gs]),
                    precision.tree_leaves([again[0], again[1]])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the standalone GEMM
# ---------------------------------------------------------------------------

def _smoke_gemm_shapes():
    """The chip smoke's gemm shapes that are not full width: the JAX
    tests', the kernel's 128 x 128 tile and K steps (16 f32, 32 bf16) +- 1,
    K = 1, and K, N not multiples of 4 or 8."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.GEMM_CHECK_SHAPES)


GEMM_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16,
                                                torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.float32,
                                                 torch.bfloat16)]


def _gemm_close(got, want):
    err, ok = gemm_err(got, want)
    assert ok, err


@pytest.mark.parametrize("dtype,out_dtype", GEMM_DTYPES)
@pytest.mark.parametrize("M,K,N", _smoke_gemm_shapes())
def test_gemm_kernel_matches_plain(cuda, M, K, N, dtype, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(M + 3 * K + 7 * N)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    w = torch.randn((K, N), generator=g, device=cuda).to(dtype)
    before = tconv.GEMM_LAUNCHES
    got = tconv.gemm(x, w, out_dtype=out_dtype)
    assert tconv.GEMM_LAUNCHES == before + 1
    want = gemm_ref(x, w, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    _gemm_close(got, want)
    if out_dtype == torch.bfloat16:   # one rounding of the same f32 sum
        f32 = tconv.gemm(x, w, out_dtype=torch.float32)
        assert torch.equal(got, f32.to(torch.bfloat16))


def test_gemm_kernel_is_deterministic_and_takes_strided_operands(cuda):
    """A fixed K order: two launches give the same bits; a transposed view
    is made contiguous and gives the bits of its contiguous copy."""
    g = torch.Generator(device=cuda).manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((300, 1000), generator=g, device=cuda).to(dtype)
        w = torch.randn((1000, 260), generator=g, device=cuda).to(dtype)
        a = tconv.gemm(x, w)
        assert torch.equal(a, tconv.gemm(x, w))
        xt = x.t().contiguous().t()
        assert not xt.is_contiguous()
        assert torch.equal(a, tconv.gemm(xt, w))


def test_gemm_allocates_only_its_output(cuda):
    """The port's counterpart of the JAX package's no-op-pad test: with
    contiguous operands the peak device memory of a call grows by the
    output's (allocator-rounded) bytes and nothing more, at a
    tile-multiple and at a ragged shape."""
    for M, K, N in ((128, 128, 128), (100, 70, 50)):
        x = torch.randn((M, K), device=cuda)
        w = torch.randn((K, N), device=cuda)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = tconv.gemm(x, w)
        torch.cuda.synchronize()
        out = -(-y.numel() * y.element_size() // 512) * 512
        assert torch.cuda.memory_allocated() - base == out
        assert torch.cuda.max_memory_allocated() - base == out
        del y


def test_gemm_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn((4, 3), device=cuda)
    before = tconv.GEMM_LAUNCHES
    with pytest.raises(ValueError, match="gemm takes"):
        tconv.gemm(x, torch.randn((4, 5), device=cuda))
    with pytest.raises(TypeError, match="two f32 or two bf16"):
        tconv.gemm(x.half(), torch.randn((3, 5), device=cuda).half())
    with pytest.raises(ValueError, match="w is on"):
        tconv.gemm(x, torch.randn((3, 5)))
    assert tconv.GEMM_LAUNCHES == before
