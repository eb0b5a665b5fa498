"""The port's CUDA kernels on the card: each held against its plain
version over dtypes, activations and geometries (strides, dilation,
cropping pads, Ci=1, Co=1), their launch counters and input checks, the
ops' gradients, the engine and a training step on the card.  Every test
needs a card and skips elsewhere; this file imports no JAX, so on the
machine with the card it runs without the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

TF32 is off for every comparison.  Tolerances: the forward kernel f32
1e-4 (summation order), bf16/fp16 one rounding of the same f32 sum
(1e-2 / 2e-3); the dw kernel 1e-4 of the largest |dw| in every dtype
(both sides sum the same rounded inputs in f32, in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import calo3dgan
from repro_torch.core import adversarial, gan
from repro_torch.data.calo import CaloSimulator, CaloSpec
from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.kernels.conv3d import ops
from repro_torch.kernels.conv3d.ref import conv_core_ref, conv_dw_core_ref
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
