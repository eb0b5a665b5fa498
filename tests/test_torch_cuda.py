"""The port's CUDA kernel on the card: held against its plain version over
dtypes, activations and geometries (strides, dilation, cropping pads,
Ci=1, Co=1), its launch counter and input checks, and the engine on the
card.  Every test needs a card and skips elsewhere; this file imports no
JAX, so on the machine with the card it runs without the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

TF32 is off for every comparison.  Tolerances: f32 1e-4 (summation
order), bf16/fp16 one rounding of the same f32 sum (1e-2 / 2e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import calo3dgan
from repro_torch.core import gan
from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.kernels.conv3d.ref import conv_core_ref
from repro_torch.serve.simulate import SimRequest, SimulateEngine, event_noise

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
