"""The port's conv3d entry points (their plain path on the CPU) against the
JAX package's fused Pallas kernels run in interpret mode, plus the padding
geometry, the launch counter and the once-differentiable guard.

Inputs come from a numpy seed and go through both packages.  Tolerances:
f32 1e-5 (summation order only); bf16 2e-2 (the two packages round at
different places: the JAX interpret path feeds f32 weights, the port
rounds weights and bias to bf16 as the TPU does)."""
import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv3d import (conv3d_bias_act as j_conv_bias_act,
                                  conv3d_transpose_bias_act as j_tconv_bias_act)
from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.kernels.conv3d import ops, ref

# the JAX package exports a function named like its conv3d module
jconv = importlib.import_module("repro.kernels.conv3d.conv3d")

TOL = {"f32": 1e-5, "bf16": 2e-2}

CASES = [
    # transpose, (N, D, H, W, Ci), Co, stride, activation
    (False, (1, 8, 8, 8, 4), 8, 1, "none"),
    (False, (2, 7, 9, 5, 3), 5, 2, "leaky_relu"),   # odd dims
    (False, (1, 5, 5, 5, 1), 4, 2, "none"),         # Ci=1 (disc input)
    (False, (2, 6, 5, 7, 8), 1, 1, "softplus"),     # Co=1 (gen output)
    (True, (1, 4, 4, 4, 4), 8, 2, "none"),
    (True, (2, 3, 5, 3, 2), 3, 2, "leaky_relu"),    # odd dims
    (True, (1, 5, 4, 5, 3), 1, 2, "softplus"),      # Co=1
]


def _inputs(seed, xs, co):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=xs).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, 3, xs[-1], co))).astype(np.float32)
    b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("transpose,xs,co,stride,act", CASES)
def test_conv_matches_jax_pallas_interpret(transpose, xs, co, stride, act,
                                           dtype):
    x, w, b = _inputs(len(CASES) + stride + co, xs, co)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jfn = j_tconv_bias_act if transpose else j_conv_bias_act
    tfn = ops.conv3d_transpose_bias_act if transpose else ops.conv3d_bias_act
    want = np.asarray(jfn(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
                          stride, act, 0.2, True).astype(jnp.float32))
    got = tfn(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
              torch.from_numpy(b), stride, act)
    assert got.dtype == tdt
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_entry_refs_match_conv_core_plain_path():
    """The ref module's entry points are the same function as the wrapper's
    CPU path (they share conv_core_ref, through the same geometry)."""
    x, w, b = _inputs(3, (2, 5, 4, 6, 3), 4)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    for transpose in (False, True):
        rfn = (ref.conv3d_transpose_bias_act_ref if transpose
               else ref.conv3d_bias_act_ref)
        ofn = (ops.conv3d_transpose_bias_act if transpose
               else ops.conv3d_bias_act)
        assert torch.equal(rfn(xt, wt, bt, 2, "leaky_relu"),
                           ofn(xt, wt, bt, 2, "leaky_relu"))


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_pad_helpers_match_jax(stride):
    for k in range(1, 6):
        assert tconv.transpose_pads(k, stride) == jconv._transpose_pads(
            k, stride)
        for size in range(1, 20):
            assert tconv.same_pads(size, k, stride) == jconv._same_pads(
                size, k, stride)


@pytest.mark.parametrize("dil", [1, 2, 3])
def test_out_dims_match_jax_prepare_input(dil):
    """The output-size rule over dilated, padded (or cropped) inputs."""
    for pads in (((0, 0),) * 3, ((2, 1), (1, 1), (0, 2)),
                 ((-1, 2), (1, -1), (2, -2)), ((2, 0), (0, 2), (1, 1))):
        for spatial in ((4, 5, 6), (7, 3, 5)):
            for stride in (1, 2):
                x = jnp.zeros((1, *spatial, 1))
                _, want = jconv._prepare_input(x, (3, 3, 3), stride=stride,
                                               pads=pads, in_dilation=dil)
                assert tconv.out_dims(spatial, (3, 3, 3), stride=stride,
                                      pads=pads, in_dilation=dil) == want


def test_negative_pads_and_dilation_match_jax_conv_core():
    """conv_core's general geometry (the dx routes of the training slice):
    dilation with cropping pads against the JAX `_conv_core` in interpret
    mode."""
    x, w, b = _inputs(11, (1, 5, 6, 4, 3), 2)
    pads = ((1, -1), (2, 0), (-1, 1))
    want = np.asarray(jconv._conv_core(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2, pads=pads,
        in_dilation=2, activation="softplus", interpret=True))
    got = tconv.conv_core(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), stride=2, pads=pads,
                          in_dilation=2, activation="softplus")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    before = tconv.LAUNCHES
    x, w, b = _inputs(5, (1, 4, 4, 4, 2), 3)
    ops.conv3d_transpose_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), 2, "none")
    ops.conv3d_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), 1, "softplus")
    assert tconv.LAUNCHES == before == 0


@pytest.mark.parametrize("which", ["x", "w", "b"])
def test_requires_grad_raises(which):
    """The ops have a backward now (test_torch_train.py); that backward is
    kernels with no backward of their own, so asking for a second
    derivative through it raises instead of returning a wrong one."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(6, (1, 3, 3, 3, 2), 2))
    t = {"x": x, "w": w, "b": b}[which].requires_grad_(True)
    for fn, stride in ((ops.conv3d_bias_act, 1),
                       (ops.conv3d_transpose_bias_act, 2)):
        y = fn(x, w, b, stride, "softplus")
        (g,) = torch.autograd.grad(y.square().sum(), t, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            g.sum().backward()


def test_unknown_activation_and_device_raise():
    x, w, b = (torch.from_numpy(a) for a in _inputs(7, (1, 3, 3, 3, 2), 2))
    with pytest.raises(ValueError, match="activation"):
        tconv.conv_core(x, w, b, stride=1, pads=((1, 1),) * 3,
                        activation="gelu")
    with pytest.raises(ValueError, match="cuda"):
        tconv.conv_core(x.to("meta"), w, b, stride=1, pads=((1, 1),) * 3)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("transpose,xs,co,stride,act", [
    (False, (1, 8, 8, 8, 4), 8, 1, "none"),
    (False, (2, 6, 5, 7, 8), 1, 1, "softplus"),
    (False, (1, 7, 9, 5, 1), 4, 2, "none"),          # symmetric SAME pads
    (False, (2, 6, 4, 7, 3), 2, 2, "leaky_relu"),    # asymmetric SAME pads
    (True, (1, 4, 4, 4, 4), 8, 2, "none"),
    (True, (2, 3, 5, 3, 2), 3, 2, "leaky_relu"),
])
def test_chip_smoke_library_yardstick_is_the_same_function(
        transpose, xs, co, stride, act):
    """The cuDNN call chip_smoke.py times beside the kernel (flipped-kernel
    conv_transpose3d, cropped) computes the kernel's function: checked here
    on the CPU against the plain version."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(9, xs, co))
    cs = _chip_smoke()
    got = cs.library_conv(x, w, b, stride=stride, transpose=transpose,
                          activation=act)
    fn = (ref.conv3d_transpose_bias_act_ref if transpose
          else ref.conv3d_bias_act_ref)
    want = fn(x, w, b, stride, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_chip_smoke_counts_useful_macs():
    """The bound's operation count skips dilation zeros and padding: a
    1x1x1 conv does one multiply-add per output and input channel, a
    stride-2 transposed 3-tap conv 3/2 taps per output per dim."""
    cs = _chip_smoke()
    assert cs.useful_macs((2, 4, 4, 4, 3), (1, 1, 1, 3, 5), 1,
                          False) == 2 * 64 * 3 * 5
    lo = tconv.transpose_pads(3, 2)[0]
    per_dim = sum(1 for o in range(12) for j in range(3)
                  if 0 <= o + j - lo < 11 and (o + j - lo) % 2 == 0)
    # each input element feeds 3 outputs, except the last: the SAME rule
    # keeps 2 * 6 outputs of the 2 * 6 + 1 a full transposed conv has
    assert per_dim == 6 * 3 - 1
    assert cs.useful_macs((1, 6, 6, 6, 1), (3, 3, 3, 1, 1), 2,
                          True) == per_dim ** 3
    # stride-2 SAME conv over 7 (pads 1, 1): outputs 0..3 read 2o-1..2o+1,
    # of which 2 + 3 + 3 + 2 fall inside 0..6
    assert cs.useful_macs((1, 7, 1, 1, 1), (3, 1, 1, 1, 1), 2,
                          False) == 10


def test_chip_smoke_kernel_bound_is_the_sum_of_launch_bounds():
    """The kernels line's bound for a generator pass is the sum of its
    launches' own bounds, each the larger of operations and bytes; the
    bf16, discriminator and gradient rows stay out of it."""
    cs = _chip_smoke()
    b_ops, by_ops = cs.layer_bound(67e9, 1e6, "float32")      # 2 ms vs 0.3 us
    b_bytes, by_bytes = cs.layer_bound(1, 3.35e9, "float32")  # 1 ms of bytes
    assert (by_ops, by_bytes) == ("operations", "bytes")
    np.testing.assert_allclose([b_ops, b_bytes], [2.0, 1.0], rtol=1e-12)

    def row(layer, dtype, bound_ms, bound_by, ms=1.0, kind="fwd"):
        return {"layer": layer, "kind": kind, "dtype": dtype,
                "bound_ms": bound_ms,
                "bound_by": bound_by, "ms": ms, "plain_ms": 2 * ms,
                "library_ms": 3 * ms, "max_abs_err": ms / 10}

    rows = [row("gen_up0", "float32", 2.0, "operations"),
            row("gen_out", "float32", 1.5, "bytes"),
            row("gen_up1", "float32", 0.5, "operations", ms=4.0),
            row("gen_up0", "bfloat16", 9.0, "bytes", ms=9.0),
            row("disc_conv0", "float32", 9.0, "bytes", ms=9.0),
            row("gen_up0", "float32", 9.0, "bytes", ms=9.0, kind="dw")]
    e = cs.kernel_entry(rows, launches=12)
    assert e["bound_ms"] == 4.0 and e["bound_by"] == "operations"
    assert (e["ms"], e["plain_ms"], e["library_ms"]) == (6.0, 12.0, 18.0)
    assert e["max_abs_err"] == 0.4 and e["launches"] == 12


def test_chip_smoke_nearest_rank():
    cs = _chip_smoke()
    vals = list(range(200, 0, -1))
    assert cs.nearest_rank(vals, 0.5) == 100
    assert cs.nearest_rank(vals, 0.99) == 198
    assert cs.nearest_rank(vals, 1.0) == 200
    assert cs.request_sizes(10, seed=0)[:7] == list(cs.CHECK_SIZES)
    assert all(1 <= s <= 96 for s in cs.request_sizes(50, 1, False))


@pytest.mark.parametrize("transpose,xs,co,stride", [
    (False, (2, 7, 6, 5, 3), 4, 2),        # asymmetric SAME pads (6 -> 3)
    (False, (1, 5, 5, 5, 1), 3, 2),        # Ci=1
    (False, (2, 6, 5, 7, 8), 1, 1),        # Co=1
    (True, (1, 4, 3, 4, 4), 5, 2),
    (True, (2, 3, 5, 3, 2), 3, 2),
])
def test_chip_smoke_gradient_yardsticks_are_the_same_functions(
        transpose, xs, co, stride):
    """The library calls chip_smoke.py times beside the dx and dw kernels
    (``torch.nn.grad.conv3d_input`` / ``conv3d_weight``, or ``F.conv3d``
    for the transposed conv's dx) compute the plain dx and dw."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs(13, xs, co))
    cs = _chip_smoke()
    fwd = (ref.conv3d_transpose_bias_act_ref if transpose
           else ref.conv3d_bias_act_ref)
    g = torch.randn(fwd(x, w, None, stride).shape)
    if transpose:
        want_dx = ref.conv3d_transpose_dx(g, w, stride)
        want_dw = ref.conv3d_transpose_dw(x, g, w.shape[:3], stride)
    else:
        want_dx = ref.conv3d_dx(g, w, stride, xs[1:4])
        want_dw = ref.conv3d_dw(x, g, w.shape[:3], stride)
    got_dx = cs.library_dx(xs, w, g, stride=stride, transpose=transpose)
    inp, gout = cs.library_dw_operands(x, g, stride=stride,
                                       transpose=transpose)
    got_dw = cs.library_dw(inp, gout, tuple(w.shape), stride=stride,
                           transpose=transpose)
    np.testing.assert_allclose(got_dx.numpy(), want_dx.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_dw.numpy(), want_dw.numpy(), atol=1e-4,
                               rtol=1e-5)


def test_chip_smoke_step_launches_and_per_step_sums():
    """The per-layer launch counts of a training step name the smoke's
    eight layers and add up to the step's 50 forward-kernel and 16 dw
    launches, and the per-step sums weight each layer's times by them."""
    from repro_torch.configs import calo3dgan
    from repro_torch.core.adversarial import (conv_launches_by_layer,
                                              conv_launches_per_step)
    cs = _chip_smoke()
    cfg = calo3dgan.config()
    counts = conv_launches_by_layer(cfg)
    assert {layer for layer, _ in counts} == {
        g[0] for g in cs.layer_geometries(cfg)}
    assert conv_launches_per_step(cfg) == (50, 16)
    assert conv_launches_per_step(cfg, 2) == (100, 32)
    assert len(cs.layer_geometries(cfg)) == 8
    rows = [{"layer": "gen_up0", "kind": "dw", "dtype": "bfloat16",
             "ms": 1.0, "plain_ms": 2.0, "library_ms": 3.0, "bound_ms": 0.5,
             "bound_by": "bytes"},
            {"layer": "disc_conv0", "kind": "dx", "dtype": "bfloat16",
             "ms": 10.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bound_ms": 0.1, "bound_by": "operations"},
            {"layer": "disc_conv1", "kind": "dw", "dtype": "float32",
             "ms": 100.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bound_ms": 9.0, "bound_by": "operations"}]
    tot = cs.per_step(rows, counts, ("dw",))
    assert (tot["ms"], tot["plain_ms"], tot["library_ms"], tot["launches"]) \
        == (2.0, 4.0, 6.0, 2)
    assert tot["bound_by"] == "bytes"
    tot = cs.per_step(rows, counts, ("fwd", "dx"))
    assert tot["ms"] == 20.0 and tot["bound_by"] == "operations"


def test_chip_smoke_kink_leaves():
    """A LeakyReLU that took another branch moves the layers upstream of
    it in that phase's backward: none for D on fake's generator calls (no
    gradient), every G layer for a frozen D's call in a G phase."""
    from repro_torch.configs import calo3dgan
    cs = _chip_smoke()
    cfg = calo3dgan.config()
    assert cs.kink_leaves(cfg, 0, [2]) == {"conv0", "conv1", "conv2"}
    assert cs.kink_leaves(cfg, 1, [0, 3]) == set()
    assert cs.kink_leaves(cfg, 1, [4]) == {"conv0"}
    assert cs.kink_leaves(cfg, 2, [0]) == {"fc"}
    assert cs.kink_leaves(cfg, 3, [3]) == {"fc", "up0", "up1", "up2"}
    assert cs.kink_leaves(cfg, 2, [7]) == {"fc", "up0", "up1", "up2", "out"}
    assert cs.kink_leaves(cfg, 3, []) == set()


def test_chip_smoke_inf_batch():
    cs = _chip_smoke()
    img = np.ones((2, 51, 51, 25, 1), np.float32)
    bad = cs.inf_batch({"image": img, "ecal": np.zeros(2, np.float32)})
    assert np.isinf(bad["image"]).sum() == 1 and np.isfinite(img).all()
    assert np.isinf(bad["image"][0, 25, 25, 12, 0])
    assert np.isinf(bad["ecal"][0]) and bad["ecal"][1] == 51 * 51 * 25
