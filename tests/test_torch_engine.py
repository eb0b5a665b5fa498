"""The port's training slice on the CPU, around the step: the conv
backward's geometry (against the reference's pad rules) and its kernel
launches, the loss-scale guard, the engine (a resumed fit replays an
uninterrupted one bit for bit) and the launcher, whose checkpoint the
serving launcher restores.  Tolerance 1e-5 of the largest magnitude
(f32 summation order) where values are compared."""
import importlib
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import calo3dgan as tcfgs
from repro_torch.core import adversarial as tadv
from repro_torch.data.calo import CaloSimulator, CaloSpec
from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.kernels.conv3d import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.substrate import precision as tprec
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import engine as tengine

# the JAX package exports a function named like its conv3d module
jconv = importlib.import_module("repro.kernels.conv3d.conv3d")
TCFG = tcfgs.GANConfig(image_shape=(6, 6, 6), latent_dim=8,
                       gen_channels=(6, 4), disc_channels=(4, 6),
                       batch_size=4)


def _close(got, want, tol, what=""):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max abs {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# conv backward: launches and geometry (the gradients against JAX's Pallas
# ops are in test_torch_conv_grads.py)
# ---------------------------------------------------------------------------


def test_needs_input_grad_skips_kernels(monkeypatch):
    """A frozen weight runs no dw, an input that needs no gradient no dx
    (counted on the plain versions the CPU path calls)."""
    calls = {"core": 0, "dw": 0}
    core, dw = ref.conv_core_ref, ref.conv_dw_core_ref

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ref, "conv_core_ref", count("core", core))
    monkeypatch.setattr(ref, "conv_dw_core_ref", count("dw", dw))
    x = torch.randn(1, 4, 4, 4, 2)
    w = torch.randn(3, 3, 3, 2, 3)
    b = torch.zeros(3)
    for need_x, need_w, want in ((False, True, (1, 1)), (True, False, (2, 0)),
                                 (True, True, (2, 1))):
        calls.update(core=0, dw=0)
        xi = x.clone().requires_grad_(need_x)
        wi = w.clone().requires_grad_(need_w)
        ops.conv3d_bias_act(xi, wi, b, 2, "leaky_relu").sum().backward()
        assert (calls["core"], calls["dw"]) == want
        assert (xi.grad is not None) == need_x and \
            (wi.grad is not None) == need_w


def test_backward_pads_match_jax(monkeypatch):
    """The dx and dw routes of both convs hand their kernels the pads,
    strides and dilations of the reference's rules (conv3d.py:415-456):
    the reference's entry points are run with their kernel calls replaced
    by a recorder, so nothing is computed on the JAX side."""
    seen = []
    monkeypatch.setattr(jconv, "_conv_core", lambda *a, **k: seen.append(
        ("core", k["stride"], k["pads"], k.get("in_dilation", 1))))
    monkeypatch.setattr(jconv, "_conv_dw_core", lambda *a, **k: seen.append(
        ("dw", k["stride"], k["pads"], k.get("in_dilation", 1))))
    for L in range(2, 10):
        for s in (1, 2, 3):
            spatial, kd = (L, L + 1, 3), (3, 3, 3)
            w = np.zeros((*kd, 2, 4), np.float32)
            x = np.zeros((1, *spatial, 2), np.float32)
            jconv.conv3d_dx(None, w, s, spatial)
            assert seen.pop() == ("core", 1, tconv.dx_pads(spatial, kd, s), s)
            jconv.conv3d_dw(x, None, kd, s)
            assert seen.pop()[:3] == ("dw", s, tuple(
                tconv.same_pads(n, 3, s)[:2] for n in spatial))
            jconv.conv3d_transpose_dx(None, w, s)
            assert seen.pop() == ("core", s, tconv.transpose_dx_pads(kd, s),
                                  1)
            jconv.conv3d_transpose_dw(x, None, kd, s)
            assert seen.pop() == ("dw", 1, tuple(
                tconv.transpose_pads(3, s) for _ in range(3)), s)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_backward_routes_are_the_autograd_gradients(transpose, stride):
    """dx and dw of both convs through the port's routes equal torch's
    autograd of the plain forward, at odd sizes."""
    rng = np.random.default_rng(stride)
    x = torch.from_numpy(rng.normal(size=(2, 5, 3, 4, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 3, 2)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    fwd = (ref.conv3d_transpose_bias_act_ref if transpose
           else ref.conv3d_bias_act_ref)
    y = fwd(x, w, None, stride)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    want_dx, want_dw = torch.autograd.grad(y, (x, w), g)
    if transpose:
        got_dx = tconv.conv3d_transpose_dx(g, w.detach(), stride)
        got_dw = tconv.conv3d_transpose_dw(x.detach(), g, (3, 3, 3), stride)
        ref_dx = ref.conv3d_transpose_dx(g, w.detach(), stride)
    else:
        got_dx = tconv.conv3d_dx(g, w.detach(), stride, x.shape[1:4])
        got_dw = tconv.conv3d_dw(x.detach(), g, (3, 3, 3), stride)
        ref_dx = ref.conv3d_dx(g, w.detach(), stride, x.shape[1:4])
    _close(got_dx.numpy(), want_dx.numpy(), 1e-5, "dx")
    _close(got_dw.numpy(), want_dw.numpy(), 1e-5, "dw")
    assert torch.equal(got_dx, ref_dx)


@pytest.mark.parametrize("stride,pads,dil", [
    (1, ((1, 1),) * 3, 1),                          # input-position order
    (2, ((1, 1), (0, 1), (1, 0)), 1),               # output-position order
    (1, ((2, 1),) * 3, 2),                          # transposed conv's dw
    (2, ((1, -1), (2, 0), (-1, 1)), 2),             # cropping, dilated
])
def test_plain_dw_is_the_autograd_weight_gradient(stride, pads, dil):
    """conv_dw_core_ref is d<conv_core_ref(x, w), g>/dw for any geometry."""
    rng = np.random.default_rng(stride + dil)
    x = torch.from_numpy(rng.normal(size=(2, 5, 4, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 3, 2)).astype(np.float32))
    w.requires_grad_(True)
    y = ref.conv_core_ref(x, w, None, stride=stride, pads=pads,
                          in_dilation=dil)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    (want,) = torch.autograd.grad(y, w, g)
    got = tconv.conv_dw_core(x, g, (3, 3, 3), stride=stride, pads=pads,
                             in_dilation=dil)
    _close(got.numpy(), want.numpy(), 1e-5, "dw")


def test_dw_splits_cover_the_card_and_stay_fixed():
    assert tconv.dw_splits(12_845_056, 3456) == 37      # gen up2, 14 tiles
    assert tconv.dw_splits(4096, 221_184) == 1          # disc conv3
    assert tconv.dw_splits(100, 216) == 1               # short sums
    assert tconv.dw_splits(10**9, 1) == tconv.DW_TARGET_BLOCKS


def test_conv_launch_count_per_step(monkeypatch):
    """50 / 16 at full width: the formula, checked by counting the plain
    versions' calls in one step at a small config."""
    assert tadv.conv_launches_per_step(tcfgs.config()) == (50, 16)
    calls = {"core": 0, "dw": 0}
    core, dw = ref.conv_core_ref, ref.conv_dw_core_ref

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ref, "conv_core_ref", count("core", core))
    monkeypatch.setattr(ref, "conv_dw_core_ref", count("dw", dw))
    opt = topt.rmsprop(1e-4)
    for M in (1, 2):
        calls.update(core=0, dw=0)
        state = tadv.init_state(torch.Generator().manual_seed(0), TCFG, opt,
                                opt, device="cpu")
        step = tadv.make_fused_step(TCFG, opt, opt, microbatches=M)
        batch = next(CaloSimulator(CaloSpec(image_shape=TCFG.image_shape),
                                   seed=0).batches(4))
        step(state, batch, torch.Generator().manual_seed(1))
        fwd, dw_n = tadv.conv_launches_per_step(TCFG, M)
        assert (calls["core"], calls["dw"]) == (fwd, dw_n)


def _inf_batch(B=4, seed=0):
    batch = next(CaloSimulator(CaloSpec(image_shape=TCFG.image_shape),
                               seed=seed).batches(B))
    batch["image"][0, 1, 2, 3, 0] = np.inf
    batch["ecal"] = batch["image"].sum(axis=(1, 2, 3, 4))
    return batch


@pytest.mark.parametrize("policy", ["bf16", "fp16"])
def test_guard_skips_nonfinite_phases(policy):
    """One inf pixel (and its E_CAL) makes D-on-real nonfinite: that phase
    keeps its params and optimizer state and halves the fp16 scale, the
    other three update.  With an inf in every fake draw too, no phase
    updates and the state comes back unchanged, bit for bit."""
    opt = topt.rmsprop(1e-4)
    pol = tprec.get_policy(policy)
    state = tadv.init_state(torch.Generator().manual_seed(0), TCFG, opt, opt,
                            policy=pol, device="cpu")
    s0 = float(state.loss_scale.scale)
    step = tadv.make_fused_step(TCFG, opt, opt, policy=pol)
    new, m = step(state, _inf_batch(), torch.Generator().manual_seed(1))
    assert float(m["nonfinite_skips"]) == 1.0
    assert int(new.d_opt["step"]) == 1 and int(new.g_opt["step"]) == 2
    assert float(m["loss_scale"]) == max(s0 / 2, 1.0)
    assert all(bool(torch.isfinite(v).all())
               for v in tprec.tree_leaves(new.d_params))

    def inf_inputs(i, mb):
        noise, e_p, theta = tadv.draw_inputs(
            torch.Generator().manual_seed(i), mb, TCFG.latent_dim)
        noise[0, 0] = float("inf")
        return noise, e_p, theta
    step = tadv.make_fused_step(TCFG, opt, opt, policy=pol,
                                sample_inputs=inf_inputs)
    new, m = step(state, _inf_batch(), torch.Generator().manual_seed(1))
    assert float(m["nonfinite_skips"]) == 4.0
    assert float(m["loss_scale"]) == max(s0 / 16, 1.0)
    for which in ("g_params", "d_params", "g_opt", "d_opt"):
        a, b = getattr(state, which), getattr(new, which)
        for x, y in zip(tprec.tree_leaves(a), tprec.tree_leaves(b)):
            assert torch.equal(x, y), which


# ---------------------------------------------------------------------------
# engine and launcher
# ---------------------------------------------------------------------------


def _fit(steps, state=None, start_step=0, seed=3):
    opt = topt.rmsprop(1e-3)
    task = tengine.gan_task(TCFG, opt, opt, policy=tprec.get_policy("bf16"))
    eng = tengine.Engine("cpu")
    sim = CaloSimulator(CaloSpec(image_shape=TCFG.image_shape), seed=seed)
    out = eng.fit(task, sim.batches(4, skip=start_step), steps, seed=seed,
                  state=state, start_step=start_step)
    return eng, out


def test_resumed_fit_replays_uninterrupted_bit_for_bit():
    _, (full, _) = _fit(4)
    _, (half, _) = _fit(2)
    eng, (resumed, _) = _fit(2, state=half, start_step=2)
    assert int(resumed.step) == int(full.step) == 4
    for which in ("g_params", "d_params", "g_opt", "d_opt"):
        for a, b in zip(tprec.tree_leaves(getattr(full, which)),
                        tprec.tree_leaves(getattr(resumed, which))):
            assert torch.equal(a, b), which
    assert torch.equal(full.loss_scale.scale, resumed.loss_scale.scale)
    assert set(eng.last_fit_stats) == {"steps", "host_transfers",
                                       "h2d_wait_ms", "h2d_put_ms",
                                       "h2d_wait_ms_windows"}
    assert tengine.step_seed(3, 0) != tengine.step_seed(3, 1) != \
        tengine.init_seed(3)


def test_fit_logs_windows_and_stops_with_the_stream():
    from repro_torch.train.metrics import MetricLog
    opt = topt.sgd(1e-3)
    task = tengine.gan_task(TCFG, opt, opt)
    eng = tengine.Engine("cpu")
    sim = CaloSimulator(CaloSpec(image_shape=TCFG.image_shape), seed=0)
    log = MetricLog(print_every=0)
    batches = [next(sim.batches(4)) for _ in range(5)]
    eng.fit(task, batches, 7, seed=0, log=log, log_every=2)
    assert eng.last_fit_stats["steps"] == 5
    assert [r["step"] for r in log.rows] == [1, 3, 4]
    assert eng.last_fit_stats["host_transfers"] == 3
    assert len(eng.last_fit_stats["h2d_wait_ms_windows"]) == 3
    with pytest.raises(ValueError, match="empty"):
        eng.fit(task, [], 2, seed=0)


def test_launcher_defaults_and_refusals():
    for arch in ("olmoe-1b-7b", "phi4-mini-3.8b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
            ttrain.main(["--arch", arch, "--device", "cpu"])
    for loop in ("custom", "naive"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.main(["--loop", loop, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--reduced", "--steps", "1"])   # cuda by default


def test_train_ckpt_is_served(tmp_path, capsys):
    path = str(tmp_path / "gan")
    state = ttrain.main(["--device", "cpu", "--reduced", "--steps", "2",
                         "--ckpt", path])
    out = capsys.readouterr().out
    assert "physics validation:" in out and "saved generator" in out
    man = tckpt.manifest(path)
    assert man["extra"]["precision"] == "bf16" and man["step"] == 2
    restored = tckpt.restore_gan_generator(path, tcfgs.reduced(), "cpu")
    for a, b in zip(tprec.tree_leaves(state.g_params),
                    tprec.tree_leaves(restored)):
        assert torch.equal(a, b)
    eng = tserve.main(["--device", "cpu", "--reduced", "--requests", "2",
                       "--ckpt", path])
    assert f"restored generator from {path} (step 2, precision=bf16)" in \
        capsys.readouterr().out
    for a, b in zip(tprec.tree_leaves(state.g_params),
                    tprec.tree_leaves(eng.params)):
        assert torch.equal(a, b)
    assert os.path.exists(os.path.join(path, "arrays.npz"))
