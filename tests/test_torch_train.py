"""The port's training slice on the CPU (its plain conv path) against the
JAX package: the conv backward's geometry and launches, the GAN losses and
their gradients,
the optimizers, the loss-scale state machine, one whole fused Algorithm-1
step, the engine (resume replays bit for bit) and the launcher's
checkpoint that the serving launcher restores.

Inputs are made with numpy and go through both packages.  Tolerances,
each relative to the largest magnitude of what is compared:

- f32: 1e-4 (summation order; the port sums convs in another order than
  XLA's CPU convs);
- a whole bf16 step: see ``STEP_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import calo3dgan as jcfgs
from repro.core import adversarial as jadv
from repro.core import gan as jgan
from repro.optim import optimizers as jopt
from repro.substrate import precision as jprec
from repro_torch.configs import calo3dgan as tcfgs
from repro_torch.convert import (state_from_numpy, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.core import adversarial as tadv
from repro_torch.core import gan as tgan
from repro_torch.data.calo import CaloSimulator, CaloSpec
from repro_torch.optim import optimizers as topt
from repro_torch.substrate import precision as tprec

TINY = dict(image_shape=(6, 6, 6), latent_dim=8, gen_channels=(6, 4),
            disc_channels=(4, 6), batch_size=4)
JCFG = dataclasses.replace(jcfgs.bench(), use_pallas_conv=False, **TINY)
TCFG = dataclasses.replace(tcfgs.bench(), **TINY)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _close(got, want, tol, what="", scale=None):
    """max |got - want| <= tol * scale (default: the largest |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max abs {err} > {tol} * {scale}"


def _leaves(tree, prefix=""):
    """{path: array} of a nested dict (None leaves skipped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().float() if isinstance(v, torch.Tensor) else
                jnp.asarray(v, jnp.float32))
    return out


# ---------------------------------------------------------------------------
# GAN losses, optimizers, loss scale
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_nets():
    g = jax.device_get(jgan.init_generator(jax.random.key(0), JCFG))
    d = jax.device_get(jgan.init_discriminator(jax.random.key(1), JCFG))
    return g, d


def _labels(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(10.0, 500.0, n).astype(np.float32),
            rng.uniform(1.0, 2.1, n).astype(np.float32),
            rng.uniform(0.5, 8.0, n).astype(np.float32))


@pytest.mark.parametrize("real", [True, False])
def test_disc_loss_and_grads_match_jax(jax_nets, real):
    _, d = jax_nets
    img = np.random.default_rng(4).gamma(
        2.0, 0.01, size=(3, *TCFG.image_shape, 1)).astype(np.float32)
    labels = _labels(3)

    def jloss(dp):
        return jgan.disc_loss(dp, jnp.asarray(img),
                              tuple(map(jnp.asarray, labels)), JCFG, real)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(d)
    dp = tree_from_numpy(d, "cpu")
    for v in _leaves_tensors(dp):
        v.requires_grad_(True)
    tl, taux = tgan.disc_loss(dp, torch.from_numpy(img),
                              tuple(map(torch.from_numpy, labels)), TCFG,
                              real)
    tg = torch.autograd.grad(tl, _leaves_tensors(dp))
    _close(float(tl.detach()), float(jl), 1e-5, "loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(float(taux[k]), float(jaux[k]), 1e-5, k)
    for (path, want), got in zip(_leaves(jg).items(), tg):
        _close(got.numpy(), want, 1e-4, path)


def test_gen_loss_and_grads_match_jax(jax_nets):
    g, d = jax_nets
    noise = np.random.default_rng(5).normal(
        size=(3, TCFG.latent_dim)).astype(np.float32)
    labels = _labels(3, seed=1)

    def jloss(gp):
        return jgan.gen_loss(gp, d, jnp.asarray(noise),
                             tuple(map(jnp.asarray, labels)), JCFG)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(g)
    gp = tree_from_numpy(g, "cpu")
    for v in _leaves_tensors(gp):
        v.requires_grad_(True)
    tl, taux = tgan.gen_loss(gp, tree_from_numpy(d, "cpu"),
                             torch.from_numpy(noise),
                             tuple(map(torch.from_numpy, labels)), TCFG)
    tg = torch.autograd.grad(tl, _leaves_tensors(gp))
    _close(float(tl.detach()), float(jl), 1e-5, "loss")
    for k in jaux:
        _close(float(taux[k]), float(jaux[k]), 1e-5, k)
    for (path, want), got in zip(_leaves(jg).items(), tg):
        _close(got.numpy(), want, 1e-4, path)


def _leaves_tensors(tree):
    return tprec.tree_leaves(tree)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adam", {}), ("adamw", {}),
                                     ("rmsprop", {}),
                                     ("rmsprop", {"momentum": 0.5})])
@pytest.mark.parametrize("schedule", [False, True])
def test_optimizer_updates_match_jax(name, kw, schedule):
    rng = np.random.default_rng(len(name))
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jo = jopt.get_optimizer(name, jopt.constant(3e-3) if schedule else 3e-3,
                            **kw)
    to = topt.get_optimizer(name, topt.constant(3e-3) if schedule else 3e-3,
                            **kw)
    jp, js = params, jo.init(params)
    tp = tree_from_numpy(params, "cpu")
    ts = to.init(tp)
    for _ in range(3):
        grads = {"a": rng.normal(size=(3, 4)).astype(np.float32),
                 "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
        ju, js = jo.update(grads, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tree_from_numpy(grads, "cpu"), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for (path, want), got in zip(_leaves(jp).items(), _leaves(tp).values()):
        _close(got, want, 1e-6, path)
    assert int(ts["step"]) == int(js["step"]) == 3
    jstate = {k: v for k, v in js.items() if k != "step"}
    tstate = {k: v for k, v in ts.items() if k != "step"}
    for (path, want), got in zip(_leaves(jstate).items(),
                                 _leaves(tstate).values()):
        _close(got, want, 1e-6, path)


@pytest.mark.parametrize("policy", ["bf16", "fp16"])
def test_next_loss_scale_follows_jax(policy):
    """A scripted run of finite and nonfinite phases: the scale halves on
    each overflow (never below 1), doubles after ``growth_interval`` clean
    phases (fp16), and never grows under bf16."""
    jp = dataclasses.replace(jprec.get_policy(policy), growth_interval=3) \
        if policy == "fp16" else jprec.get_policy(policy)
    tp = dataclasses.replace(tprec.get_policy(policy), growth_interval=3) \
        if policy == "fp16" else tprec.get_policy(policy)
    js = jprec.init_loss_scale(jp)
    ts = tprec.init_loss_scale(tp, "cpu")
    script = [True, False, True, True, True, True, False, False, True] \
        + [False] * 20 + [True] * 7
    for fin in script:
        js = jprec.next_loss_scale(js, jnp.bool_(fin), jp.growth_interval)
        ts = tprec.next_loss_scale(ts, torch.tensor(fin), tp.growth_interval)
        assert float(ts.scale) == float(js.scale)
        assert int(ts.good_steps) == int(js.good_steps)
    assert float(ts.scale) == (1.0 if policy == "bf16" else 4.0)


def test_all_finite_unscale_select():
    tree = {"a": torch.ones(3), "b": {"c": torch.full((2,), 4.0)}}
    ls = tprec.init_loss_scale(tprec.FP16, "cpu")
    assert bool(tprec.all_finite(tree))
    bad = {"a": torch.tensor([1.0, float("inf"), 0.0]), "b": tree["b"]}
    assert not bool(tprec.all_finite(bad))
    assert float(tprec.unscale(ls, tree)["b"]["c"][0]) == 4.0 / 2 ** 15
    kept = tprec.select_finite(torch.tensor(False), bad, tree)
    assert torch.equal(kept["a"], tree["a"])


# ---------------------------------------------------------------------------
# one whole fused Algorithm-1 step against the JAX step
# ---------------------------------------------------------------------------


def _recording(opt_mod, base, into, jax_side):
    """``base`` whose update first records the gradients it is given (on
    the JAX side through an ordered debug callback, so it works under
    jit and inside scan)."""
    def update(grads, state, params=None):
        if jax_side:
            jax.debug.callback(lambda g: into.append(g), grads, ordered=True)
        else:
            into.append(tree_to_numpy(grads))
        return base.update(grads, state, params)
    return opt_mod.Optimizer(base.init, update)


def _jax_inputs(rng_key, M, mb, jdt):
    """The generator inputs the JAX step draws, re-derived from its key
    exactly as adversarial.py:295-307 splits it, by phase index."""
    keys = jax.random.split(rng_key, (1 + JCFG.gen_steps_per_disc) * M)
    out = []
    for k in keys:
        k1, k2, k3 = jax.random.split(k, 3)
        out.append((
            np.asarray(jax.random.normal(k1, (mb, JCFG.latent_dim), jdt)
                       .astype(jnp.float32)),
            np.asarray(jax.random.uniform(k2, (mb,), jnp.float32, 10.0,
                                          500.0)),
            np.asarray(jax.random.uniform(k3, (mb,), jnp.float32,
                                          jnp.deg2rad(60.0),
                                          jnp.deg2rad(120.0)))))
    return out


def _fused_steps(policy, M, pallas=False):
    """One fused step of the JAX package (its lax conv route, or its
    Pallas route in interpret mode) and one of the port, from the same
    ``GANState`` and the same generator inputs, each with SGD(1e-3) that
    records the gradients of every phase.  Returns ``{"jax": ..., "torch":
    ...}``, each (gradients per phase as {path: array}, {path: param
    before}, {path: param after}, metrics, new state)."""
    B = 4
    batch = next(CaloSimulator(CaloSpec(image_shape=TCFG.image_shape),
                               seed=0).batches(B))
    jcfg = dataclasses.replace(JCFG, use_pallas_conv=pallas)
    jrec, trec = [], []
    jo = _recording(jopt, jopt.sgd(1e-3), jrec, True)
    to = _recording(topt, topt.sgd(1e-3), trec, False)
    jpol, tpol = jprec.get_policy(policy), tprec.get_policy(policy)
    jstate = jadv.init_state(jax.random.key(0), jcfg, jo, jo, policy=jpol)
    key = jax.random.key(1)
    jstep = jadv.make_fused_step(jcfg, jo, jo, policy=jpol, microbatches=M)
    jnew, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
    jax.block_until_ready(jnew)
    jax.effects_barrier()

    s = jax.device_get(jstate)
    ls = None if s.loss_scale is None else (s.loss_scale.scale,
                                            s.loss_scale.good_steps)
    tstate = state_from_numpy(s.g_params, s.d_params, s.g_opt, s.d_opt,
                              s.step, ls, device="cpu")
    inputs = _jax_inputs(key, M, B // M, JDT[policy])
    tstep = tadv.make_fused_step(TCFG, to, to, policy=tpol, microbatches=M,
                                 sample_inputs=lambda i, mb: inputs[i])
    tnew, tm = tstep(tstate, batch, torch.Generator())

    def params(state):
        return {f"{w}/{k}": v for w in ("g_params", "d_params")
                for k, v in _leaves(getattr(state, w)).items()}
    return {"jax": ([_leaves(jax.tree.map(np.asarray, g)) for g in jrec],
                    params(jstate), params(jnew), jm, jnew),
            "torch": ([_leaves(g) for g in trec], params(tstate),
                      params(tnew), tm, tnew)}


# whole-step tolerances, each leaf against its own largest magnitude.
# f32: 1e-4 (summation order; measured ~1e-6).  bf16: a step of this tiny
# config is dominated by bf16 rounding that neither package controls: the
# JAX package's own two conv routes disagree on it by up to 0.34 of a
# leaf's largest magnitude, on leaves a few percent of their phase's
# largest whose terms cancel (a single bf16 gen_loss gradient is already
# up to 0.44 off the f32 one there).  So under bf16 each leaf is held to
# the larger of its own largest magnitude and BF16_FLOOR of its phase's
# largest, times 0.15 against the Pallas route (which sums every conv
# gradient in f32, as the port does; measured up to 0.54 of that limit)
# and 0.25 against the lax route (which sums the bf16 cotangent of every
# conv bias in bf16; measured up to 0.75 of it).  A leaf that is missing
# or wrong is caught down to 1.5% (2.5%) of its phase's largest gradient.
# The per-conv bf16 gradients are held to 2e-2 in test_torch_conv_grads.py.
STEP_TOL = {("f32", False): 1e-4, ("bf16", True): 0.15,
            ("bf16", False): 0.25}
BF16_FLOOR = 0.1


def _check_step(steps, policy, pallas=False):
    """The port's step against the JAX step: metrics, the gradients of
    each phase (D-real, D-fake, G, G) leaf by leaf, the updated params
    (f32) or each network's update, new - old params (bf16: under SGD a
    linear function of the gradients; the params themselves hold the bf16
    noise below their f32 rounding), leaf by leaf, and the counters."""
    tol = STEP_TOL[policy, pallas]
    floor = BF16_FLOOR if policy == "bf16" else 0.0
    (jrec, jp0, jp1, jm, jnew), (trec, tp0, tp1, tm, tnew) = (
        steps["jax"], steps["torch"])
    assert set(tm) == set(jm)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), tol, k)

    def leafwise(got, want, what):
        assert list(got) == list(want), what
        top = max(np.abs(v).max() for v in want.values())
        for path in want:
            _close(got[path], want[path], tol, f"{what} {path}",
                   scale=max(np.abs(want[path]).max(), floor * top, 1e-30))
    assert len(trec) == len(jrec) == 2 + JCFG.gen_steps_per_disc
    for ph, (tg, jg) in enumerate(zip(trec, jrec)):
        leafwise(tg, jg, f"phase {ph}")
    for net in ("g_params", "d_params"):
        keys = [k for k in jp0 if k.startswith(net)]
        if policy == "f32":
            leafwise({k: tp1[k] for k in keys}, {k: jp1[k] for k in keys},
                     "param")
        else:
            leafwise({k: tp1[k] - tp0[k] for k in keys},
                     {k: jp1[k] - jp0[k] for k in keys}, "update")
    assert int(tnew.step) == int(jnew.step) == 1
    assert int(tnew.g_opt["step"]) == 2 and int(tnew.d_opt["step"]) == 2


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_fused_step_matches_jax(policy, M):
    """Against the JAX step through its lax conv route."""
    _check_step(_fused_steps(policy, M), policy)
