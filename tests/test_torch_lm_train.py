"""The port's LM training path against the JAX package on the CPU, on
``reduced_config("qwen2-1.5b")`` (2 layers, d 256, 4 heads over 2 KV
heads of 64, vocab 512), with parameters from the reference's ``lm.init``
carried over by ``convert.lm_from_numpy`` and tokens made with numpy.

Tolerances (f32 on both sides; matmul, attention and reduction sums in
another order): the loss and the grad norm 1e-5 relative; each gradient
leaf 1e-4 of its largest magnitude (measured: under 1e-6).  After two
AdamW steps each moment leaf within 1e-4 of its largest, and the
parameter update (params after minus params before) within 1e-3 of its
leaf's largest on the elements whose gradient, in both steps, exceeds
1e-3 of its leaf's largest.  Adam divides each element by its own
gradient scale, so the update carries the gradient's relative error of
that element: where a gradient is within a few 1e-6 of the leaf's
largest, the last bits of the sum decide the update (at |g| near eps =
1e-8 anything in (-lr, lr)).  The reference runs its loss with the Pallas
flash attention in interpret mode (``use_pallas_attn=True``) and with its
pure-JAX route.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.tokens import MarkovTokens as JMarkov
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.substrate.precision import get_policy as j_policy
from repro.train import checkpoint as jckpt
from repro.train import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.convert import (lm_from_numpy, lm_state_from_numpy,
                                 lm_to_numpy, tree_from_numpy, tree_to_numpy)
from repro_torch.data.tokens import MarkovTokens as TMarkov
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.substrate.precision import get_policy as t_policy
from repro_torch.substrate.precision import tree_leaves, tree_map
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import steps as tsteps

ARCH = "qwen2-1.5b"
B, S = 4, 24


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jlm.init(jax.random.key(0),
                                   jbase.reduced_config(ARCH)))


def _tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _close_tree(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scale, (k, err, scale)


def _rel(a, b, tol):
    assert abs(float(a) - float(b)) <= tol * abs(float(b)), (a, b)


@pytest.mark.parametrize("pallas", [True, False])
def test_loss_and_grads_match_jax(params, pallas):
    tokens = _tokens()
    cfg_j = dataclasses.replace(jbase.reduced_config(ARCH),
                                use_pallas_attn=pallas)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {"tokens": jnp.asarray(tokens)}, cfg_j,
                              policy=j_policy("f32")), has_aux=True)(params)
    cfg = tbase.reduced_config(ARCH)
    tp = lm_from_numpy(params, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, taux = tlm.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, cfg,
                           policy=t_policy("f32"))
    grads = torch.autograd.grad(tl, leaves)
    it = iter(grads)
    tg = tree_map(lambda _: next(it), tp)
    _rel(tl.detach(), jl, 1e-5)
    _rel(taux["ce"].detach(), jaux["ce"], 1e-5)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    _close_tree(lm_to_numpy(tg), jax.device_get(jg), 1e-4)


def _jax_steps(params, cfg, batches, microbatches):
    opt = jopt.adamw(jopt.warmup_cosine(1e-3, 1, 4))
    step = jax.jit(jsteps.make_train_step(
        japi.get_model(cfg), cfg, opt, j_policy("f32"), remat=True,
        microbatches=microbatches, seq_shard=False))
    p, s = params, opt.init(params)
    out = []
    for b in batches:
        p, s, m = step(p, s, {"tokens": jnp.asarray(b)})
        out.append((jax.device_get(p), jax.device_get(s),
                    {k: float(v) for k, v in m.items()}))
    return out


def _port_steps(params, cfg, batches, microbatches):
    opt = topt.adamw(topt.warmup_cosine(1e-3, 1, 4))
    step = tsteps.make_train_step(tapi.get_model(cfg), cfg, opt,
                                  t_policy("f32"),
                                  microbatches=microbatches)
    p = lm_from_numpy(params, "cpu")
    s = opt.init(p)
    out = []
    for b in batches:
        p, s, m = step(p, s, {"tokens": torch.from_numpy(b)})
        out.append((p, s, {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_two_train_steps_match_jax(params, microbatches):
    """Two AdamW steps (warmup_cosine(1e-3, 1, 4): the first step at the
    peak rate), remat on, clip at 1.0."""
    batches = [_tokens(1), _tokens(2)]
    want = _jax_steps(params, jbase.reduced_config(ARCH), batches,
                      microbatches)
    got = _port_steps(params, tbase.reduced_config(ARCH), batches,
                      microbatches)
    for (_, _, tm), (_, _, jm) in zip(got, want):
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "grad_norm"):
            _rel(tm[k], jm[k], 1e-5)
    (tp, ts, _), (jp, js, _) = got[-1], want[-1]
    assert int(ts["step"]) == int(js["step"]) == 2
    for k in ("m", "v"):
        _close_tree(lm_to_numpy(ts[k]), js[k], 1e-4)
    # each step's reference gradient, from its first moment (b1 = 0.9)
    m1, m2 = (_leaves(w[1]["m"]) for w in want)
    g1 = {k: m / 0.1 for k, m in m1.items()}
    g2 = {k: (m2[k] - 0.9 * m1[k]) / 0.1 for k in m1}
    upd_t = _leaves(jax.tree.map(lambda a, b: a - b, lm_to_numpy(tp), params))
    upd_j = _leaves(jax.tree.map(lambda a, b: a - b, jp, params))
    for k, u in upd_j.items():
        held = ((np.abs(g1[k]) > 1e-3 * np.abs(g1[k]).max())
                & (np.abs(g2[k]) > 1e-3 * np.abs(g2[k]).max()))
        assert held.any(), k
        err = float(np.abs(upd_t[k] - u)[held].max())
        assert err <= 1e-3 * float(np.abs(u).max()), (k, err)


def test_split_microbatches_follows_the_reference():
    tokens = _tokens(3, b=6, s=5)
    got = tsteps._split_microbatches({"tokens": torch.from_numpy(tokens)}, 3)
    want = jsteps._split_microbatches({"tokens": jnp.asarray(tokens)}, 3)
    for i, mb in enumerate(got):
        np.testing.assert_array_equal(mb["tokens"].numpy(),
                                      np.asarray(want["tokens"][i]))
    with pytest.raises(ValueError, match="microbatches"):
        tsteps._split_microbatches({"tokens": torch.from_numpy(tokens)}, 4)


def test_clip_norm_and_schedule_match_jax():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(7, 3)).astype(np.float32),
            "b": {"c": 30 * rng.normal(size=(11,)).astype(np.float32)}}
    _rel(topt.global_norm(tree_from_numpy(tree, "cpu")),
         jopt.global_norm(tree), 1e-6)
    for max_norm in (1.0, 1e3):
        tg, tn = topt.clip_by_global_norm(tree_from_numpy(tree, "cpu"),
                                          max_norm)
        jg, jn = jopt.clip_by_global_norm(tree, max_norm)
        _rel(tn, jn, 1e-6)
        _close_tree(tree_to_numpy(tg), jax.device_get(jg), 1e-6)
    tsched = topt.warmup_cosine(3e-4, 20, 100)
    jsched = jopt.warmup_cosine(3e-4, 20, 100)
    for step in (0, 1, 19, 20, 21, 60, 99, 100, 150):
        got = float(tsched(torch.tensor(step, dtype=torch.int32)))
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * 3e-4, (step, got, want)


def test_markov_tokens_draw_the_reference_sequence():
    for seed in (0, 7):
        t, j = TMarkov(512, seed=seed), JMarkov(512, seed=seed)
        for _ in range(2):
            np.testing.assert_array_equal(t.sample(3, 17), j.sample(3, 17))
        np.testing.assert_array_equal(next(t.batches(2, 5))["tokens"],
                                      next(j.batches(2, 5))["tokens"])


def test_lm_checkpoints_cross_between_port_and_reference(params, tmp_path):
    """Stacked ``blocks`` leaves both ways: the port saves what the
    reference restores, and restores what the reference saves, bit for
    bit; a leaf that is neither a dict nor a tensor raises."""
    cfg = tbase.reduced_config(ARCH)
    jtemplate = jlm.init(jax.random.key(1), jbase.reduced_config(ARCH))
    ttemplate = tlm.init(torch.Generator().manual_seed(1), cfg, "cpu")
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save(port_dir, lm_from_numpy(params, "cpu"), step=3)
    assert "blocks/attn/wq/w" in tckpt.manifest(port_dir)["keys"]
    back = jax.device_get(jckpt.restore(port_dir, jtemplate))
    jckpt.save(ref_dir, params, step=3)
    mine = tckpt.restore(ref_dir, ttemplate)
    assert isinstance(mine["blocks"], list) and len(mine["blocks"]) == 2
    for got in (back, lm_to_numpy(mine)):
        _close_tree(got, params, 0.0)
    for bad in ({"a": 1.5}, {"a": None}, {"a": []}, {"a": "x"}):
        with pytest.raises(TypeError, match="expected"):
            tckpt.save(str(tmp_path / "bad"), bad)
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore(port_dir, dict(ttemplate, extra=torch.zeros(1)))


def test_lm_state_from_numpy_carries_the_adamw_state(params):
    opt = jopt.adamw(1e-3)
    js = jax.device_get(opt.init(params))
    js = dict(js, step=np.int32(5),
              m=jax.tree.map(lambda a: a + 1.0, js["m"]))
    state = lm_state_from_numpy(params, js, device="cpu")
    assert int(state.opt_state["step"]) == 5
    _close_tree(lm_to_numpy(state.opt_state["m"]), js["m"], 0.0)
    _close_tree(lm_to_numpy(state.params), params, 0.0)


def test_launcher_trains_reduced_lm_and_saves_for_both(tmp_path, capsys):
    path = str(tmp_path / "lm")
    state = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt", path])
    out = capsys.readouterr().out
    assert "steps in" in out and "flash_fwd 0" in out and "saved" in out
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state.params))
    jparams = jckpt.restore(path, jlm.init(jax.random.key(0),
                                           jbase.reduced_config(ARCH)))
    tparams = tckpt.restore(path, tlm.init(
        torch.Generator().manual_seed(0), tbase.reduced_config(ARCH), "cpu"))
    _close_tree(jax.device_get(jparams), lm_to_numpy(state.params), 0.0)
    _close_tree(lm_to_numpy(tparams), lm_to_numpy(state.params), 0.0)
    assert jckpt.manifest(path)["extra"]["arch"] == ARCH
    assert os.path.exists(os.path.join(path, "arrays.npz"))
