"""The port's Zamba2 training path against the JAX package on the CPU, on
``reduced_config("zamba2-1.2b")`` (2 Mamba2 layers at d 256, SSD heads
16 x P 32, state 32; the shared block at width 512 after layer 0, 4 heads
of 128, gelu FFN 512; vocab 512; untied head), with parameters from the
reference's ``zamba.init`` carried over by ``convert.lm_from_numpy`` and
tokens made with numpy.  The reference runs its SSD scan through its
Pallas kernels in interpret mode (``use_pallas_ssm=True``), its attention
through its Pallas flash kernels or its pure-JAX route.

Tolerances (f32 on both sides, sums in other orders): the loss and the
grad norm 1e-5 relative; each gradient leaf 1e-4 of its largest
magnitude (measured: under 5e-6); the shared block's ``attn/wo`` is
never read by the loss (the block projects through ``out``), so its
gradient is exactly 0 on both sides.  Each of two AdamW steps, run from
the reference's state before it: each moment leaf within 1e-4 of its
largest, and the update (params after minus before) within 1e-3 of its
leaf's largest where the step's gradient exceeds 1e-3 of its leaf's
largest (Adam divides each element by its own gradient scale; see
``tests/test_torch_lm_train.py``).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import zamba as jzamba
from repro.optim import optimizers as jopt
from repro.substrate.precision import get_policy as j_policy
from repro.train import checkpoint as jckpt
from repro.train import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_from_numpy, lm_state_from_numpy, lm_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import zamba as tzamba
from repro_torch.optim import optimizers as topt
from repro_torch.substrate.precision import get_policy as t_policy
from repro_torch.substrate.precision import tree_leaves, tree_map
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import steps as tsteps

ARCH = "zamba2-1.2b"
B, S = 2, 64


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jzamba.init(jax.random.key(0),
                                      jbase.reduced_config(ARCH)))


def _jcfg(pallas_attn=True):
    return dataclasses.replace(jbase.reduced_config(ARCH),
                               use_pallas_ssm=True,
                               use_pallas_attn=pallas_attn)


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
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scale, (k, err, scale)


def _rel(a, b, tol):
    assert abs(float(a) - float(b)) <= tol * abs(float(b)), (a, b)


@pytest.mark.parametrize("pallas_attn", [True, False])
def test_loss_and_grads_match_jax(params, pallas_attn):
    tokens = _tokens()
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jzamba.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                 _jcfg(pallas_attn), policy=j_policy("f32")),
        has_aux=True)(params)
    cfg = tbase.reduced_config(ARCH)
    tp = lm_from_numpy(params, "cpu")
    assert isinstance(tp["mamba"], list) and len(tp["mamba"]) == 2
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, taux = tzamba.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, cfg,
                              policy=t_policy("f32"))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    tg = tree_map(lambda _: next(it), tp)
    _rel(tl.detach(), jl, 1e-5)
    _rel(taux["ce"].detach(), jaux["ce"], 1e-5)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    got, want = lm_to_numpy(tg), jax.device_get(jg)
    for tree in (got, want):
        assert not np.asarray(tree["shared"]["attn"]["wo"]["w"]).any()
        tree["shared"]["attn"].pop("wo")
    _close_tree(got, want, 1e-4)


def _jax_steps(params, batches):
    cfg = _jcfg(False)
    opt = jopt.adamw(jopt.warmup_cosine(1e-3, 1, 4))
    step = jax.jit(jsteps.make_train_step(
        japi.get_model(cfg), cfg, opt, j_policy("f32"), remat=True,
        seq_shard=False))
    p, s = params, opt.init(params)
    out = []
    for b in batches:
        p, s, m = step(p, s, {"tokens": jnp.asarray(b)})
        out.append((jax.device_get(p), jax.device_get(s),
                    {k: float(v) for k, v in m.items()}))
    return out


def _port_step(cfg):
    opt = topt.adamw(topt.warmup_cosine(1e-3, 1, 4))
    return opt, tsteps.make_train_step(tapi.get_model(cfg), cfg, opt,
                                       t_policy("f32"))


def test_two_train_steps_match_jax(params):
    """Two AdamW steps (warmup_cosine(1e-3, 1, 4): the first at the peak
    rate), remat on, clip at 1.0, against the reference's jitted step
    (its SSD kernels in interpret mode, its pure-JAX attention).  The
    port's two chained steps give the reference's loss and grad norm.
    Each step's moments and update are held from the same state: the
    second step starts from the reference's state after the first.  (A
    chained second step starts from params up to lr / 10 apart where the
    first step's Adam divides gradients within a few eps of zero, and its
    gradients carry that difference: its head/w moments differ by 1.4e-4
    of their largest.)"""
    batches = [_tokens(1), _tokens(2)]
    want = _jax_steps(params, batches)
    cfg = tbase.reduced_config(ARCH)
    opt, step = _port_step(cfg)
    p = lm_from_numpy(params, "cpu")
    s = opt.init(p)
    chained = []
    for b in batches:
        p, s, m = step(p, s, {"tokens": torch.from_numpy(b)})
        chained.append({k: float(v) for k, v in m.items()})
    for tm, (_, _, jm) in zip(chained, want):
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "grad_norm"):
            _rel(tm[k], jm[k], 1e-5)
    starts = [(params, jax.device_get(jopt.adamw(1e-3).init(params)))] + [
        (w[0], w[1]) for w in want[:-1]]
    for (p0, s0), b, (jp, js, jm) in zip(starts, batches, want):
        state = lm_state_from_numpy(p0, s0, device="cpu")
        tp, ts, tm = step(state.params, state.opt_state,
                          {"tokens": torch.from_numpy(b)})
        for k in ("loss", "grad_norm"):
            _rel(tm[k], jm[k], 1e-5)
        assert int(ts["step"]) == int(js["step"])
        for k in ("m", "v"):
            mine, ref = lm_to_numpy(ts[k]), jax.tree.map(np.asarray, js[k])
            for tree in (mine, ref):
                if int(js["step"]) == 1:
                    assert not tree["shared"]["attn"]["wo"]["w"].any()
                tree["shared"]["attn"].pop("wo")
            _close_tree(mine, ref, 1e-4)
        # this step's reference gradient, from its first moment (b1 = 0.9)
        m_before = _leaves(s0["m"])
        g = {k: (m - 0.9 * m_before[k]) / 0.1
             for k, m in _leaves(js["m"]).items()}
        upd_t = _leaves(jax.tree.map(lambda a, c: a - c, lm_to_numpy(tp), p0))
        upd_j = _leaves(jax.tree.map(lambda a, c: a - c, jp, p0))
        for k, u in upd_j.items():
            if k == "shared/attn/wo/w":    # weight decay alone on both sides
                np.testing.assert_allclose(upd_t[k], u, rtol=1e-5,
                                           atol=1e-6 * np.abs(u).max())
                continue
            held = np.abs(g[k]) > 1e-3 * np.abs(g[k]).max()
            assert held.any(), k
            err = float(np.abs(upd_t[k] - u)[held].max())
            assert err <= 1e-3 * float(np.abs(u).max()), (k, err)


def test_mamba_tree_and_adamw_state_round_trip(params):
    """``lm_from_numpy`` cuts the stacked ``mamba`` leaves into per-layer
    dicts (``mamba/m/in_proj`` (2, 256, 1104) -> two (256, 1104)) and
    ``lm_to_numpy`` stacks them back, bit for bit; the AdamW state too."""
    tp = lm_from_numpy(params, "cpu")
    assert tp["mamba"][1]["m"]["in_proj"].shape == (256, 1104)
    np.testing.assert_array_equal(tp["mamba"][1]["m"]["in_proj"].numpy(),
                                  params["mamba"]["m"]["in_proj"][1])
    back = lm_to_numpy(tp)
    assert back["mamba"]["m"]["in_proj"].shape == (2, 256, 1104)
    _close_tree(back, params, 0.0)
    opt = jopt.adamw(1e-3)
    js = jax.device_get(opt.init(params))
    js = dict(js, step=np.int32(3),
              m=jax.tree.map(lambda a: a + 0.5, js["m"]))
    state = lm_state_from_numpy(params, js, device="cpu")
    assert int(state.opt_state["step"]) == 3
    _close_tree(lm_to_numpy(state.opt_state["m"]), js["m"], 0.0)
    _close_tree(lm_to_numpy(state.params), params, 0.0)


def test_zamba_checkpoints_cross_between_port_and_reference(params,
                                                            tmp_path):
    """``train/checkpoint.save`` writes the ``mamba`` list as the
    reference's stacked keys (``mamba/m/in_proj``), which the reference
    restores; the port restores what the reference saves; bit for bit."""
    cfg = tbase.reduced_config(ARCH)
    jtemplate = jzamba.init(jax.random.key(1), jbase.reduced_config(ARCH))
    ttemplate = tzamba.init(torch.Generator().manual_seed(1), cfg, "cpu")
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save(port_dir, lm_from_numpy(params, "cpu"), step=2)
    jckpt.save(ref_dir, params, step=2)
    keys = tckpt.manifest(port_dir)["keys"]
    assert "mamba/m/in_proj" in keys and "shared/attn/wq/w" in keys
    assert sorted(keys) == sorted(jckpt.manifest(ref_dir)["keys"])
    back = jax.device_get(jckpt.restore(port_dir, jtemplate))
    mine = tckpt.restore(ref_dir, ttemplate)
    assert isinstance(mine["mamba"], list) and len(mine["mamba"]) == 2
    for got in (back, lm_to_numpy(mine)):
        _close_tree(got, params, 0.0)


def test_launcher_trains_reduced_zamba_and_saves_for_both(tmp_path, capsys):
    path = str(tmp_path / "zamba")
    state = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "32",
                         "--ckpt", path])
    out = capsys.readouterr().out
    assert "steps in" in out and "saved" in out
    assert "ssd_fwd 0, ssd_bwd 0" in out and "flash_fwd 0" in out
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(state.params))
    jparams = jckpt.restore(path, jzamba.init(jax.random.key(0),
                                              jbase.reduced_config(ARCH)))
    _close_tree(jax.device_get(jparams), lm_to_numpy(state.params), 0.0)
    assert jckpt.manifest(path)["extra"]["arch"] == ARCH


def test_serving_fields_wait_for_zamba_serving():
    cfg = tbase.reduced_config(ARCH)
    model = tapi.get_model(cfg)
    assert model.init is tzamba.init and model.loss_fn is tzamba.loss_fn
    for fn in (model.init_cache, model.decode_step, model.prefill_chunk):
        with pytest.raises(NotImplementedError, match="Queue 1, item 10"):
            fn(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="Queue 1, item 10"):
        tserve.main(["--model", "lm", "--arch", ARCH, "--reduced",
                     "--device", "cpu"])


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_training_launches_and_profile_split():
    """Per step with remat: qwen2-1.5b 56 / 28 / 28 attention launches and
    no SSD launch; zamba2-1.2b 76 ssd_fwd, 38 ssd_bwd and, for the shared
    block's 7 applications (layers 0, 6, ..., 36), 14 / 7 / 7; the
    profile's kernels split by kind; the per-layer list keyed by index."""
    cs = _chip_smoke()
    assert cs.train_launches(tbase.get_config("qwen2-1.5b")) == {
        "flash_fwd": 56, "flash_bwd_dq": 28, "flash_bwd_dkv": 28,
        "ssd_fwd": 0, "ssd_bwd": 0}
    assert cs.train_launches(tbase.get_config(ARCH), steps=10) == {
        "flash_fwd": 140, "flash_bwd_dq": 70, "flash_bwd_dkv": 70,
        "ssd_fwd": 760, "ssd_bwd": 380}
    assert cs.train_launches(tbase.reduced_config(ARCH)) == {
        "flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
        "ssd_fwd": 4, "ssd_bwd": 2}
    assert set(cs.train_launches(tbase.get_config(ARCH))) == set(
        cs.TRAIN_KERNELS)
    split = cs.device_split([
        {"kernel": "(anonymous namespace)::ssd_bwd_kernel(float const*", "ms": 2.0},
        {"kernel": "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128", "ms": 5.0},
        {"kernel": "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128", "ms": 1.0},
        {"kernel": "void flash_bwd_dkv_kernel<float, 128>(float const*", "ms": 0.5},
        {"kernel": "void at::native::vectorized_elementwise_kernel<4, at", "ms": 0.25},
        {"kernel": "void at::native::reduce_kernel<512, 1, at::native::R", "ms": 0.125}])
    assert split == {"gemm": 6.0, "ssd": 2.0, "attention": 0.5,
                     "elementwise": 0.25, "other": 0.125}
    tree = cs.layer_tree({"embed": {"emb": 1}, "mamba": [{"a": 2}, {"a": 3}]})
    assert tree == {"embed": {"emb": 1}, "mamba": {"0": {"a": 2},
                                                   "1": {"a": 3}}}
