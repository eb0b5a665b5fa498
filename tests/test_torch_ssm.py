"""The port's Mamba2 (SSD) scan against the JAX package on the CPU: the
plain chunked forward and backward (``kernels/ssm_scan/ref.py``) against
the reference's Pallas kernels in interpret mode, the autograd Function
against ``torch.autograd`` through the sequential oracle, the wrappers'
input checks, ``substrate/ssm.apply_mamba2`` against the reference's
kernel route, and ``chip_smoke.py``'s SSD work count.

Inputs are made with numpy from seeds and handed to both packages.  The
chunk is passed explicitly on both sides.  Tolerance: every output
elementwise within 2e-4 absolute plus 2e-4 relative, the JAX package's
own tolerance for its kernel against its sequential scan
(``tests/test_kernel_ssm_scan.py``), for the forward and the backward
alike (its backward is held to 5e-4 there).  Both sides compute in f32
and sum in other orders, and the port keeps the log-decay cumsum in f64
where the TPU kernel keeps it in f32.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.ssm_scan.ssm_scan import ssm_scan as jssm_fwd
from repro.kernels.ssm_scan.ssm_scan import ssm_scan_bwd as jssm_bwd
from repro.substrate import ssm as jssm
from repro_torch.configs import base as tbase
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels.ssm_scan import ops as tops
from repro_torch.kernels.ssm_scan import ref as tref
from repro_torch.kernels.ssm_scan import ssm_scan as tssm
from repro_torch.substrate import ssm as tssm_layer

ATOL = RTOL = 2e-4

SSM_CASES = [
    # Bt, S, H, P, N, chunk (the JAX package's SSM_CASES)
    (1, 64, 2, 8, 4, 32),        # chunk-multiple
    (2, 128, 4, 16, 8, 64),      # batch, taller state
    (1, 100, 2, 8, 4, 32),       # S not divisible by chunk
    (1, 37, 3, 8, 4, 16),        # odd S, odd H
    (1, 64, 2, 8, 4, 128),       # chunk > S (clamped)
]


def _scan_args(Bt, S, H, P, N, seed=13):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (Bt, S, H, P)).astype(np.float32)
    B = rng.normal(0, 1, (Bt, S, N)).astype(np.float32)
    C = rng.normal(0, 1, (Bt, S, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (Bt, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(0, 1, (H,))).astype(np.float32)
    dy = rng.normal(0, 1, (Bt, S, H, P)).astype(np.float32)
    return (x, B, C, dt, A), dy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", SSM_CASES)
def test_plain_forward_and_backward_match_the_pallas_kernels(Bt, S, H, P,
                                                             N, chunk):
    """y, the final state and every chunk's entry state; then dx, dB, dC,
    ddt and dA from each side's own entry states."""
    args, dy = _scan_args(Bt, S, H, P, N)
    jy, jsf, jsi = jssm_fwd(*map(jnp.asarray, args), chunk=chunk,
                            interpret=True, return_chunk_states=True)
    jg = jssm_bwd(*map(jnp.asarray, args), jsi, jnp.asarray(dy), chunk=chunk,
                  interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    fwd = tssm.ssm_scan_fwd(*targs, chunk=chunk, return_chunk_states=True)
    bwd = tssm.ssm_scan_bwd(*targs, fwd[2], torch.from_numpy(dy),
                            chunk=chunk)
    assert fwd[2].shape == jsi.shape == (Bt, H, -(-S // min(chunk, S)), P, N)
    for got, want in zip(fwd + bwd, (jy, jsf, jsi) + tuple(jg)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        _close(got, want)


def test_the_sequential_oracle_matches_the_reference_oracle():
    from repro.kernels.ssm_scan.ref import ssm_scan_ref
    args, _ = _scan_args(2, 40, 3, 8, 4, seed=2)
    jy, js = ssm_scan_ref(*map(jnp.asarray, args))
    ty, ts = tref.ssm_scan_seq_ref(*[torch.from_numpy(a) for a in args])
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("S,chunk", [(96, 32), (100, 128), (37, 16)])
def test_op_gradients_match_autograd_through_the_sequential_scan(S, chunk):
    """The autograd Function (plain forward and backward on the CPU)
    against torch.autograd through ``ssm_scan_seq_ref``: y and all five
    gradients."""
    args, dy = _scan_args(2, S, 3, 8, 4, seed=S)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tops.ssm_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    yr = tref.ssm_scan_seq_ref(*ref_leaves)[0]
    want = torch.autograd.grad(yr, ref_leaves, torch.from_numpy(dy))
    _close(y.detach(), yr.detach())
    for a, b in zip(got, want):
        _close(a, b)


def test_op_honours_needs_input_grad_and_counts_no_cpu_launch():
    args, dy = _scan_args(1, 20, 2, 8, 4, seed=4)
    t = [torch.from_numpy(a) for a in args]
    n0 = (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES)
    x = t[0].clone().requires_grad_()
    y = tops.ssm_scan(x, *t[1:])
    (gx,) = torch.autograd.grad(y, [x], torch.from_numpy(dy))
    full = tssm.ssm_scan_bwd(*t, tssm.ssm_scan_fwd(
        *t, chunk=tops.CHUNK, return_chunk_states=True)[2],
        torch.from_numpy(dy), chunk=tops.CHUNK)
    assert torch.equal(gx, full[0])
    with torch.no_grad():
        assert not tops.ssm_scan(*t).requires_grad
    assert (tssm.FWD_LAUNCHES, tssm.BWD_LAUNCHES) == n0
    assert tops.CHUNK == 128


def test_wrappers_check_their_inputs():
    """f32 only, shapes that agree, one device; a tensor on neither the CPU
    nor a card raises (no plain-version fallback for a device tensor)."""
    args, dy = _scan_args(1, 16, 2, 8, 4, seed=6)
    x, B, C, dt, A = (torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="x must be f32"):
        tssm.ssm_scan_fwd(x.double(), B, C, dt, A, chunk=8)
    with pytest.raises(ValueError, match="C must be f32"):
        tssm.ssm_scan_fwd(x, B, C[:, :8], dt, A, chunk=8)
    with pytest.raises(ValueError, match="dt must be f32"):
        tssm.ssm_scan_fwd(x, B, C, dt.bfloat16(), A, chunk=8)
    with pytest.raises(ValueError, match="chunk must be positive"):
        tssm.ssm_scan_fwd(x, B, C, dt, A, chunk=0)
    si = tssm.ssm_scan_fwd(x, B, C, dt, A, chunk=8,
                           return_chunk_states=True)[2]
    assert si.shape == (1, 2, 2, 8, 4)
    with pytest.raises(ValueError, match="chunk_states"):
        tssm.ssm_scan_bwd(x, B, C, dt, A, si, torch.from_numpy(dy), chunk=4)
    meta = [t.to("meta") for t in (x, B, C, dt, A)]
    with pytest.raises(ValueError, match="runs on cuda"):
        tssm.ssm_scan_fwd(*meta, chunk=8)


@pytest.fixture(scope="module")
def mamba():
    cfg = jbase.reduced_config("zamba2-1.2b")
    p = jax.device_get(jssm.init_mamba2(jax.random.key(3), cfg.d_model,
                                        cfg.ssm))
    x = np.random.default_rng(9).normal(0, 1, (2, 64, cfg.d_model)).astype(
        np.float32)
    return cfg, p, x


def test_reduced_config_keeps_the_reference_fields():
    for arch in ("zamba2-1.2b", "qwen2-1.5b"):
        for fn in ("get_config", "reduced_config"):
            t, j = getattr(tbase, fn)(arch), getattr(jbase, fn)(arch)
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab", "d_head", "ffn_type", "family",
                      "shared_attn_every", "rope_theta"):
                assert getattr(t, f) == getattr(j, f), (arch, fn, f)
            if j.ssm is None:
                assert t.ssm is None
            else:
                for f in ("state_dim", "head_dim", "expand", "conv_width"):
                    assert getattr(t.ssm, f) == getattr(j.ssm, f)
                # the reference's chunk feeds only its lax.scan route; the
                # port's kernel route runs at ops.CHUNK
                assert not hasattr(t.ssm, "chunk")


def test_init_mamba2_has_the_reference_leaves(mamba):
    cfg, p, _ = mamba
    mine = tssm_layer.init_mamba2(torch.Generator().manual_seed(0),
                                  cfg.d_model, cfg.ssm, "cpu")
    got = tree_to_numpy(mine)
    assert sorted(got) == sorted(p) and sorted(got["norm"]) == ["scale"]
    for k in p:
        if k != "norm":
            assert got[k].shape == p[k].shape and got[k].dtype == p[k].dtype
    # log(linspace(1, 16, H)): the two linspaces may round one ulp apart
    np.testing.assert_allclose(got["A_log"], p["A_log"], rtol=1e-6)
    dt = np.log1p(np.exp(got["dt_bias"]))         # softplus: in [1e-3, 0.1]
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt <= 0.1 * (1 + 1e-5)).all()


def test_apply_mamba2_matches_the_reference_kernel_route(mamba):
    """``apply_mamba2`` against the reference's with ``use_pallas=True``
    (its SSD kernels in interpret mode): the output, and the gradients of
    sum(sin(y)) in x and in every parameter."""
    cfg, p, x = mamba

    def jloss(pp, xx):
        return jnp.sum(jnp.sin(jssm.apply_mamba2(pp, xx, cfg.d_model, cfg.ssm,
                                                 use_pallas=True)))

    jy = jssm.apply_mamba2(p, jnp.asarray(x), cfg.d_model, cfg.ssm,
                           use_pallas=True)
    jgp, jgx = jax.grad(jloss, (0, 1))(p, jnp.asarray(x))
    tcfg = tbase.reduced_config("zamba2-1.2b")
    tp = tree_from_numpy(p, "cpu")
    leaves = {k: v for k, v in tp.items() if k != "norm"}
    for v in list(leaves.values()) + [tp["norm"]["scale"]]:
        v.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tssm_layer.apply_mamba2(tp, tx, tcfg.d_model, tcfg.ssm)
    _close(ty.detach(), jy)
    names = sorted(leaves) + ["norm"]
    wrt = [leaves[k] for k in sorted(leaves)] + [tp["norm"]["scale"], tx]
    grads = torch.autograd.grad(torch.sin(ty).sum(), wrt)
    for name, g in zip(names, grads):
        want = jgp[name]["scale"] if name == "norm" else jgp[name]
        _close(g, want)
    _close(grads[-1], jgx)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ssd_work_counts_the_kernels_products():
    """At the zamba2-1.2b training shapes (two chunks of 128) both wrappers
    are bound by operations, counted as the function needs them: the
    visible pairs s <= t of each (L, L) product, C B^T once per batch row,
    no product with the zero entry state or the zero G of the last chunk;
    2.71 GFLOP against 93.8 MB forward, 7.03 GFLOP against 120.6 MB
    backward.  A ragged S counts only its real steps."""
    cs = _chip_smoke()
    w = cs.ssd_work(8, 256, 64, 64, 64, 128)
    pairs, lpn = 128 * 129 // 2, 128 * 64 * 64
    cb = 8 * 2 * pairs * 64
    assert w["ssd_fwd"][3] == 2 * (cb + 8 * 64 * (2 * pairs * 64 + 3 * lpn))
    assert w["ssd_bwd"][3] == 2 * (cb + 8 * 64 * (2 * pairs * 4 * 64
                                                  + 5 * lpn))
    assert w["ssd_fwd"][2] == 4 * (2 * 8 * 256 * 64 * 64 + 2 * 8 * 256 * 64
                                   + 8 * 256 * 64 + 64 + 3 * 8 * 64 * 64 * 64)
    assert round(w["ssd_fwd"][3] / 1e9, 2) == 2.71
    assert round(w["ssd_bwd"][3] / 1e9, 2) == 7.03
    assert round(w["ssd_fwd"][2] / 1e6, 1) == 93.8
    assert round(w["ssd_bwd"][2] / 1e6, 1) == 120.6
    for name in ("ssd_fwd", "ssd_bwd"):
        bound, by, nbytes, flops = w[name]
        assert by == "operations"
        assert bound == pytest.approx(flops / 67e12 * 1e3)
    ragged = cs.ssd_work(8, 200, 64, 64, 64, 128)     # chunks of 128 and 72
    p72 = 72 * 73 // 2
    assert ragged["ssd_fwd"][3] == 2 * (
        8 * (pairs + p72) * 64
        + 8 * 64 * ((pairs + p72) * 64 + 128 * 4096 + 2 * 72 * 4096))
    assert ragged["ssd_fwd"][2] < w["ssd_fwd"][2]
    small = cs.ssd_work(1, 10, 1, 2, 2, 128)          # one chunk of 10
    assert small["ssd_fwd"][3] == 2 * (55 * 2 + 55 * 2 + 10 * 2 * 2)
    assert small["ssd_bwd"][3] == 2 * (55 * 2 + 55 * 2 * 4)
    assert small["ssd_fwd"][1] == "bytes"
