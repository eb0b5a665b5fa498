"""The port's standalone `gemm` (its plain path on the CPU) against the JAX
package's Pallas `gemm` run in interpret mode, plus the wrapper's input
checks, its launch counter and the tolerance rule ``ref.gemm_err``; the
chip smoke's gemm helpers.

Inputs come from a numpy seed and go through both packages.  Tolerances,
by ``ref.gemm_err``: an f32 output within 1e-5 of the case's largest
|output| (both sides sum in f32, in another order); a bf16 output within
one bf16 spacing of the JAX value plus 1e-5 of the largest (the two f32
sums, that far apart, may round to neighbouring bf16 values, and where a
sum cancels to near zero the spacing is finer than their difference)."""
import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.kernels.conv3d import gemm
from repro_torch.kernels.conv3d.ref import GEMM_TOL, bf16_spacing, gemm_err

# the JAX package exports a function named like its conv3d module
jconv = importlib.import_module("repro.kernels.conv3d.conv3d")

def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (100, 70, 50),
                                   (300, 200, 150), (1, 1, 1),
                                   (257, 129, 130)])   # ragged in all three
def test_gemm_f32_matches_jax(M, K, N):
    a, b = _operands(M * 7 + K, M, K, N)
    want = torch.from_numpy(np.array(jconv.gemm(jnp.asarray(a),
                                                jnp.asarray(b))))
    got = gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err, ok = gemm_err(got, want)
    assert ok, err


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_gemm_bf16_matches_jax(out_dtype):
    a, b = _operands(5, 128, 256, 64)
    ja, jb = (jnp.asarray(t, jnp.bfloat16) for t in (a, b))
    ta, tb = (torch.from_numpy(t).to(torch.bfloat16) for t in (a, b))
    j_out = None if out_dtype is None else jnp.float32
    want = torch.from_numpy(np.array(
        jconv.gemm(ja, jb, out_dtype=j_out).astype(jnp.float32)))
    got = gemm(ta, tb, out_dtype=out_dtype)
    assert got.dtype == (out_dtype or torch.bfloat16)
    err, ok = gemm_err(got, want.to(got.dtype))
    assert ok, err


def test_gemm_makes_non_contiguous_operands_contiguous():
    a, b = _operands(9, 40, 24, 33)
    ta = torch.from_numpy(np.ascontiguousarray(a.T)).T     # a strided view
    want = gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert not ta.is_contiguous()
    assert torch.equal(gemm(ta, torch.from_numpy(b)), want)


def test_gemm_rejects_what_it_does_not_take():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="gemm takes"):
        gemm(x, torch.zeros((4, 5)))                         # K 3 vs 4
    with pytest.raises(ValueError, match="gemm takes"):
        gemm(torch.zeros((2, 4, 3)), torch.zeros((3, 5)))    # 3-D
    with pytest.raises(TypeError, match="two f32 or two bf16"):
        gemm(x, torch.zeros((3, 5), dtype=torch.bfloat16))   # mixed
    with pytest.raises(TypeError, match="two f32 or two bf16"):
        gemm(x.double(), torch.zeros((3, 5), dtype=torch.float64))
    with pytest.raises(TypeError, match="two f32 or two bf16"):
        gemm(x, torch.zeros((3, 5)), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="empty"):
        gemm(torch.zeros((0, 3)), torch.zeros((3, 5)))


def test_gemm_on_cpu_launches_nothing():
    before = tconv.GEMM_LAUNCHES
    a, b = _operands(1, 30, 20, 10)
    gemm(torch.from_numpy(a), torch.from_numpy(b))
    gemm(torch.from_numpy(a).to(torch.bfloat16),
         torch.from_numpy(b).to(torch.bfloat16))
    assert tconv.GEMM_LAUNCHES == before == 0


def test_chip_smoke_gemm_shapes_and_entry():
    """The smoke's full-width GEMMs are the models': qwen2-1.5b's FFN in and
    out at batch 8 x 256, zamba2-1.2b's in_proj (2 * 4096 + 2 * 64 + 64
    outputs), the 3DGAN's fc at batch 128 (7 * 7 * 4 * 64 outputs); its
    entry carries every key of the kernels line; the bf16 spacing is the
    distance to the next bf16 value; its yardstick keeps the inputs' dtype
    through ``torch.matmul``."""
    from repro_torch.configs import base, calo3dgan
    cs = _chip_smoke()
    shapes = cs.gemm_shapes(calo3dgan.config(), base.get_config("qwen2-1.5b"),
                            base.get_config("zamba2-1.2b"))
    assert [s[1:4] for s in shapes if s[4]] == [
        (2048, 1536, 8960), (2048, 8960, 1536), (2048, 2048, 8384),
        (128, 256, 12544)]
    small = [s[1:4] for s in shapes if not s[4]]
    assert (1, 1, 1) in small and (100, 70, 50) in small
    assert len(set(small)) == len(small)
    v = torch.tensor([1.0, 1.5, -3.0, 300.0])
    sp = bf16_spacing(v)
    assert torch.equal(sp, torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6,
                                         2.0]))
    nxt = (v.to(torch.bfloat16).float() + sp).to(torch.bfloat16).float()
    assert torch.equal(nxt - v, sp)             # exactly one bf16 step
    row = {"shape": "qwen2_ffn_in", "M": 2048, "K": 1536, "N": 8960,
           "dtype": "float32", "max_abs_err": 1e-3, "max_err_of_largest": 2e-6,
           "ms": 1.3, "plain_ms": 1.2, "library_ms": 1.2, "library": "mm",
           "bound_ms": 0.84, "bound_by": "operations"}
    bf = {"shape": "4x4x4", "M": 4, "K": 4, "N": 4, "dtype": "bfloat16",
          "max_abs_err": 0.5, "max_err_of_allowance": 1.0}
    e = cs.gemm_entry([row, bf], 69, 0)
    for k in ("name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms"):
        assert k in e
    assert e["replaces"] == "src/repro/kernels/conv3d/conv3d.py:56"
    assert os.path.exists(os.path.join(os.path.dirname(__file__), os.pardir,
                                       e["source"]))
    assert e["max_err_of_bf16_allowance"] == 1.0 and len(e["by_shape"]) == 1
    x = torch.ones((2, 3))
    call, label = cs.library_gemm(x, torch.ones((3, 4)), torch.float32)
    assert label.startswith("torch.matmul") and torch.equal(
        call(), torch.full((2, 4), 3.0))


@pytest.mark.parametrize("dtype,off,ok", [
    (torch.float32, 0.9, True), (torch.float32, 1.1, False),
    (torch.bfloat16, 1.0, True), (torch.bfloat16, 2.0, False)])
def test_gemm_err_holds_the_stated_tolerance(dtype, off, ok):
    """f32: ``off`` x GEMM_TOL of the largest |output|; bf16: ``off`` bf16
    spacings at a value far below the largest (1e-5 of 256 is under one
    spacing at 16), where one spacing passes and two fail."""
    want = torch.tensor([256.0, -16.0, 0.0]).to(dtype)
    step = (GEMM_TOL * 256.0 if dtype == torch.float32
            else float(bf16_spacing(torch.tensor(16.0))))
    got = want.float() + torch.tensor([0.0, off * step, 0.0])
    err, within = gemm_err(got.to(dtype), want)
    assert within == ok, err
