"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels (``conv3d_fwd``, ``conv3d_dw``,
   ``flash_chunk``, ``flash_decode``, ``flash_fwd``, ``flash_bwd``,
   ``ssd_fwd``, ``ssd_bwd``, ``gemm``: nine sources) from
   ``src/repro_torch/kernels/*/csrc`` into ``build/kernels/``, one nvcc
   per source, all at once, and prints the build time;
3. forward: holds the conv3d kernel, through the public entry points
   ``conv3d_fwd`` / ``conv3d_transpose_fwd``, against their plain PyTorch
   versions at the eight conv geometries of the full ``calo3dgan.config()``
   at batch 128 (four generator, four discriminator), in f32 and bf16 with
   TF32 off, and times kernel, plain version and one cuDNN call;
   gemm: the standalone tiled GEMM through the public ``gemm`` against
   ``ref.gemm_ref`` in f32, bf16 and bf16 in with f32 out, at the JAX
   package's test shapes, shapes one off its tiles, K = 1, rows that break
   16-byte alignment and the full-width GEMMs of the models the port runs
   (qwen2-1.5b's FFN in and out, zamba2-1.2b's in_proj, the 3DGAN's fc):
   counts set to 0 just before the calls, read just after (one launch a
   call), a second call bit for bit, and at full width kernel, plain and
   the library call (``torch.matmul``; ``torch.mm(out_dtype=)`` for bf16
   in, f32 out) timed beside the bound;
4. gradients: the same eight layers through ``conv3d_*_dx`` (the forward
   kernel on the cotangent) and ``conv3d_*_dw`` (the dw kernel) against
   ``ref.conv3d_*_dx`` / ``ref.conv3d_*_dw``, timed beside the library's
   ``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` (or ``F.conv3d``);
   attention: ``flash_attention_chunk`` and ``flash_decode`` against
   their plain versions at the LM path's shapes (8 slots, a 1024-position
   cache, chunks of 128, qwen2-1.5b heads) in f32 and bf16 on N(0, 1)
   inputs, timed beside one ``scaled_dot_product_attention`` call, and
   the decode kernel's device time by split count;
5. serving: a window of full-width requests through ``SimulateEngine``
   (the serving main path: launch counts reset just before, read just
   after) with its checks (exact event counts, finite non-negative
   showers, 4 launches per bucket step, packing invariance, agreement
   with the plain-version generator on the CPU), two more windows for
   the spread of events/s, an open-loop run for latency, and one
   profiled bucket-128 step;
6. training: one full-width f32 step on the card against the CPU's
   plain route from the same state and inputs (SGD, gradients and updates
   compared leaf by leaf, LeakyReLU branches counted); then the training
   main path: 2 warm-up and 10 timed steps of ``calo3dgan.config()`` at
   batch 128, bf16, RMSprop 1e-4 through ``Engine.fit`` (counts reset
   just before, read just after: exactly 50 ``conv3d_fwd`` and 16
   ``conv3d_dw`` launches per step); the same step twice, bit for bit;
   the skip-on-nonfinite guard under bf16 and fp16; one profiled step;
7. LM serving: full-width qwen2-1.5b from one seed, one chunk prefill
   and 4 decodes on the card against the CPU's plain route (logits and
   live cache), the same rows rolled one place over fresh cache noise
   (bit for bit), and the same at sharpened attention with the depth cut
   to 4 layers; then the LM main path: 32 requests (prompts 64-512, 32
   new tokens) through ``ServeEngine`` with 8 slots (counts reset just
   before, read just after: exactly 28 ``flash_chunk`` launches per
   prefill launch and 28 ``flash_decode`` launches per decode step), two
   more windows for the spread of generated tok/s, one bf16 window and
   one profiled decode step;
8. LM training: the forward, dq and dk/dv attention kernels against
   their plain versions at the training shapes (batch 8 x seq 256,
   qwen2-1.5b heads, causal) in f32 and bf16 on N(0, 1) inputs (O, lse,
   dq, dk, dv; a second run of each bit for bit), timed beside their
   bounds and ``scaled_dot_product_attention`` (forward; the backward
   alone of a saved forward, and forward + backward); one training step
   card vs CPU at full width with the depth
   cut to 2 layers (loss, grad norm, every gradient and AdamW update
   leaf); then the LM training main path: full-width qwen2-1.5b from seed
   0 through ``Engine.fit`` on ``lm_task`` (f32, AdamW on warmup-cosine,
   clip 1.0, remat, batch 8 x seq 256; counts reset just before, read
   just after: exactly 56 ``flash_fwd``, 28 ``flash_bwd_dq`` and 28
   ``flash_bwd_dkv`` launches per step), its step time, tokens/s and peak
   memory, the same step twice bit for bit, and one profiled step;
9. Zamba2 training: the SSD scan's forward and backward kernels against
   their plain versions at the zamba2-1.2b training shapes (batch 8, 64
   heads of P = N = 64, chunks of 128) at S = 256, a ragged 200 and 1024
   (eight chunks) on N(0, 1) inputs (y, final and entry states, dx, dB,
   dC, ddt, dA; a second run of each bit for bit), timed beside their
   bounds; one training step card vs CPU at full width with the depth
   cut to 2 layers; then the Zamba2 training main path: full-width
   zamba2-1.2b from seed 0 through ``Engine.fit`` on ``lm_task`` with
   the same settings (counts reset just before, read just after: exactly
   76 ``ssd_fwd``, 38 ``ssd_bwd``, 14 ``flash_fwd``, 7 ``flash_bwd_dq``
   and 7 ``flash_bwd_dkv`` launches per step), its step time, tokens/s
   and peak memory, the same step twice bit for bit, and one profiled
   step with its device time split among GEMMs, SSD kernels, attention
   kernels and elementwise work;
10. writes every number to ``results/chip_smoke.json``, prints the
   kernels' JSON line (all ten), the card line again, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no ok
line.  It needs a CUDA card and the repository's ``src/`` beside it;
without either it prints one line to stderr and exits 1.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BUCKETS = (8, 32, 128)
BATCH = 128                       # the largest bucket: the layer shapes
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}   # (atol, rtol)
CHECK_SIZES = (1, 7, 45, 130, 3, 64, 19)   # odd sizes; 130 spans two steps
WINDOW_REQUESTS = 240             # closed-batch window (incl. CHECK_SIZES)
WINDOW_REPEATS = 3                # the main run plus two more, for spread
OPEN_LOOP_REQUESTS = 200
OPEN_LOOP_LOAD = 0.6              # offered load, share of measured events/s
DW_TOL = 1e-4                     # dw: max abs err / largest |dw| (f32 sums)
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
CHECK_BATCH = 8                   # card-vs-CPU step: full width, small batch
# card vs CPU, each gradient and param-update leaf against its largest
# magnitude: GRAD_TOL; KINK_TOL for a leaf upstream of a LeakyReLU whose
# branch the two sides took differently at some element (f32 rounding
# decides the branch of an input within KINK_NEAR of the spread of zero,
# and the flip moves that element's slope from 1 to 0.2 in one phase's
# backward); the losses to LOSS_TOL.  A leaf is measured against no less
# than FLOOR of its phase's largest gradient: a leaf whose terms cancel
# (D on fake's angle/b is 0.1/8 times eight signs, four each way: zero in
# exact arithmetic) holds only a residue of a few ulp of its terms, which
# no relative bound can take, and FLOOR * GRAD_TOL = 1e-9 of the phase's
# largest is a fraction of one ulp of it.
GRAD_TOL, KINK_TOL, KINK_NEAR, LOSS_TOL, FLOOR = 1e-4, 1e-2, 1e-5, 1e-5, 1e-5
# LM serving (full qwen2-1.5b): 8 slots, a 1024-position cache, prefill
# chunks of 128; windows of 32 requests (prompts 64-512, 32 new tokens)
LM_SLOTS, LM_MAX_LEN, LM_CHUNK = 8, 1024, 128
LM_REQUESTS, LM_NEW, LM_WINDOWS = 32, 32, 3
# attention kernel vs plain (atol, rtol): f32 sums in another order; bf16
# one rounding of the same f32 result to bf16
TOL_ATTN = {"float32": (1e-5, 0.0), "bfloat16": (1e-2, 1e-2)}
# LM card vs CPU: logits and live cache, of their largest magnitude
LM_TOL = 1e-4
# the sharp-attention check: wq and wk scaled by LM_SHARP, depth cut to
# LM_SHARP_LAYERS of the 28 layers (the CPU side runs it too)
LM_SHARP, LM_SHARP_LAYERS = 4.0, 4
# LM training (full qwen2-1.5b, the reference launcher's settings): f32,
# AdamW on warmup_cosine(LMT_LR, 20, steps), clip 1.0, remat, batch
# LMT_BATCH x seq LMT_SEQ; LMT_WARMUP + LMT_STEPS steps through Engine.fit
LMT_BATCH, LMT_SEQ, LMT_LR = 8, 256, 1e-4
LMT_WARMUP, LMT_STEPS = 2, 8
# training attention kernels vs plain, of each output's largest magnitude:
# f32 sums in another order; bf16 one rounding of the same f32 result
TOL_TRAIN_ATTN = {"float32": 1e-5, "bfloat16": 1e-2}
# the LM step card vs CPU: full width, depth cut to LMT_CHECK_LAYERS (the
# CPU side sets the cut), batch LMT_CHECK_BATCH x seq LMT_CHECK_SEQ.  f32
# on both sides, sums in another order: loss and grad norm to LMT_LOSS_TOL
# relative, each gradient leaf to LMT_GRAD_TOL of its largest.  Each AdamW
# update element (new param minus param) to LMT_UPD_TOL of its leaf's
# largest, plus one f32 spacing at the param (the two sides' p + u may
# round to neighbours), plus what the two sides' (clipped) gradients a, b
# make of it through Adam's first step -lr * (g / (|g| + eps) + wd * p):
# f(g) = g / (|g| + eps) has slope eps / (|g| + eps)^2, so |f(a) - f(b)| <=
# eps |a - b| / (d + eps)^2 with d the distance from 0 to [a, b] (0 when
# the signs differ).  Where |g| is near eps = 1e-8 that step takes any
# value in (-lr, lr), and there the last bits of the gradient's sums
# decide it.
LMT_CHECK_LAYERS, LMT_CHECK_BATCH, LMT_CHECK_SEQ = 2, 2, 128
LMT_LOSS_TOL, LMT_GRAD_TOL, LMT_UPD_TOL, ADAM_EPS = 1e-5, 1e-4, 1e-3, 1e-8
F32_SPACING = 2.0 ** -23          # f32 spacing at x is at most this * |x|
# the SSD scan kernels vs plain at the zamba2-1.2b training shapes (batch
# LMT_BATCH, 64 heads of P = N = 64, chunks of ops.CHUNK = 128) at three
# sequence lengths: the path's, a ragged one and many chunks.  Each output
# to TOL_SSD of the larger of its largest magnitude and 1 (f32 sums in
# another order; the backward's dla is a reverse cumsum of terms that
# cancel, and dA sums dt * dla over every position)
SSD_SEQS = (LMT_SEQ, 200, 1024)
TOL_SSD = {"ssd_fwd": 1e-5, "ssd_bwd": 1e-4}
# the training kernels whose launches the LM training paths count
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ssd_fwd",
                 "ssd_bwd")
# the standalone GEMM vs plain: by ``ref.gemm_err`` (an f32 output to 1e-5
# of the case's largest |output|, a bf16 output to one bf16 spacing plus
# 1e-5 of the largest), and bit for bit the kernel's own f32 output rounded
# to bf16.  The shapes besides the models' full-width ones: the JAX
# package's test shapes, the kernel's 128 x 128 tile and its K steps (16
# f32, 32 bf16) straddled by one, K = 1, and rows that break 16-byte
# alignment; ``tests/test_torch_cuda.py`` runs the same
GEMM_CHECK_SHAPES = (
    (128, 128, 128), (100, 70, 50), (300, 200, 150), (1, 1, 1),
    (128, 256, 64),                                     # the JAX tests
    (127, 128, 128), (129, 128, 128), (128, 127, 128),
    (128, 129, 128), (128, 128, 127), (128, 128, 129),
    (127, 127, 127), (129, 129, 129),                   # the tile +- 1
    (130, 15, 131), (100, 17, 50), (64, 31, 200), (64, 33, 200),
    (64, 1, 96), (5, 1, 7),                             # K steps, K = 1
    (65, 66, 67), (96, 36, 132), (257, 129, 130))       # unaligned


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, min_total_ms=50.0, max_reps=200):
    """Mean device time of ``fn()`` by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    reps, total = 0, 0.0
    while total < min_total_ms and reps < max_reps:
        n = 1 if reps == 0 else 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        reps += n
    return total / reps


def nearest_rank(values, q):
    """The q-quantile of ``values`` by nearest rank (q=1 is the maximum)."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


# ---------------------------------------------------------------------------
# the layer geometries and their yardsticks
# ---------------------------------------------------------------------------


def layer_geometries(cfg):
    """(name, x shape, w shape, stride, transpose, activation) of every conv
    of the full generator and discriminator at batch (bucket) 128."""
    from repro_torch.core.gan import _start_dims
    chs = cfg.gen_channels
    ups = len(chs) - 1
    dims = _start_dims(cfg.image_shape, ups)
    out = []
    for i in range(ups):
        out.append((f"gen_up{i}", (BATCH, *dims, chs[i]),
                    (3, 3, 3, chs[i], chs[i + 1]), 2, True, "none"))
        dims = tuple(2 * d for d in dims)
    out.append(("gen_out", (BATCH, *cfg.image_shape, chs[-1]),
                (3, 3, 3, chs[-1], 1), 1, False, "softplus"))
    dims, c_in = tuple(cfg.image_shape), 1
    for i, c in enumerate(cfg.disc_channels):
        out.append((f"disc_conv{i}", (BATCH, *dims, c_in),
                    (3, 3, 3, c_in, c), 2, False, "none"))
        dims, c_in = tuple(-(-d // 2) for d in dims), c
    return out


def per_step(rows, counts, kinds, dtype="bfloat16"):
    """Sum of ``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` over the
    launches of one training step: each row of ``dtype`` whose kind is in
    ``kinds``, weighted by its launches per step.  ``bound_by`` names the
    side holding the larger part of the bound."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "launches": 0}
    by = {"operations": 0.0, "bytes": 0.0}
    for r in rows:
        n = counts.get((r["layer"], r["kind"]), 0)
        if r["dtype"] != dtype or r["kind"] not in kinds or not n:
            continue
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[k] += n * r[k]
        tot["launches"] += n
        by[r["bound_by"]] += n * r["bound_ms"]
    tot["bound_by"] = max(by, key=by.get)
    return tot


def useful_macs(x_shape, w_shape, stride, transpose):
    """Multiply-adds on real input elements of the SAME conv (or SAME
    transposed conv): taps that land on a dilation zero or on padding are
    not counted."""
    from repro_torch.kernels.conv3d.conv3d import same_pads, transpose_pads
    taps = 1
    for L, k in zip(x_shape[1:4], w_shape[:3]):
        if transpose:      # input dilated by the stride, then stride 1
            lo, s, dil, outs = transpose_pads(k, stride)[0], 1, stride, \
                L * stride
        else:
            lo, _, outs = same_pads(L, k, stride)
            s, dil = stride, 1
        ld = (L - 1) * dil + 1
        taps *= sum(1 for o in range(outs) for j in range(k)
                    if 0 <= o * s + j - lo < ld and (o * s + j - lo) % dil == 0)
    return x_shape[0] * x_shape[4] * w_shape[4] * taps


def layer_bound(macs, nbytes, dname):
    """(bound ms, "operations" | "bytes") of one launch: the larger of its
    useful operations over the peak rate and its bytes over HBM's rate."""
    t_ops = 2 * macs / PEAK_OPS_PER_S[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def kernel_entry(rows, launches):
    """The conv kernel's line of the ``kernels`` JSON: one bucket-128
    generator pass in f32, its four launches summed.  Its bound is the sum
    of the launches' own bounds (they run one after another); ``bound_by``
    names the side that holds the larger part of that sum."""
    main = [r for r in rows if r["dtype"] == "float32"
            and r["layer"].startswith("gen_") and r["kind"] == "fwd"]
    by = {"operations": 0.0, "bytes": 0.0}
    for r in main:
        by[r["bound_by"]] += r["bound_ms"]
    return {
        "name": "conv3d_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/conv3d/csrc/conv3d_fwd.cu",
        "replaces": "src/repro/kernels/conv3d/conv3d.py:174",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": max(by, key=by.get),
        "library_ms": sum(r["library_ms"] for r in main),
    }


def library_conv(x, w, b, *, stride, transpose, activation):
    """One cuDNN call computing the same function as the kernel (timed as a
    yardstick only; the port never calls it).  The transposed conv is
    ``F.conv_transpose3d`` with the kernel flipped and ci/co swapped, whose
    output is one element longer per dim than the SAME rule keeps; the
    forward conv pads the input first where the SAME pads are
    asymmetric."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv3d.conv3d import same_pads
    xc = x.permute(0, 4, 1, 2, 3)          # NCDHW view of NDHWC memory
    if transpose:
        wt = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
        y = F.conv_transpose3d(xc, wt, b, stride=stride)
        D, H, W = (stride * s for s in x.shape[1:4])
        y = y[:, :, :D, :H, :W]
    else:
        pads = [same_pads(L, k, stride)[:2]
                for L, k in zip(x.shape[1:4], w.shape[:3])]
        if any(lo != hi for lo, hi in pads):   # F.conv3d pads symmetrically
            (dl, dh), (hl, hh), (wl, wh) = pads
            xc = F.pad(xc, (wl, wh, hl, hh, dl, dh))
            pads = [(0, 0)] * 3
        y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), b, stride=stride,
                     padding=tuple(lo for lo, _ in pads))
    if activation == "softplus":
        y = F.softplus(y)
    elif activation == "leaky_relu":
        y = F.leaky_relu(y, 0.2)
    return y.permute(0, 2, 3, 4, 1)


def kernel_phase(cfg):
    """Kernel vs plain version (and the cuDNN yardstick) per layer and
    dtype, through the public entry points; returns the rows."""
    import torch
    from repro_torch.kernels.conv3d import conv3d as conv_mod
    from repro_torch.kernels.conv3d import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, xs, ws, stride, transpose, act in layer_geometries(cfg):
        fwd = (conv_mod.conv3d_transpose_fwd if transpose
               else conv_mod.conv3d_fwd)
        fwd_ref = (ref.conv3d_transpose_bias_act_ref if transpose
                   else ref.conv3d_bias_act_ref)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            w = 0.05 * torch.randn(ws, generator=gen, device="cuda")
            b = 0.1 * torch.randn((ws[-1],), generator=gen, device="cuda")
            wd, bd = w.to(dtype), b.to(dtype)

            def kern():
                return fwd(x, wd, bd, stride, activation=act)

            def plain():
                return fwd_ref(x, wd, bd, stride, activation=act)

            def lib():
                return library_conv(x, wd, bd, stride=stride,
                                    transpose=transpose, activation=act)

            yk, yp, yl = kern(), plain(), lib()
            torch.cuda.synchronize()
            check(yk.shape == yp.shape == yl.shape,
                  f"{name}: shapes {yk.shape} {yp.shape} {yl.shape}")
            atol, rtol = TOL[dname]
            diff = (yk.float() - yp.float()).abs()
            max_abs = float(diff.max())
            max_rel = float((diff / yp.float().abs().clamp_min(1e-6)).max())
            ok = bool((diff <= atol + rtol * yp.float().abs()).all())
            lib_diff = (yk.float() - yl.float()).abs()
            lib_ok = bool((lib_diff <= atol + rtol * yl.float().abs()).all())
            ms_k, ms_p, ms_l = cuda_ms(kern), cuda_ms(plain), cuda_ms(lib)
            macs = useful_macs(xs, ws, stride, transpose)
            nbytes = (x.numel() + wd.numel() + bd.numel() + yk.numel()) \
                * x.element_size()
            bound_ms, bound_by = layer_bound(macs, nbytes, dname)
            row = {"layer": name, "kind": "fwd", "dtype": dname,
                   "x": list(xs),
                   "w": list(ws), "stride": stride, "transpose": transpose,
                   "activation": act, "max_abs_err": max_abs,
                   "max_rel_err": max_rel, "atol": atol, "rtol": rtol,
                   "library_max_abs_err": float(lib_diff.max()),
                   "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "useful_gflop": 2 * macs / 1e9, "mbytes": nbytes / 1e6}
            rows.append(row)
            print(f"  {name:10s} {dname:8s} max_abs={max_abs:.3e} "
                  f"max_rel={max_rel:.3e} (atol {atol}, rtol {rtol}) "
                  f"kernel_ms={ms_k:.4f} plain_ms={ms_p:.4f} "
                  f"library_ms={ms_l:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by})", flush=True)
            check(ok, f"{name} {dname}: kernel disagrees with the plain "
                      f"version (max abs {max_abs}, max rel {max_rel})")
            check(lib_ok, f"{name} {dname}: cuDNN yardstick disagrees with "
                          f"the kernel (max abs {float(lib_diff.max())})")
            del x, yk, yp, yl
    return rows


# ---------------------------------------------------------------------------
# the standalone GEMM
# ---------------------------------------------------------------------------


def gemm_shapes(gan_cfg, lm_cfg, z_cfg):
    """[(label, M, K, N, full_width)] the gemm phase holds the kernel at:
    GEMM_CHECK_SHAPES and the full-width GEMMs of the models the port runs:
    qwen2-1.5b's FFN in and out at batch 8 x 256, zamba2-1.2b's Mamba2
    in_proj at the same batch, the 3DGAN generator's fc at batch 128."""
    from repro_torch.core.gan import _start_dims
    rows = LMT_BATCH * LMT_SEQ
    d, ff = lm_cfg.d_model, lm_cfg.d_ff
    zs = z_cfg.ssm
    di = zs.expand * z_cfg.d_model
    in_proj = 2 * di + 2 * zs.state_dim + di // zs.head_dim
    d0 = _start_dims(gan_cfg.image_shape, len(gan_cfg.gen_channels) - 1)
    fc = d0[0] * d0[1] * d0[2] * gan_cfg.gen_channels[0]
    out = [(f"{M}x{K}x{N}", M, K, N, False) for M, K, N in GEMM_CHECK_SHAPES]
    out += [("qwen2_ffn_in", rows, d, ff, True),
            ("qwen2_ffn_out", rows, ff, d, True),
            ("zamba2_in_proj", rows, z_cfg.d_model, in_proj, True),
            ("gan_fc", BATCH, gan_cfg.latent_dim + 2, fc, True)]
    return out


def library_gemm(x, w, out_dt):
    """(call, label) of the one PyTorch call that computes what ``gemm``
    computes on (x, w) with an ``out_dt`` output (a yardstick; the port
    never calls it): ``torch.matmul`` where the output keeps the inputs'
    dtype, ``torch.mm(..., out_dtype=)`` for bf16 in, f32 out.  (None, why)
    where the installed torch has no such call."""
    import torch
    dname = "float32" if x.dtype == torch.float32 else "bfloat16"
    if out_dt == x.dtype:
        return (lambda: torch.matmul(x, w),
                f"torch.matmul in {dname}, {dname} out (cuBLAS, TF32 off)")
    try:
        y = torch.mm(x[:1, :1], w[:1, :1], out_dtype=out_dt)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        return None, f"none: torch.mm(out_dtype=) is not here ({e})"[:160]
    if y.dtype != out_dt:
        return None, f"none: torch.mm(out_dtype=) gave {y.dtype}"
    return (lambda: torch.mm(x, w, out_dtype=out_dt),
            f"torch.mm in {dname}, out_dtype float32 (cuBLAS)")


def gemm_phase(shapes):
    """The standalone GEMM through the public ``gemm`` against ``gemm_ref``
    at every shape of ``shapes``, f32, bf16 and bf16 in with f32 out, on
    N(0, 1) inputs (TF32 off).  First every case once (the entry point's
    run: counts set to 0 just before, read just after, exactly one launch
    a call), then each held to ``ref.gemm_err``, a second call bit for bit,
    and at the full-width shapes kernel, plain and the library call of
    ``library_gemm`` timed beside the bound.  Returns (rows, launches)."""
    import torch
    from repro_torch.kernels.conv3d import conv3d as conv_mod
    from repro_torch.kernels.conv3d import gemm
    from repro_torch.kernels.conv3d.ref import GEMM_TOL, gemm_err, gemm_ref
    gen = torch.Generator(device="cuda").manual_seed(29)
    kinds = (("float32", torch.float32, torch.float32),
             ("bfloat16", torch.bfloat16, torch.bfloat16),
             ("bfloat16->float32", torch.bfloat16, torch.float32))
    inputs = {}
    for label, M, K, N, full in shapes:
        xf = torch.randn((M, K), generator=gen, device="cuda")
        wf = torch.randn((K, N), generator=gen, device="cuda")
        inputs[label] = {dt: (xf.to(dt), wf.to(dt))
                         for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    outs = {}
    conv_mod.GEMM_LAUNCHES = 0
    for label, M, K, N, full in shapes:
        for kind, dt, out_dt in kinds:
            n0 = conv_mod.GEMM_LAUNCHES
            outs[label, kind] = gemm(*inputs[label][dt], out_dtype=out_dt)
            check(conv_mod.GEMM_LAUNCHES == n0 + 1,
                  f"gemm {label} {kind}: {conv_mod.GEMM_LAUNCHES - n0} "
                  f"launches for one call")
    torch.cuda.synchronize()
    launches = conv_mod.GEMM_LAUNCHES
    check(launches == len(shapes) * len(kinds),
          f"gemm: {launches} launches for {len(shapes) * len(kinds)} calls")
    rows = []
    for label, M, K, N, full in shapes:
        for kind, dt, out_dt in kinds:
            x, w = inputs[label][dt]
            y = outs.pop((label, kind))
            want = gemm_ref(x, w, out_dt)
            again = gemm(x, w, out_dtype=out_dt)
            torch.cuda.synchronize()
            err, ok = gemm_err(y, want)
            rounded = True
            if out_dt == torch.bfloat16:   # the rounding, bit for bit
                rounded = torch.equal(y, outs[label, "bfloat16->float32"].to(
                    torch.bfloat16))
            same = torch.equal(y, again)
            row = {"shape": label, "M": M, "K": K, "N": N, "dtype": kind,
                   "max_abs_err": float((y.float() - want.float()).abs().max()),
                   "largest": float(want.float().abs().max()),
                   ("max_err_of_largest" if out_dt == torch.float32
                    else "max_err_of_allowance"): err,
                   "repeat_identical": same}
            if full:
                dname = "float32" if dt == torch.float32 else "bfloat16"
                nbytes = (M * K + K * N) * x.element_size() \
                    + M * N * y.element_size()
                bound, by = layer_bound(M * N * K, nbytes, dname)
                lib, lib_label = library_gemm(x, w, out_dt)
                row.update(
                    ms=cuda_ms(lambda: gemm(x, w, out_dtype=out_dt)),
                    plain_ms=cuda_ms(lambda: gemm_ref(x, w, out_dt)),
                    library_ms=None if lib is None else cuda_ms(lib),
                    library=lib_label,
                    bound_ms=bound, bound_by=by, gflop=2 * M * N * K / 1e9,
                    mbytes=nbytes / 1e6)
                if lib is not None:     # recorded, not held: a yardstick
                    row["library_err"] = gemm_err(lib(), want)[0]
                lib_ms = ("none" if lib is None
                          else f"{row['library_ms']:.4f}")
                print(f"  {label:14s} ({M}, {K}) @ ({K}, {N}) {kind:17s} "
                      f"err {err:.2e} kernel_ms={row['ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"library_ms={lib_ms} "
                      f"bound_ms={bound:.4f} ({by})", flush=True)
            rows.append(row)
            check(ok and rounded,
                  f"gemm {label} {kind}: kernel disagrees with plain "
                  f"(error {err:.3e}; the bf16 output is the rounding "
                  f"of the kernel's f32 output: {rounded})")
            check(same, f"gemm {label} {kind}: a second call differs")
            del y, want, again
    worst = max(r.get("max_err_of_largest", 0.0) for r in rows)
    spac = max(r.get("max_err_of_allowance", 0.0) for r in rows)
    print(f"  {len(rows)} cases: f32 outputs within {worst:.2e} of their "
          f"largest (tolerance {GEMM_TOL}), bf16 outputs within {spac:.2f} "
          f"of one spacing + {GEMM_TOL} of the largest (tolerance 1) and "
          f"bf16 in / bf16 out the rounding of the kernel's f32 output, bit "
          f"for bit; every repeat bit-identical; {launches} launches for "
          f"{launches} calls", flush=True)
    # launches made to compare and time are not the entry point's run
    conv_mod.GEMM_LAUNCHES = 0
    return rows, launches


def gemm_entry(rows, launches, model_launches):
    """The kernels-line entry of the standalone GEMM: its f32 row at
    qwen2-1.5b's FFN-in shape, every full-width row beside it, and the
    worst errors over every case."""
    r = next(r for r in rows if r["shape"] == "qwen2_ffn_in"
             and r["dtype"] == "float32")
    keys = ("shape", "M", "K", "N", "dtype", "ms", "plain_ms", "library_ms",
            "library", "bound_ms", "bound_by")
    return {"name": "gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/conv3d/csrc/gemm.cu",
            "replaces": "src/repro/kernels/conv3d/conv3d.py:56",
            "launches": launches, "launches_on_model_paths": model_launches,
            "max_abs_err": r["max_abs_err"],
            "max_err_of_largest": max(x.get("max_err_of_largest", 0.0)
                                      for x in rows),
            "max_err_of_bf16_allowance": max(
                x.get("max_err_of_allowance", 0.0) for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r["library"],
            "by_shape": [{k: x[k] for k in keys} for x in rows if "ms" in x],
            "timed": "one f32 call at (2048, 1536) @ (1536, 8960)"}


# ---------------------------------------------------------------------------
# gradients: dx (the forward kernel) and dw (the dw kernel) per layer
# ---------------------------------------------------------------------------


def _ncdhw(t):
    return t.permute(0, 4, 1, 2, 3)


def library_dx(x_shape, w, g, *, stride, transpose):
    """dx by one library call (a yardstick; the port never calls it).  SAME
    conv: ``torch.nn.grad.conv3d_input`` over the padded input, cropped.
    SAME transposed conv (``F.conv_transpose3d`` with the kernel flipped,
    ci/co swapped, its output cropped at the end): dx is ``F.conv3d`` of
    the cotangent zero-extended to the uncropped size."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv3d.conv3d import same_pads
    if transpose:
        wt = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
        g_full = F.pad(_ncdhw(g), (0, 1, 0, 1, 0, 1))
        return F.conv3d(g_full, wt, stride=stride).permute(0, 2, 3, 4, 1)
    pads = [same_pads(L, k, stride)[:2]
            for L, k in zip(x_shape[1:4], w.shape[:3])]
    size = (x_shape[0], x_shape[4], *(L + lo + hi for L, (lo, hi)
                                      in zip(x_shape[1:4], pads)))
    dxp = torch.nn.grad.conv3d_input(size, w.permute(4, 3, 0, 1, 2),
                                     _ncdhw(g), stride=stride)
    (dl, _), (hl, _), (wl, _) = pads
    D, H, W = x_shape[1:4]
    return dxp[:, :, dl:dl + D, hl:hl + H, wl:wl + W].permute(0, 2, 3, 4, 1)


def library_dw_operands(x, g, *, stride, transpose):
    """The (input, grad_output) that ``torch.nn.grad.conv3d_weight`` takes
    for this layer's dw, made once before timing: the padded input and g
    (SAME conv), or the zero-extended g and x (transposed conv)."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv3d.conv3d import same_pads
    if transpose:
        return F.pad(_ncdhw(g), (0, 1, 0, 1, 0, 1)), _ncdhw(x)
    pads = [same_pads(L, 3, stride)[:2] for L in x.shape[1:4]]
    (dl, dh), (hl, hh), (wl, wh) = pads
    return F.pad(_ncdhw(x), (wl, wh, hl, hh, dl, dh)), _ncdhw(g)


def library_dw(inp, grad_out, w_shape, *, stride, transpose):
    """dw by ``torch.nn.grad.conv3d_weight`` (a yardstick), as DHWIO."""
    import torch
    KD, KH, KW, Ci, Co = w_shape
    if transpose:      # the weight of conv(g; W'), W' = flipped, swapped w
        dwt = torch.nn.grad.conv3d_weight(inp, (Ci, Co, KD, KH, KW),
                                          grad_out, stride=stride)
        return dwt.permute(2, 3, 4, 0, 1).flip(0, 1, 2)
    dwc = torch.nn.grad.conv3d_weight(inp, (Co, Ci, KD, KH, KW), grad_out,
                                      stride=stride)
    return dwc.permute(2, 3, 4, 1, 0)


def grad_phase(cfg):
    """dx and dw kernels vs their plain versions (and the library
    yardstick) per layer and dtype, through the public entry points;
    returns the rows (``kind`` "dx" / "dw")."""
    import torch
    from repro_torch.kernels.conv3d import conv3d as conv_mod
    from repro_torch.kernels.conv3d import ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, xs, ws, stride, transpose, _act in layer_geometries(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            w = (0.05 * torch.randn(ws, generator=gen, device="cuda")
                 ).to(dtype)
            fwd = (ref.conv3d_transpose_bias_act_ref if transpose
                   else ref.conv3d_bias_act_ref)
            ys = fwd(x[:1], w, None, stride).shape[1:]
            g = torch.randn((xs[0], *ys), generator=gen,
                            device="cuda").to(dtype)
            if transpose:
                dx_k = lambda: conv_mod.conv3d_transpose_dx(g, w, stride)
                dx_p = lambda: ref.conv3d_transpose_dx(g, w, stride)
                dw_k = lambda: conv_mod.conv3d_transpose_dw(
                    x, g, ws[:3], stride)
                dw_p = lambda: ref.conv3d_transpose_dw(x, g, ws[:3], stride)
            else:
                dx_k = lambda: conv_mod.conv3d_dx(g, w, stride, xs[1:4])
                dx_p = lambda: ref.conv3d_dx(g, w, stride, xs[1:4])
                dw_k = lambda: conv_mod.conv3d_dw(x, g, ws[:3], stride)
                dw_p = lambda: ref.conv3d_dw(x, g, ws[:3], stride)
            dx_l = lambda: library_dx(xs, w, g, stride=stride,
                                      transpose=transpose)
            lib_in, lib_go = library_dw_operands(x, g, stride=stride,
                                                 transpose=transpose)
            dw_l = lambda: library_dw(lib_in, lib_go, ws, stride=stride,
                                      transpose=transpose)
            # the yardstick's formula, checked on operands upcast to f32
            # (cuDNN's own bf16 rounding is not what is being checked)
            xf, wf, gf = x.float(), w.float(), g.float()
            lib_dx32 = library_dx(xs, wf, gf, stride=stride,
                                  transpose=transpose)
            lib_dw32 = library_dw(*library_dw_operands(
                xf, gf, stride=stride, transpose=transpose), ws,
                stride=stride, transpose=transpose)
            plain_dx32 = (ref.conv3d_transpose_dx(gf, wf, stride) if transpose
                          else ref.conv3d_dx(gf, wf, stride, xs[1:4]))
            plain_dw32 = (ref.conv3d_transpose_dw(xf, gf, ws[:3], stride)
                          if transpose else
                          ref.conv3d_dw(xf, gf, ws[:3], stride))
            for kind, kern, plain, lib, lib32, plain32 in (
                    ("dx", dx_k, dx_p, dx_l, lib_dx32, plain_dx32),
                    ("dw", dw_k, dw_p, dw_l, lib_dw32, plain_dw32)):
                yk, yp = kern(), plain()
                torch.cuda.synchronize()
                check(yk.shape == yp.shape == lib32.shape,
                      f"{name} {kind}: shapes {yk.shape} {yp.shape} "
                      f"{lib32.shape}")
                diff = (yk.float() - yp.float()).abs()
                max_abs = float(diff.max())
                scale = float(yp.float().abs().max())
                if kind == "dx":
                    atol, rtol = TOL[dname]
                    ok = bool((diff <= atol + rtol * yp.float().abs()).all())
                    tol_txt = f"atol {atol}, rtol {rtol}"
                else:
                    ok = max_abs <= DW_TOL * scale
                    tol_txt = f"{DW_TOL} of max |dw| {scale:.4g}"
                lib_err = float((lib32 - plain32).abs().max())
                lib_ok = lib_err <= 1e-4 * (1.0 + float(plain32.abs().max()))
                ms_k, ms_p, ms_l = cuda_ms(kern), cuda_ms(plain), cuda_ms(lib)
                macs = useful_macs(xs, ws, stride, transpose)
                if kind == "dx":
                    nbytes = (g.numel() + w.numel() + x.numel()) \
                        * x.element_size()
                else:    # read x and g once, write dw (f32) once
                    nbytes = (x.numel() + g.numel()) * x.element_size() \
                        + 4 * w.numel()
                bound_ms, bound_by = layer_bound(macs, nbytes, dname)
                rows.append({
                    "layer": name, "kind": kind, "dtype": dname,
                    "x": list(xs), "w": list(ws), "stride": stride,
                    "transpose": transpose, "max_abs_err": max_abs,
                    "max_abs_ref": scale, "library_f32_err": lib_err,
                    "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "useful_gflop": 2 * macs / 1e9, "mbytes": nbytes / 1e6})
                print(f"  {name:10s} {dname:8s} {kind} max_abs={max_abs:.3e} "
                      f"({tol_txt}) kernel_ms={ms_k:.4f} plain_ms={ms_p:.4f} "
                      f"library_ms={ms_l:.4f} bound_ms={bound_ms:.4f} "
                      f"({bound_by}); library formula vs plain (f32 "
                      f"operands) {lib_err:.2e}", flush=True)
                check(ok, f"{name} {dname} {kind}: kernel disagrees with "
                          f"the plain version (max abs {max_abs})")
                check(lib_ok, f"{name} {kind}: the library yardstick is "
                              f"not the same function (max abs {lib_err})")
                del yk, yp
            del x, w, g, lib_in, lib_go
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# serving end to end
# ---------------------------------------------------------------------------


def request_sizes(n, seed, check_first=True):
    """``n`` request sizes: ``CHECK_SIZES`` first (unless not
    ``check_first``), the rest drawn uniformly from 1..96 by ``seed``."""
    head = list(CHECK_SIZES) if check_first else []
    rng = np.random.default_rng(seed)
    return head + [int(s) for s in rng.integers(1, 97, n - len(head))]


def make_requests(sizes, seed):
    from repro_torch.serve.simulate import SimRequest
    rng = np.random.default_rng(seed)
    energies = rng.uniform(10.0, 500.0, len(sizes))
    return [SimRequest(rid=i, primary_energy=float(e), n_events=n,
                       seed=1000 + i)
            for i, (n, e) in enumerate(zip(sizes, energies))]


def closed_window(cfg, params, reference, sizes, label):
    """Submit every request at once, serve until the queue drains; return
    (engine, requests, seconds, gate)."""
    import torch
    from repro_torch.serve.simulate import PhysicsGate, SimulateEngine
    gate = PhysicsGate(reference, window=256)
    eng = SimulateEngine(cfg, params, buckets=BUCKETS, gate=gate,
                         device="cuda")
    reqs = make_requests(sizes, seed=7)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_ev = eng.stats["events_generated"]
    print(f"  {label}: {len(reqs)} requests / {n_ev} events in {dt:.3f} s: "
          f"{n_ev / dt:.1f} events/s, steps={eng.stats['bucket_steps']}",
          flush=True)
    return eng, reqs, dt, gate


def open_loop(cfg, params, sizes, rate_rps, seed):
    """Poisson arrivals at ``rate_rps``; one bucket step at a time.  Each
    latency runs from the request's scheduled arrival to its images on the
    host (a request that arrives during a step is submitted after it, and
    that wait is counted)."""
    import torch
    from repro_torch.serve.simulate import SimulateEngine
    eng = SimulateEngine(cfg, params, buckets=BUCKETS, device="cuda")
    reqs = make_requests(sizes, seed=seed)
    arrive = np.cumsum(np.random.default_rng(seed).exponential(
        1.0 / rate_rps, len(reqs)))
    late = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while i < len(reqs) or eng.scheduler.queue_depth():
        now = time.perf_counter() - t0
        while i < len(reqs) and arrive[i] <= now:
            late[reqs[i].rid] = now - arrive[i]
            eng.submit(reqs[i])
            i += 1
        if eng.scheduler.queue_depth():
            eng.run(max_steps=1)
        elif i < len(reqs):
            time.sleep(max(0.0, arrive[i] - (time.perf_counter() - t0)))
    dt = time.perf_counter() - t0
    check(all(r.status == "done" for r in reqs), "open loop: not all served")
    return [r.latency_s + late[r.rid] for r in reqs], dt, \
        eng.stats["events_generated"]


def e2e_phase(cfg, card):
    import torch
    from repro_torch.convert import generator_from_numpy, generator_to_numpy
    from repro_torch.core import gan, validation
    from repro_torch.data.calo import CaloSimulator, CaloSpec
    from repro_torch.kernels.conv3d import conv3d as conv_mod
    from repro_torch.serve.simulate import SimulateEngine, event_noise

    params = gan.init_generator(torch.Generator().manual_seed(0), cfg, "cuda")
    mc = next(CaloSimulator(CaloSpec(image_shape=cfg.image_shape),
                            seed=1).batches(256))
    reference = validation.reference_profiles(mc["image"], mc["e_p"])
    sizes = request_sizes(WINDOW_REQUESTS, seed=3)

    # warm-up: cuBLAS handles, allocator pools (not measured)
    warm = SimulateEngine(cfg, params, buckets=BUCKETS, device="cuda")
    warm.warmup()
    warm.generate_events(100.0, 40, seed=5)

    # the main path: counts reset just before, read just after
    conv_mod.LAUNCHES = 0
    eng, reqs, dt, gate = closed_window(cfg, params, reference, sizes,
                                        "window 1 (main path)")
    launches = conv_mod.LAUNCHES
    steps = eng.stats["steps"]
    gate.flush()
    n_layers = len(cfg.gen_channels)        # ups + the output conv
    check(launches == n_layers * steps,
          f"{launches} conv kernel launches for {steps} bucket steps "
          f"(want {n_layers} per step)")
    for r in reqs:
        check(r.status == "done" and r.images is not None
              and r.images.shape == (r.n_events, *cfg.image_shape, 1),
              f"request {r.rid}: status {r.status}, images "
              f"{None if r.images is None else r.images.shape}")
        check(bool(np.isfinite(r.images).all()), f"request {r.rid}: nonfinite")
        check(bool((r.images >= 0).all()), f"request {r.rid}: negative")
    print(f"  conv launches={launches} for {steps} steps; gate: "
          f"{gate.latest()}", flush=True)
    check_reqs = reqs[:len(CHECK_SIZES)]
    n_ev = eng.stats["events_generated"]
    runs = [n_ev / dt]
    del eng, reqs

    for k in range(2, WINDOW_REPEATS + 1):
        e, _, t, _ = closed_window(cfg, params, reference, sizes,
                                   f"window {k}")
        runs.append(e.stats["events_generated"] / t)
        del e
    med = float(np.median(runs))
    spread = (max(runs) - min(runs)) / med
    print(f"  events/s over {WINDOW_REPEATS} windows of {len(sizes)} "
          f"requests / {n_ev} events: {[round(v, 1) for v in runs]}, "
          f"median {med:.1f}, spread (max-min)/median {100 * spread:.1f}% "
          f"[{card}]", flush=True)

    # packing invariance: each check request served alone, bit for bit
    for r in check_reqs:
        solo = SimulateEngine(cfg, params, buckets=BUCKETS, device="cuda")
        alone = solo.generate_events(r.primary_energy, r.n_events, r.seed)
        check(np.array_equal(alone, r.images),
              f"request {r.rid} ({r.n_events} events) served alone differs "
              f"from packed: max abs {np.abs(alone - r.images).max()}")
    print(f"  packing invariance: each of {len(check_reqs)} requests "
          f"(sizes {CHECK_SIZES}) alone == packed, bit for bit", flush=True)

    # the engine's showers vs the plain-version generator on the CPU, on
    # the same noise, for every check request (130 spans two steps)
    cpu_params = generator_from_numpy(generator_to_numpy(params), "cpu")
    err, scale = 0.0, 0.0
    for r in check_reqs:
        noise = event_noise([r.seed] * r.n_events, range(r.n_events),
                            cfg.latent_dim, "cuda", torch.float32).cpu()
        e_p = torch.full((r.n_events,), r.primary_energy)
        theta = torch.full((r.n_events,), r.theta)
        with torch.inference_mode():
            ref = gan.generate(cpu_params, noise, e_p, theta, cfg).numpy()
        err = max(err, float(np.abs(ref - r.images).max()))
        scale = max(scale, float(np.abs(ref).max()))
    print(f"  engine vs plain generator (CPU), {sum(CHECK_SIZES)} events: "
          f"max abs {err:.3e} of max {scale:.3e} (tolerance 1e-4 relative "
          f"to the max)", flush=True)
    check(err <= 1e-4 * scale, f"engine vs plain generator: {err} > "
                               f"1e-4 * {scale}")

    # latency under an open-loop load below the measured throughput
    ol_sizes = request_sizes(OPEN_LOOP_REQUESTS, seed=11, check_first=False)
    rate = OPEN_LOOP_LOAD * med / float(np.mean(ol_sizes))
    lats, ol_dt, ol_ev = open_loop(cfg, params, ol_sizes, rate, seed=13)
    lat = {q: 1e3 * nearest_rank(lats, v)
           for q, v in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99),
                        ("max", 1.0))}
    print(f"  open loop: {len(lats)} requests, Poisson arrivals at "
          f"{rate:.2f} req/s ({OPEN_LOOP_LOAD:.0%} of the median events/s), "
          f"{ol_ev} events in {ol_dt:.3f} s; latency ms (nearest rank of "
          f"{len(lats)}) p50={lat['p50']:.1f} p90={lat['p90']:.1f} "
          f"p99={lat['p99']:.1f} max={lat['max']:.1f} [{card}]", flush=True)
    return {"launches": launches, "steps": steps, "window_requests":
            len(sizes), "window_events": n_ev, "events_per_s_runs": runs,
            "events_per_s_median": med, "events_per_s_spread": spread,
            "open_loop_rate_rps": rate, "open_loop_requests": len(lats),
            "open_loop_events": ol_ev, "latency_ms": lat,
            "engine_vs_plain_max_abs": err}


def device_kernels(prof):
    """[{kernel, count, ms}] of the device activity a torch.profiler run
    saw, largest first (empty when it saw none)."""
    kernels = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append({"kernel": e.key[:90], "count": e.count,
                            "ms": us / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    return kernels


def profile_phase(cfg):
    """One bucket-128 step under torch.profiler: device time by kernel and
    the device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import gan
    from repro_torch.serve.simulate import SimulateEngine

    params = gan.init_generator(torch.Generator().manual_seed(0), cfg, "cuda")
    eng = SimulateEngine(cfg, params, buckets=BUCKETS, device="cuda")
    eng.generate_events(100.0, BATCH, seed=3)           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate_events(100.0, BATCH, seed=4)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy_ms = sum(k["ms"] for k in kernels)
    print(f"  one bucket-{BATCH} step (request of {BATCH} events, "
          f"including its copy to the host): wall {wall_ms:.3f} ms",
          flush=True)
    if not kernels:
        print("  device time: not measured (the profiler saw no device "
              "activity)", flush=True)
        return {"wall_ms": wall_ms, "device_ms": None, "kernels": []}
    print(f"  device busy {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% "
          f"of wall; by kernel:", flush=True)
    for k in kernels[:12]:
        print(f"    {k['ms']:9.3f} ms  x{k['count']:<4d} {k['kernel']}",
              flush=True)
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "kernels": kernels[:12]}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def leaf_items(tree, prefix=""):
    """[(path, tensor)] of a nested dict, None leaves skipped."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaf_items(v, f"{prefix}{k}/")
        elif v is not None:
            out.append((f"{prefix}{k}", v))
    return out


def state_leaves(state):
    """(path, tensor) of every param, optimizer and loss-scale leaf."""
    out = []
    for which in ("g_params", "d_params", "g_opt", "d_opt"):
        out += leaf_items(getattr(state, which), which + "/")
    if state.loss_scale is not None:
        out += [("loss_scale/scale", state.loss_scale.scale),
                ("loss_scale/good_steps", state.loss_scale.good_steps)]
    return out


def leaf_errors(ra, rb):
    """{(group, path): (relative error, largest |b|, max |a - b|, group's
    largest |b|)} of the trees ``ra`` against ``rb`` (one tree per phase,
    or per network), each leaf against its largest magnitude with a floor
    of FLOOR of its group's largest."""
    out = {}
    for ph, (ga, gb) in enumerate(zip(ra, rb)):
        items = list(zip(leaf_items(ga), leaf_items(gb)))
        top = max(float(b.abs().max()) for _, (_, b) in items)
        for (path, a), (_, b) in items:
            big, err = float(b.abs().max()), float((a - b).abs().max())
            out[ph, path] = (err / max(big, FLOOR * top), big, err, top)
    return out


def kink_leaves(cfg, phase, flipped):
    """The layers (leaf path prefixes) whose gradient in ``phase`` passes
    a LeakyReLU that took another branch on the two sides: ``flipped``
    indexes the phase's LeakyReLU calls, in order: D on real, D's (one
    after each conv); D on fake, G's (no gradient: the forward value is
    continuous across the kink), then D's; a G phase, G's (after fc and
    each up-conv), then the frozen D's (a flip there moves every G
    layer)."""
    n_g = len(cfg.gen_channels)
    g_layers = ["fc"] + [f"up{i}" for i in range(n_g - 1)]
    out = set()
    for i in flipped:
        if phase < 2:
            i -= n_g * phase
            if i >= 0:
                out |= {f"conv{k}" for k in range(i + 1)}
        elif i < n_g:
            out |= set(g_layers[:i + 1])
        else:
            out |= set(g_layers) | {"out"}
    return out


def check_step_phase(cfg):
    """One full-width f32 step on the card and on the CPU's plain route
    from the same state and injected inputs, with SGD (an update linear in
    the gradient).  The gradients each phase hands its optimizer, and each
    network's update (new - old params), are compared leaf by leaf, each
    to GRAD_TOL, or to KINK_TOL where a LeakyReLU upstream of it took
    another branch at an input within rounding of zero (recorded: every
    LeakyReLU input of both steps); the losses to LOSS_TOL."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import adversarial
    from repro_torch.data.calo import CaloSimulator, CaloSpec
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate import precision
    from repro_torch.substrate.precision import tree_map
    B = CHECK_BATCH
    batch = next(CaloSimulator(CaloSpec(image_shape=cfg.image_shape),
                               seed=11).batches(B))
    rng = np.random.default_rng(12)
    inputs = [(rng.normal(size=(B, cfg.latent_dim)).astype(np.float32),
               rng.uniform(10.0, 500.0, B).astype(np.float32),
               rng.uniform(math.radians(60), math.radians(120), B)
               .astype(np.float32))
              for _ in range(1 + cfg.gen_steps_per_disc)]
    out = {}
    leaky_relu = F.leaky_relu
    for dev in ("cuda", "cpu"):
        rec, acts, base = [], [], opt_lib.sgd(1e-2)

        def update(g, st, p=None, rec=rec, base=base):
            rec.append(tree_map(lambda t: t.detach().cpu(), g))
            return base.update(g, st, p)

        def recording_leaky_relu(x, *args, acts=acts, **kw):
            acts.append(x.detach().clone())
            return leaky_relu(x, *args, **kw)
        opt = opt_lib.Optimizer(base.init, update)
        state = adversarial.init_state(torch.Generator().manual_seed(5), cfg,
                                       opt, opt, policy=precision.FULL,
                                       device=dev)
        p0 = {w: tree_map(lambda t: t.detach().cpu().clone(),
                          getattr(state, w)) for w in ("g_params", "d_params")}
        step = adversarial.make_fused_step(
            cfg, opt, opt, policy=precision.FULL,
            sample_inputs=lambda i, mb: inputs[i])
        F.leaky_relu = recording_leaky_relu
        try:
            t0 = time.perf_counter()
            new, m = step(state, batch, None)
            if dev == "cuda":
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            F.leaky_relu = leaky_relu
        upd = [tree_map(lambda a, b: a.detach().cpu() - b,
                        getattr(new, w), p0[w])
               for w in ("g_params", "d_params")]
        out[dev] = (rec, upd, {k: float(v) for k, v in m.items()}, ms,
                    [a.cpu() for a in acts])
    (rc, uc, mc, tc, ac), (rp, up, mp, tp, ap) = out["cuda"], out["cpu"]
    check(len(rc) == len(rp) == 2 + cfg.gen_steps_per_disc,
          f"recorded {len(rc)} / {len(rp)} phases")
    # the LeakyReLU branches each side took, phase by phase
    n_g, n_d = len(cfg.gen_channels), len(cfg.disc_channels)
    calls = [n_d] + [n_g + n_d] * (1 + cfg.gen_steps_per_disc)
    check(len(ac) == len(ap) == sum(calls),
          f"{len(ac)} / {len(ap)} LeakyReLU calls, want {sum(calls)}")
    loose, flips, k = [], [], 0
    for ph, n in enumerate(calls):
        flipped = []
        for i in range(n):
            a, b = ac[k + i], ap[k + i]
            flip = (a >= 0) != (b >= 0)
            if bool(flip.any()):
                near = float(b[flip].abs().max()) / float(b.std())
                flips.append(f"phase {ph} LeakyReLU {i}: {int(flip.sum())} "
                             f"at |x| <= {near:.1e} of the spread")
                check(near <= KINK_NEAR, f"card vs CPU: {flips[-1]}")
                flipped.append(i)
        loose.append(kink_leaves(cfg, ph, flipped))
        k += n
    rows = []
    for what, card, cpu, names, kinked in (
            ("grad", rc, rp, [f"phase {i}" for i in range(len(rp))], loose),
            ("update", uc, up, ["G", "D"],
             [loose[2] | loose[3], loose[0] | loose[1]])):
        for (g, path), (e, big, err, top) in leaf_errors(card, cpu).items():
            limit = KINK_TOL if path.split("/")[0] in kinked[g] else GRAD_TOL
            rows.append((e / limit, e, limit, f"{what} {names[g]} {path}",
                         big, err, top))
    # the worst leaf of each phase (and update) at each limit
    worst = {}
    for r in rows:
        group = (r[3].rsplit(" ", 1)[0], r[2])
        worst[group] = max(worst.get(group, r), r)
    loss_err = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1.0) for k in mp)
    print(f"  full width, batch {B}, f32, sgd(0.01): card {tc:.1f} ms, CPU "
          f"{tp:.1f} ms (each recording its LeakyReLU inputs); LeakyReLU "
          f"branches taken differently: {flips or 'none'}; the worst leaf "
          f"of each phase at each limit, card vs CPU, of the leaf's largest "
          f"(floor {FLOOR} of the phase's largest):", flush=True)
    for share, e, limit, name, big, err, top in sorted(worst.values(),
                                                       key=lambda r: r[3]):
        print(f"    {name}: {e:.3e} (limit {limit:g}, {100 * share:.1f}% of "
              f"it); max |cpu| {big:.3e}, max |card-cpu| {err:.3e}, phase's "
              f"largest {top:.3e}", flush=True)
    print(f"  losses card/CPU { {k: (mc[k], mp[k]) for k in mp} }: worst "
          f"{loss_err:.2e} (limit {LOSS_TOL})", flush=True)
    bad = [r for r in rows if r[0] > 1.0]
    check(not bad, f"card vs CPU: {[(r[3], r[1], r[2]) for r in bad]}")
    check(loss_err <= LOSS_TOL, f"card vs CPU losses: {mc} vs {mp}")
    top = max(rows)
    return {"worst_share_of_limit": top[0], "worst_leaf": top[3],
            "worst_rel_err": top[1], "worst_limit": top[2],
            "kinks": flips,
            "by_group": {f"{r[3]} (limit {r[2]:g})": r[1]
                         for r in worst.values()},
            "loss_rel_err": loss_err, "card_ms": tc, "cpu_ms": tp,
            "batch": B}


def inf_batch(batch):
    """``batch`` with one inf pixel, and the E_CAL sums made from it."""
    bad = dict(batch)
    img = np.array(batch["image"], copy=True)
    img[(0, *(n // 2 for n in img.shape[1:4]), 0)] = np.inf
    bad["image"] = img
    bad["ecal"] = img.sum(axis=(1, 2, 3, 4)).astype(np.float32)
    return bad


def guard_phase(cfg, batch):
    """The skip-on-nonfinite guard on the card, bf16 and fp16.  One inf
    pixel: D on real is skipped (the D optimizer steps once, not twice),
    the count of skipped phases is reported and the fp16 scale halves per
    skip.  With an inf in every fake draw too, every phase is skipped and
    the state comes back unchanged, bit for bit."""
    import torch
    from repro_torch.core import adversarial
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate.precision import get_policy
    opt = opt_lib.rmsprop(1e-4)
    bad = inf_batch(batch)
    res = {}

    def inf_inputs(i, mb):
        noise, e_p, theta = adversarial.draw_inputs(
            torch.Generator(device="cuda").manual_seed(100 + i), mb,
            cfg.latent_dim)
        noise[0, 0] = float("inf")
        return noise, e_p, theta

    for name in ("bf16", "fp16"):
        pol = get_policy(name)
        state = adversarial.init_state(torch.Generator().manual_seed(3), cfg,
                                       opt, opt, policy=pol, device="cuda")
        s0 = float(state.loss_scale.scale)
        before = [(k, v.clone()) for k, v in state_leaves(state)]
        step = adversarial.make_fused_step(cfg, opt, opt, policy=pol)
        new, m = step(state, bad, torch.Generator(device="cuda")
                      .manual_seed(7))
        d_steps, g_steps = int(new.d_opt["step"]), int(new.g_opt["step"])
        skips = float(m["nonfinite_skips"])
        scale = float(m["loss_scale"])
        finite = all(bool(torch.isfinite(v.float()).all())
                     for _, v in state_leaves(new))
        print(f"  {name}, one inf pixel: nonfinite_skips={skips:g}, D "
              f"updates {d_steps} of 2, G updates {g_steps} of 2, loss "
              f"scale {s0:g} -> {scale:g}, state finite: {finite}",
              flush=True)
        check(d_steps <= 1 and skips == 4 - d_steps - g_steps,
              f"{name}: D on real not skipped or skips miscounted "
              f"({d_steps}, {g_steps}, {skips})")
        check(scale == max(s0 * 0.5 ** skips, 1.0) and finite,
              f"{name}: scale {scale} from {s0} after {skips} skips, "
              f"finite {finite}")
        if name == "bf16":
            check(skips == 1, f"bf16: {skips} skips, want 1")
        step = adversarial.make_fused_step(cfg, opt, opt, policy=pol,
                                           sample_inputs=inf_inputs)
        new, m = step(state, bad, torch.Generator(device="cuda")
                      .manual_seed(7))
        after = dict(state_leaves(new))
        same = [k for k, v in before if k.startswith(("g_", "d_"))
                and torch.equal(v, after[k])]
        n_state = sum(1 for k, _ in before if k.startswith(("g_", "d_")))
        print(f"  {name}, inf pixel and inf in every fake draw: "
              f"nonfinite_skips={float(m['nonfinite_skips']):g}, loss scale "
              f"{s0:g} -> {float(m['loss_scale']):g}, {len(same)} of "
              f"{n_state} param and optimizer leaves unchanged bit for bit",
              flush=True)
        check(float(m["nonfinite_skips"]) == 4.0 and len(same) == n_state,
              f"{name}: all-nonfinite step changed the state")
        check(float(m["loss_scale"]) == max(s0 / 16, 1.0),
              f"{name}: scale {float(m['loss_scale'])} after 4 skips")
        res[name] = {"skips_one_pixel": skips, "scale_after": scale,
                     "d_updates": d_steps, "g_updates": g_steps}
    return res


def train_phase(cfg, card):
    """The training main path: ``Engine.fit`` over batches made before the
    timed window, counts reset just before and read just after; then the
    same step twice (bit for bit), the guard, and one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import adversarial
    from repro_torch.data.calo import CaloSimulator, CaloSpec
    from repro_torch.kernels.conv3d import conv3d as conv_mod
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate.precision import get_policy
    from repro_torch.train import engine as engine_lib

    n = TRAIN_WARMUP + TRAIN_STEPS
    sim = CaloSimulator(CaloSpec(image_shape=cfg.image_shape), seed=21)
    stream = sim.batches(BATCH)
    t0 = time.perf_counter()
    batches = [next(stream) for _ in range(n)]
    sim_ms = 1e3 * (time.perf_counter() - t0) / n
    print(f"  host Monte Carlo (CaloSimulator, numpy): {sim_ms:.1f} ms per "
          f"batch of {BATCH}, {n} batches made before the timed window",
          flush=True)
    task = engine_lib.gan_task(cfg, opt_lib.rmsprop(1e-4),
                               opt_lib.rmsprop(1e-4),
                               policy=get_policy("bf16"))
    eng = engine_lib.Engine("cuda")
    state0 = eng.init_state(task, seed=0)
    stamps = []

    def hook(gstep, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    # the main path: counts reset just before, read just after
    conv_mod.LAUNCHES = 0
    conv_mod.DW_LAUNCHES = 0
    t_start = time.perf_counter()
    state, metrics = eng.fit(task, batches, n, seed=0, state=state0,
                             hooks=(hook,))
    fwd, dw = conv_mod.LAUNCHES, conv_mod.DW_LAUNCHES
    step_ms = [1e3 * (b - a) for a, b in zip([t_start] + stamps, stamps)]
    want_fwd, want_dw = adversarial.conv_launches_per_step(cfg)
    m = {k: float(v) for k, v in metrics.items()}
    timed = step_ms[TRAIN_WARMUP:]
    med = float(np.median(timed))
    spread = (max(timed) - min(timed)) / med
    print(f"  {n} steps ({TRAIN_WARMUP} warm-up): step wall ms "
          f"{[round(t, 2) for t in step_ms]}; median of {TRAIN_STEPS} "
          f"{med:.2f} ms, spread (max-min)/median {100 * spread:.1f}%, "
          f"{BATCH / med * 1e3:.1f} real showers consumed/s; h2d wait "
          f"{eng.last_fit_stats['h2d_wait_ms']:.1f} ms, put "
          f"{eng.last_fit_stats['h2d_put_ms']:.1f} ms [{card}]", flush=True)
    print(f"  launches: conv3d_fwd {fwd} ({fwd / n:g}/step), conv3d_dw {dw} "
          f"({dw / n:g}/step); metrics of the last step {m}", flush=True)
    check(fwd == want_fwd * n and dw == want_dw * n,
          f"launches {fwd}, {dw} for {n} steps (want {want_fwd}, {want_dw} "
          "per step)")
    check(want_fwd == 50 and want_dw == 16, f"{want_fwd}, {want_dw}")
    check(all(math.isfinite(v) for v in m.values())
          and m["nonfinite_skips"] == 0, f"metrics {m}")

    # the same step twice from one state, one seed: bit for bit
    step = task.make_step()
    dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    a, _ = step(state, dev_batch, eng.step_generator(0, n))
    b, _ = step(state, dev_batch, eng.step_generator(0, n))
    la, lb = state_leaves(a), state_leaves(b)
    same = sum(1 for (_, x), (_, y) in zip(la, lb) if torch.equal(x, y))
    print(f"  the same step twice from one state and seed: {same} of "
          f"{len(la)} param, optimizer and loss-scale leaves bit-identical",
          flush=True)
    check(same == len(la), "two runs of a step differ")
    del a, b

    guard = guard_phase(cfg, batches[0])

    # one profiled step
    gen = eng.step_generator(0, n + 1)
    step(state, dev_batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, dev_batch, eng.step_generator(0, n + 2))
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy = sum(k["ms"] for k in kernels)
    fwd_ms = sum(k["ms"] for k in kernels if "conv3d_fwd" in k["kernel"])
    dw_ms = sum(k["ms"] for k in kernels if "conv3d_dw" in k["kernel"])
    print(f"  one bf16 step, batch {BATCH} already on the card: wall "
          f"{wall:.3f} ms", flush=True)
    if kernels:
        print(f"  device busy {busy:.3f} ms = {100 * busy / wall:.1f}% of "
              f"wall; conv3d_fwd {fwd_ms:.3f} ms, conv3d_dw {dw_ms:.3f} ms; "
              f"by kernel:", flush=True)
        for k in kernels[:14]:
            print(f"    {k['ms']:9.3f} ms  x{k['count']:<4d} {k['kernel']}",
                  flush=True)
    else:
        print("  device time: not measured (the profiler saw no device "
              "activity)", flush=True)
    return {"steps": n, "step_ms": step_ms, "median_ms": med,
            "spread": spread, "showers_per_s": BATCH / med * 1e3,
            "sim_ms_per_batch": sim_ms, "fwd_launches": fwd,
            "dw_launches": dw, "metrics": m, "guard": guard,
            "profile": {"wall_ms": wall,
                        "device_ms": busy if kernels else None,
                        "conv3d_fwd_ms": fwd_ms if kernels else None,
                        "conv3d_dw_ms": dw_ms if kernels else None,
                        "kernels": kernels[:14]}}


# ---------------------------------------------------------------------------
# LM serving: the attention kernels, the model card vs CPU, the engine
# ---------------------------------------------------------------------------


def attention_work(kind, q_shape, kv_shape, kv_len, q_offset=None, window=0):
    """(visible (query row, key) pairs per head, live K/V positions) of one
    serving attention call on these lengths: what the call must read and
    compute.  ``kind`` "decode": q (B, 1, H, D), the query at kv_len - 1;
    "chunk": q (B, C, H, D), row i at q_offset + i.  A row that sees no
    key costs nothing."""
    kv_len = np.minimum(np.asarray(kv_len, np.int64), kv_shape[1])
    if kind == "decode":
        lo = np.maximum(kv_len - window, 0) if window else np.zeros_like(kv_len)
        seen = kv_len - lo
        return int(seen.sum()), int(seen.sum())
    C = q_shape[1]
    qpos = np.asarray(q_offset, np.int64)[:, None] + np.arange(C)[None]
    hi = np.minimum(kv_len[:, None], qpos + 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros_like(qpos)
    pairs = int(np.maximum(hi - lo, 0).sum())
    # K/V positions some row of the chunk sees: [min lo, max hi) per row
    span = np.maximum(hi.max(axis=1) - lo.min(axis=1), 0)
    return pairs, int(span.sum())


def attention_bound(kind, q_shape, kv_shape, kv_len, dname, q_offset=None,
                    window=0):
    """(bound ms, "bytes" | "operations", bytes, flops) of one serving
    attention call: q read and the output written once, K and V of the
    live positions read once (per KV head), and 4 * D flops per visible
    (query head, key) pair, against HBM's rate and the peak of the
    call's dtype."""
    B, S, H, D = q_shape
    KH = kv_shape[2]
    esize = 4 if dname == "float32" else 2
    pairs, live = attention_work(kind, q_shape, kv_shape, kv_len, q_offset,
                                 window)
    nbytes = (2 * B * S * H * D + 2 * live * KH * D) * esize
    flops = 4 * D * H * pairs
    bound, by = layer_bound(flops / 2, nbytes, dname)
    return bound, by, nbytes, flops


def lm_launches_ok(counts, n_layers):
    """True when the main path's kernel counts are exactly n_layers per
    prefill launch (flash_chunk) and per decode step (flash_decode), both
    non-zero."""
    return (counts["prefill_launches"] > 0 and counts["decode_steps"] > 0
            and counts["flash_chunk"] == n_layers * counts["prefill_launches"]
            and counts["flash_decode"] == n_layers * counts["decode_steps"])


def sdpa_call(q, k, v, mask):
    """The yardstick: one ``scaled_dot_product_attention`` call on (B, H,
    S, D) views with a boolean (B, 1, S, T) mask, GQA by the library
    (timed only; the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def attention_masks(kind, B, S, T, kv_len, q_offset, device):
    """(B, 1, S, T) bool mask of the serving call (no window)."""
    import torch
    kpos = torch.arange(T, device=device)
    kvl = kv_len.long()[:, None, None]
    if kind == "decode":
        qpos = (kv_len.long() - 1)[:, None]
    else:
        qpos = q_offset.long()[:, None] + torch.arange(S, device=device)
    return ((kpos[None, None] < kvl) & (kpos[None, None] <= qpos[:, :, None])
            )[:, None]


def attention_phase(cfg):
    """Both serving attention kernels against their plain versions at the
    LM main path's shapes (8 slots, a 1024-position cache, chunks of 128),
    in f32 and bf16, N(0, 1) inputs (a peaked softmax: a wrong mask
    shows); kernel, plain and SDPA times with each call's bound."""
    import torch
    from repro_torch.kernels.flash_attention import decode as dec_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import ref
    B, T, C = LM_SLOTS, LM_MAX_LEN, LM_CHUNK
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(21)
    rng = np.random.default_rng(21)
    dec_len = torch.tensor(rng.integers(64, T + 1, B), dtype=torch.int32,
                           device="cuda")
    off = torch.tensor([0, 128, 256, 384, 0, 512, 0, 896], dtype=torch.int32,
                       device="cuda")
    lens = torch.tensor([128, 128, 100, 128, 64, 128, 0, 128],
                        dtype=torch.int32, device="cuda")
    chunk_len = torch.where(lens > 0, off + lens, torch.zeros_like(lens))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        k = torch.randn((B, T, KH, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, KH, D), generator=gen, device="cuda").to(dtype)
        for kind in ("flash_chunk", "flash_decode"):
            S = C if kind == "flash_chunk" else 1
            q = torch.randn((B, S, H, D), generator=gen,
                            device="cuda").to(dtype)
            if kind == "flash_chunk":
                kvl, qoff = chunk_len, off
                kern = lambda: fa_mod.flash_attention_chunk(q, k, v, qoff, kvl)
                plain = lambda: ref.flash_chunk_ref(q, k, v, qoff, kvl)
            else:
                kvl, qoff = dec_len, None
                sched = dec_mod.decode_schedule(T, D)
                kern = lambda: dec_mod.flash_decode(q, k, v, kvl)
                plain = lambda: ref.flash_decode_ref(
                    q, k, v, kvl, block_kv=sched[0], num_splits=sched[1])
            mask = attention_masks("chunk" if S > 1 else "decode", B, S, T,
                                   kvl, qoff, "cuda")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: sdpa_call(qt, kt, vt, mask)
            yk, yp = kern(), plain()
            yl = lib().transpose(1, 2)
            torch.cuda.synchronize()
            atol, rtol = TOL_ATTN[dname]
            diff = (yk.float() - yp.float()).abs()
            max_abs = float(diff.max())
            ok = bool((diff <= atol + rtol * yp.float().abs()).all())
            live = kvl > 0
            zero_ok = bool((yk[~live] == 0).all())
            lib_err = float((yl[live].float() - yp[live].float()).abs().max())
            n0 = (fa_mod.LAUNCHES, dec_mod.LAUNCHES)
            ms_k, ms_p, ms_l = cuda_ms(kern), cuda_ms(plain), cuda_ms(lib)
            # launches made to compare and time are not main-path launches
            fa_mod.LAUNCHES, dec_mod.LAUNCHES = n0
            bound, by, nbytes, flops = attention_bound(
                "chunk" if S > 1 else "decode", tuple(q.shape),
                tuple(k.shape), kvl.cpu().numpy(), dname,
                None if qoff is None else qoff.cpu().numpy())
            rows.append({"kernel": kind, "dtype": dname, "q": list(q.shape),
                         "kv": list(k.shape), "kv_len": kvl.tolist(),
                         "q_offset": None if qoff is None else qoff.tolist(),
                         "max_abs_err": max_abs, "atol": atol, "rtol": rtol,
                         "sdpa_vs_plain_live": lib_err, "ms": ms_k,
                         "plain_ms": ms_p, "library_ms": ms_l,
                         "bound_ms": bound, "bound_by": by,
                         "mbytes": nbytes / 1e6, "gflop": flops / 1e9})
            print(f"  {kind:12s} {dname:8s} max_abs={max_abs:.3e} (atol "
                  f"{atol}, rtol {rtol}); rows with no key exact 0: "
                  f"{zero_ok}; kernel_ms={ms_k:.4f} plain_ms={ms_p:.4f} "
                  f"sdpa_ms={ms_l:.4f} bound_ms={bound:.4f} ({by}); SDPA "
                  f"vs plain on live rows {lib_err:.2e}", flush=True)
            check(ok, f"{kind} {dname}: kernel disagrees with the plain "
                      f"version (max abs {max_abs})")
            check(zero_ok, f"{kind} {dname}: a row with no key is not 0")
            check(lib_err <= 10 * atol + 0.05 * (dname == "bfloat16"),
                  f"{kind} {dname}: SDPA is not the same function "
                  f"({lib_err})")
            del yk, yp, yl
    return rows


def decode_split_phase(cfg):
    """Device time of flash_decode at the path's shapes by split count
    (tiles of 64 positions), beside the count the port's rule picks."""
    import torch
    from repro_torch.kernels.flash_attention import decode as dec_mod
    B, T = LM_SLOTS, LM_MAX_LEN
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(22)
    kvl = torch.tensor(np.random.default_rng(22).integers(64, T + 1, B),
                       dtype=torch.int32, device="cuda")
    out = {}
    n0 = dec_mod.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, T, KH, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, KH, D), generator=gen, device="cuda").to(dtype)
        times = {}
        for ns in (1, 2, 4, 8, 16):
            times[ns] = cuda_ms(lambda: dec_mod.flash_decode(
                q, k, v, kvl, block_kv=64, num_splits=ns))
        rule = dec_mod.decode_schedule(T, D)
        out[dname] = {"ms_by_splits": times, "rule": list(rule)}
        print(f"  flash_decode B={B} {dname:8s} device ms by split count "
              f"(64 positions a tile): " + ", ".join(
                  f"{n}: {t:.4f}" for n, t in times.items())
              + f"; the port's rule: {rule[1]} splits of {rule[0]}",
              flush=True)
    dec_mod.LAUNCHES = n0
    return out


def lm_inputs(cfg, seed):
    """One chunk-prefill batch and 4 decode steps for the card-vs-CPU
    check: 8 slots, a 1024-position cache holding noise below each row's
    chunk, ragged offsets and lengths (one slot inactive)."""
    import torch
    rng = np.random.default_rng(seed)
    B, T, C = LM_SLOTS, LM_MAX_LEN, LM_CHUNK
    pos = np.asarray([0, 128, 256, 0, 384, 0, 512, 100], np.int32)
    lens = np.asarray([128, 128, 64, 0, 128, 17, 128, 128], np.int32)
    tokens = rng.integers(0, cfg.vocab, (B, C)).astype(np.int32)
    dec = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
           for _ in range(4)]
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.d_head)
    cache = {n: 0.5 * torch.randn(shape, generator=g) for n in ("k", "v")}
    return tokens, pos, lens, dec, cache


def lm_run(params, cfg, inputs, device, roll=0, noise_seed=None):
    """Prefill then 4 decodes on ``device`` (f32): [(logits (B, 1, V) on
    the CPU, live cache rows)] per call.  ``roll`` rolls the batch by that
    many rows; ``noise_seed`` refills every cache position at or past each
    row's prefilled length with fresh noise first."""
    import torch
    from repro_torch.models import lm
    from repro_torch.substrate.precision import get_policy
    tokens, pos, lens, dec, cache0 = inputs
    pol = get_policy("f32")
    r = lambda a: np.roll(a, roll, axis=0)
    cache = {n: torch.roll(t, roll, dims=1).to(device)
             for n, t in cache0.items()}
    pos, lens = r(pos), r(lens)
    if noise_seed is not None:
        g = torch.Generator().manual_seed(noise_seed)
        for t in cache.values():
            for b in range(t.shape[1]):
                start = int(pos[b] + lens[b])
                t[:, b, start:] = torch.randn(
                    (t.shape[0], t.shape[2] - start, *t.shape[3:]),
                    generator=g).to(device)
    out = []
    logits, cache = lm.prefill_chunk(params, r(tokens), cache, pos, lens, cfg,
                                     policy=pol)
    kvl = pos + lens
    out.append((logits.cpu(), kvl.copy()))
    at = kvl.copy()
    for t in dec:
        logits, cache = lm.decode_step(params, r(t), cache, at, cfg,
                                       policy=pol)
        at = at + 1
        out.append((logits.cpu(), at.copy()))
    live = {n: [c[:, b, :int(at[b])].cpu() for b in range(len(at))]
            for n, c in cache.items()}
    return out, live


def lm_compare(cfg, params_card, params_cpu, inputs, label):
    """Card vs CPU over a prefill and 4 decodes: logits within LM_TOL of
    the largest |logit| per call, the live cache within LM_TOL of its
    largest; then the rows rolled one place with fresh noise in every
    not-yet-written cache position, bit for bit."""
    import torch
    t0 = time.perf_counter()
    card, card_cache = lm_run(params_card, cfg, inputs, "cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, cpu_cache = lm_run(params_cpu, cfg, inputs, "cpu")
    t_cpu = time.perf_counter() - t0
    lens = inputs[2]
    errs = [float((lc - lp).abs().max()) / float(lp.abs().max())
            for (lc, _), (lp, _) in zip(card, cpu)]
    cache_err = max(
        float((a - b).abs().max()) / float(b.abs().max())
        for n in ("k", "v") for a, b in zip(card_cache[n], cpu_cache[n]))
    print(f"  {label}: card {t_card:.2f} s, CPU {t_cpu:.2f} s; logits card "
          f"vs CPU per call (prefill, then 4 decodes), max |diff| / max "
          f"|logit|: {[f'{e:.2e}' for e in errs]}; live KV cache "
          f"{cache_err:.2e} (tolerance {LM_TOL})", flush=True)
    check(max(errs) <= LM_TOL and cache_err <= LM_TOL,
          f"{label}: card vs CPU {errs}, cache {cache_err}")
    rolled, _ = lm_run(params_card, cfg, inputs, "cuda", roll=1,
                       noise_seed=99)
    same, total = 0, 0
    for (a, _), (b, _) in zip(card, rolled):
        for row in range(len(lens)):
            total += 1
            same += bool(torch.equal(a[row], b[(row + 1) % len(lens)]))
    print(f"  batch invariance: rows rolled one place, the not-yet-written "
          f"cache filled with fresh noise: {same} of {total} (row, call) "
          f"logits bit-identical", flush=True)
    check(same == total, f"{label}: rolled rows differ ({same}/{total})")
    return {"logits_err": errs, "cache_err": cache_err, "card_s": t_card,
            "cpu_s": t_cpu, "rolled_identical": same, "rolled_total": total}


def sharpen(params, factor):
    """The same parameters with every wq and wk (and their biases) scaled
    by ``factor``: scores grow by factor^2, the attention sharpens."""
    from repro_torch.substrate.precision import tree_map
    out = dict(params)
    out["blocks"] = []
    for bp in params["blocks"]:
        bp = dict(bp, attn=dict(bp["attn"]))
        for n in ("wq", "wk"):
            bp["attn"][n] = tree_map(lambda t: t * factor, bp["attn"][n])
        out["blocks"].append(bp)
    return out


def layer0_peak(params, cfg, inputs):
    """Median over live chunk rows and heads of layer 0's largest softmax
    weight, and of that weight minus the uniform one (1 / keys seen), on
    the CPU's plain route."""
    import torch
    from repro_torch.models import lm
    from repro_torch.substrate import attention as attn, layers
    tokens, pos, lens, _, cache = inputs
    bp = params["blocks"][0]
    x = layers.apply_embed(params["embed"], torch.from_numpy(tokens).long())
    h = layers.apply_norm(bp["ln1"], x, norm_type=cfg.norm_type)
    q, k, _ = attn.project_qkv(bp["attn"], h, cfg)
    qpos = torch.from_numpy(pos)[:, None] + torch.arange(tokens.shape[1])
    cos, sin = lm._rope_for(cfg, qpos, x.dtype)
    q, k = attn.apply_rope(q, cos, sin), attn.apply_rope(k, cos, sin)
    peaks, above = [], []
    G = cfg.n_heads // cfg.n_kv_heads
    for b in range(len(lens)):
        n, p0 = int(lens[b]), int(pos[b])
        if not n:
            continue
        keys = torch.cat([cache["k"][0, b, :p0], k[b, :n]])   # (p0+n, KH, D)
        s = torch.einsum("ihd,thd->iht", q[b, :n],
                         keys.repeat_interleave(G, 1)) / cfg.d_head ** 0.5
        t = torch.arange(p0 + n)
        vis = t[None, :] <= (p0 + torch.arange(n))[:, None]
        w = torch.softmax(s.masked_fill(~vis[:, None], -1e30), -1)
        mx = w.amax(-1)
        peaks.append(mx.flatten())
        above.append((mx - 1.0 / vis.sum(-1)[:, None]).flatten())
    return float(torch.cat(peaks).median()), float(torch.cat(above).median())


def lm_check_phase(cfg, card):
    """Full-width qwen2-1.5b from one seed: the card (kernels) vs the CPU
    (plain versions) over a prefill and 4 decodes, then the same at
    sharpened attention (depth cut to LM_SHARP_LAYERS)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.substrate.precision import tree_map
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                     "cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    inputs = lm_inputs(cfg, seed=1)
    res = {"random": lm_compare(cfg, params, cpu_params, inputs,
                                f"full width ({cfg.n_layers} layers, f32, "
                                "random weights from seed 0)")}
    cut = dataclasses.replace(cfg, n_layers=LM_SHARP_LAYERS)
    sharp = sharpen(dict(cpu_params, blocks=cpu_params["blocks"][
        :LM_SHARP_LAYERS]), LM_SHARP)
    del cpu_params
    peak, above = layer0_peak(sharp, cut, inputs)
    print(f"  sharp weights (wq, wk x{LM_SHARP}), depth cut to "
          f"{LM_SHARP_LAYERS} of {cfg.n_layers} layers: layer 0's largest "
          f"softmax weight per live row and head, median {peak:.4f} (limit "
          f"> 0.5), median above uniform {above:.4f} (limit > 0.3)",
          flush=True)
    check(peak > 0.5 and above > 0.3, f"sharp weights not sharp: {peak}, "
                                      f"{above}")
    sharp_card = tree_map(lambda t: t.cuda(), sharp)
    inputs_cut = inputs[:4] + ({n: t[:LM_SHARP_LAYERS].clone()
                                for n, t in inputs[4].items()},)
    res["sharp"] = lm_compare(cut, sharp_card, sharp, inputs_cut,
                              f"sharp, {LM_SHARP_LAYERS} layers (f32)")
    res["sharp"].update(peak_median=peak, above_uniform_median=above)
    del sharp, sharp_card
    return params, res


def lm_requests(cfg, n, seed):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               int(rng.integers(64, 513)),
                                               dtype=np.int32),
                    max_new_tokens=LM_NEW) for i in range(n)]


def lm_window(cfg, params, label, policy="f32"):
    """LM_REQUESTS requests served to the end through ServeEngine: (engine,
    requests, seconds, kernel launches)."""
    import torch
    from repro_torch.kernels.flash_attention import decode as dec_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      prefill_chunk=LM_CHUNK, policy_name=policy,
                      device="cuda")
    reqs = lm_requests(cfg, LM_REQUESTS, seed=5)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    fa_mod.LAUNCHES = dec_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(eng.stats, flash_chunk=fa_mod.LAUNCHES,
                  flash_decode=dec_mod.LAUNCHES)
    n_tok = sum(len(r.tokens) for r in done)
    print(f"  {label}: {len(reqs)} requests, {n_tok} generated tokens in "
          f"{dt:.3f} s: {n_tok / dt:.1f} tok/s; prefill launches "
          f"{eng.stats['prefill_launches']}, decode steps "
          f"{eng.stats['decode_steps']}", flush=True)
    check(len(done) == len(reqs) and all(
        r.status == "done" and len(r.tokens) == LM_NEW
        and all(0 <= t < cfg.vocab for t in r.tokens) for r in reqs),
        f"{label}: not every request got {LM_NEW} tokens")
    check(lm_launches_ok(counts, cfg.n_layers),
          f"{label}: launches {counts} (want {cfg.n_layers} per prefill "
          "launch and per decode step)")
    return eng, reqs, dt, counts


def lm_serve_phase(cfg, params, card):
    """The LM main path: full-width qwen2-1.5b through ServeEngine (8
    slots, 1024 positions, chunks of 128), f32; counts reset just before
    window 1 and read just after; two more windows for the spread, one
    bf16 window, one profiled decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import ServeEngine
    # warm-up (cuBLAS handles, kernel modules): not measured
    warm = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       prefill_chunk=LM_CHUNK, device="cuda")
    for r in lm_requests(cfg, 2, seed=4):
        r.max_new_tokens = 2
        warm.submit(r)
    warm.run()
    del warm
    eng, reqs, dt, counts = lm_window(cfg, params, "window 1 (main path)")
    print(f"  launches: flash_chunk {counts['flash_chunk']} = "
          f"{cfg.n_layers} x {counts['prefill_launches']} prefill launches; "
          f"flash_decode {counts['flash_decode']} = {cfg.n_layers} x "
          f"{counts['decode_steps']} decode steps", flush=True)
    distinct = [len(set(r.tokens)) for r in reqs]
    print(f"  every request got its {LM_NEW} tokens; distinct tokens per "
          f"request: min {min(distinct)}, median "
          f"{int(np.median(distinct))} (random weights: the card-vs-CPU "
          f"logits above are the check)", flush=True)
    n_tok = LM_REQUESTS * LM_NEW
    runs = [n_tok / dt]
    del eng
    for k in range(2, LM_WINDOWS + 1):
        _, _, t, _ = lm_window(cfg, params, f"window {k}")
        runs.append(n_tok / t)
    med = float(np.median(runs))
    spread = (max(runs) - min(runs)) / med
    print(f"  generated tok/s over {LM_WINDOWS} f32 windows: "
          f"{[round(v, 1) for v in runs]}, median {med:.1f}, spread "
          f"(max-min)/median {100 * spread:.1f}% [{card}]", flush=True)
    _, _, t_bf, c_bf = lm_window(cfg, params, "bf16 window (params cast "
                                 "once)", policy="bf16")
    # one profiled f32 decode step, all slots mid-decode
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      prefill_chunk=LM_CHUNK, device="cuda")
    for r in lm_requests(cfg, LM_SLOTS, seed=6):
        r.max_new_tokens = 100
        eng.submit(r)
    eng._fill_slots()
    for _ in range(3):
        eng._step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy = sum(k["ms"] for k in kernels)
    dec_ms = sum(k["ms"] for k in kernels if "flash_decode" in k["kernel"]
                 or "combine_kernel" in k["kernel"])
    print(f"  one f32 decode step, {LM_SLOTS} slots mid-decode (positions "
          f"{eng.pos.tolist()}): wall {wall:.3f} ms", flush=True)
    if kernels:
        print(f"  device busy {busy:.3f} ms = {100 * busy / wall:.1f}% of "
              f"wall; flash_decode (both passes) {dec_ms:.3f} ms; by "
              f"kernel:", flush=True)
        for k in kernels[:12]:
            print(f"    {k['ms']:9.3f} ms  x{k['count']:<4d} {k['kernel']}",
                  flush=True)
    else:
        print("  device time: not measured (the profiler saw no device "
              "activity)", flush=True)
    return {"counts": counts, "tok_s_runs": runs, "tok_s_median": med,
            "tok_s_spread": spread, "bf16_tok_s": n_tok / t_bf,
            "bf16_counts": c_bf,
            "profile": {"wall_ms": wall,
                        "device_ms": busy if kernels else None,
                        "flash_decode_ms": dec_ms if kernels else None,
                        "kernels": kernels[:12]}}


# ---------------------------------------------------------------------------
# LM training: the attention kernels, one step card vs CPU, the main path
# ---------------------------------------------------------------------------


def train_attention_work(B, S, T, H, KH, D, dname, causal=True, window=0):
    """{kernel: (bound ms, "bytes" | "operations", bytes, flops)} of the
    three training attention kernels on these shapes: 2 * D flops per
    visible (query head, key) pair and product (forward: q.k and p.v; dq:
    q.k, dO.v and ds.k; dk/dv: those two and p^T.dO, ds^T.q), against each
    input read once and each output written once."""
    qpos = np.arange(S)[:, None]
    kpos = np.arange(T)[None]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= qpos >= kpos
    if window:
        vis &= kpos > qpos - window
    pairs = B * H * int(vis.sum())
    esize = 4 if dname == "float32" else 2
    q_el, kv_el, rows = B * S * H * D, B * T * KH * D, B * S * H
    work = {"flash_fwd": (2, (2 * q_el + 2 * kv_el) * esize + 4 * rows),
            "flash_bwd_dq": (3, (3 * q_el + 2 * kv_el) * esize + 8 * rows),
            "flash_bwd_dkv": (4, (2 * q_el + 4 * kv_el) * esize + 8 * rows)}
    out = {}
    for name, (products, nbytes) in work.items():
        flops = 2 * D * pairs * products
        out[name] = (*layer_bound(flops / 2, nbytes, dname), nbytes, flops)
    return out


def train_attention_phase(cfg):
    """The three training attention kernels against their plain versions at
    the LM training path's shapes (batch 8 x seq 256, qwen2-1.5b heads,
    causal), f32 and bf16 on N(0, 1) inputs: O, lse, dq, dk and dv; each
    kernel twice on the same inputs, bit for bit; kernel, plain and SDPA
    times (forward; forward + backward with the KV heads expanded) beside
    each kernel's bound."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref
    B, S, H, KH, D = LMT_BATCH, LMT_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KH
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    n0 = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(
            dtype) for _ in range(2))
        k, v = (torch.randn((B, S, KH, D), generator=gen, device="cuda").to(
            dtype) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
        delta = ref.attention_delta(o, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        po, plse = ref.flash_fwd_ref(q, k, v)
        pdq = ref.flash_bwd_dq_ref(q, k, v, do, lse, delta)
        pdk, pdv = ref.flash_bwd_dkv_ref(q, k, v, do, lse, delta)
        again = (*fa.flash_attention_fwd(q, k, v, return_lse=True),
                 fa.flash_bwd_dq(q, k, v, do, lse, delta),
                 *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
        torch.cuda.synchronize()
        abs_errs = {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in (("o", o, po), ("dq", dq, pdq),
                                    ("dk", dk, pdk), ("dv", dv, pdv))}
        errs = {n: e / float(b.float().abs().max()) for (n, e), b in
                zip(abs_errs.items(), (po, pdq, pdk, pdv))}
        lse_err = float(((lse - plse).abs() / plse.abs().clamp_min(1.0)).max())
        same = all(torch.equal(a, b) for a, b in
                   zip((o, lse, dq, dk, dv), again))
        # the yardstick: SDPA on (B, H, S, D) with the KV heads expanded
        qt, dot = (t.transpose(1, 2).contiguous() for t in (q, do))
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

        def sdpa_fwd_bwd():
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=True)
            torch.autograd.grad(out, leaves, dot)

        # the backward alone (dq, dk, dv: what flash_bwd_dq and
        # flash_bwd_dkv compute together) of one saved forward
        saved = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True)

        def sdpa_bwd():
            torch.autograd.grad(saved, leaves, dot, retain_graph=True)

        lib_err = float((sdpa().transpose(1, 2).float() - po.float()).abs()
                        .max()) / float(po.float().abs().max())
        times = {
            "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v,
                                                         return_lse=True),
                          lambda: ref.flash_fwd_ref(q, k, v), sdpa,
                          "SDPA forward"),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
                             lambda: ref.flash_bwd_dq_ref(q, k, v, do, lse,
                                                          delta),
                             sdpa_bwd, "SDPA backward alone (dq, dk, dv)"),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                       delta),
                              lambda: ref.flash_bwd_dkv_ref(q, k, v, do, lse,
                                                            delta),
                              sdpa_bwd, "SDPA backward alone (dq, dk, dv)"),
        }
        bounds = train_attention_work(B, S, S, H, KH, D, dname)
        err_of = {"flash_fwd": max(errs["o"], lse_err),
                  "flash_bwd_dq": errs["dq"],
                  "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
        abs_of = {"flash_fwd": max(abs_errs["o"],
                                   float((lse - plse).abs().max())),
                  "flash_bwd_dq": abs_errs["dq"],
                  "flash_bwd_dkv": max(abs_errs["dk"], abs_errs["dv"])}
        lib_ms = {sdpa_fwd_bwd: cuda_ms(sdpa_fwd_bwd)}
        for name, (kern, plain, lib, lib_what) in times.items():
            ms_k, ms_p = cuda_ms(kern), cuda_ms(plain)
            if lib not in lib_ms:
                lib_ms[lib] = cuda_ms(lib)
            bound, by, nbytes, flops = bounds[name]
            rows.append({"kernel": name, "dtype": dname,
                         "q": [B, S, H, D], "kv": [B, S, KH, D],
                         "max_abs_err": abs_of[name],
                         "max_err_of_largest": err_of[name], "ms": ms_k,
                         "plain_ms": ms_p, "library_ms": lib_ms[lib],
                         "library": lib_what,
                         "library_fwd_bwd_ms": lib_ms[sdpa_fwd_bwd],
                         "bound_ms": bound,
                         "bound_by": by, "mbytes": nbytes / 1e6,
                         "gflop": flops / 1e9, "repeat_identical": same})
            print(f"  {name:13s} {dname:8s} err/largest {err_of[name]:.2e} "
                  f"(tolerance {TOL_TRAIN_ATTN[dname]}); kernel_ms={ms_k:.4f} "
                  f"plain_ms={ms_p:.4f} library_ms={lib_ms[lib]:.4f} "
                  f"({lib_what}) bound_ms={bound:.4f} ({by})", flush=True)
        print(f"  {dname}: SDPA forward + backward "
              f"{lib_ms[sdpa_fwd_bwd]:.4f} ms, backward alone "
              f"{lib_ms[sdpa_bwd]:.4f} ms", flush=True)
        print(f"  {dname}: O {errs['o']:.2e}, lse {lse_err:.2e}, dq "
              f"{errs['dq']:.2e}, dk {errs['dk']:.2e}, dv {errs['dv']:.2e} of "
              f"their largest; a second run bit-identical: {same}; SDPA vs "
              f"plain {lib_err:.2e}", flush=True)
        tol = TOL_TRAIN_ATTN[dname]
        check(max(errs.values()) <= tol and lse_err <= 1e-5,
              f"training attention {dname}: kernels disagree with plain "
              f"({errs}, lse {lse_err})")
        check(same, f"training attention {dname}: a second run differs")
        check(lib_err <= 10 * tol, f"SDPA {dname} is not the same function "
                                   f"({lib_err})")
        del q, k, v, do, o, lse, dq, dk, dv, po, pdq, pdk, pdv, again, leaves
        del saved
    # launches made to compare and time are not main-path launches
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = n0
    return rows


def ssd_work(Bt, S, H, P, N, L):
    """{kernel: (bound ms, "bytes" | "operations", bytes, flops)} of the two
    SSD scan wrappers on these f32 shapes: the multiply-adds the function
    needs, not those the kernels spend.  Per chunk of l steps up to S (a
    ragged last chunk counts only its own), over its l (l + 1) / 2 pairs s
    <= t: C B^T once per batch row (B and C are shared by all heads), and
    per head -- forward: M x (P each); C state (l P N) where the entry
    state is not the zero one (every chunk but the first) and the state
    update (l P N).  Backward: dy x^T and M^T dy (P each), T1^T C and
    (T1 dt) B (N each); dy s0 and dy^T C (the chunk before's G) in every
    chunk but the first; B G^T, x G and the state update for <G, s1> in
    every chunk but the last, where G is zero.  The kernels compute every
    (L, L) product whole, per head and over a ragged chunk's pad, as the
    TPU kernels do: that is their design, not the function's work.
    Bytes: each input read once, each output of the wrapper written once
    (the backward's dB and dC summed over heads, and dA).  L is clamped to
    S, as the wrappers clamp it."""
    L = min(L, S)
    nC = -(-S // L)
    fwd = bwd = 0
    for c in range(nC):
        l = min(L, S - c * L)
        pairs, lpn = l * (l + 1) // 2, l * P * N
        first, last = c == 0, c == nC - 1
        fwd += Bt * pairs * N + Bt * H * (pairs * P + lpn * (2 - first))
        bwd += Bt * pairs * N + Bt * H * (
            pairs * 2 * (P + N) + lpn * (2 * (not first) + 3 * (not last)))
    seq, state, rows = Bt * S * H * P, Bt * H * P * N, Bt * S * H
    bc = 2 * Bt * S * N
    fwd_in = seq + bc + rows + H
    work = {
        "ssd_fwd": (fwd, 4 * (fwd_in + seq + state + nC * state)),
        "ssd_bwd": (bwd, 4 * (fwd_in + nC * state + seq        # + s0, dy
                              + seq + bc + rows + H)),
    }
    return {name: (*layer_bound(macs, nbytes, "float32"), nbytes, 2 * macs)
            for name, (macs, nbytes) in work.items()}


def ssd_inputs(Bt, S, H, P, N, seed):
    """N(0, 1) x, B, C and dy on the card; dt = softplus(N(-2, 1)) and A
    from -1 to -16 (the model's A_log init): the log-decay falls by
    hundreds within a chunk, so exp(F_t - F_s) above the diagonal would
    overflow."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dy = (torch.randn((Bt, S, H, P), generator=g, device="cuda")
             for _ in range(2))
    B, C = (torch.randn((Bt, S, N), generator=g, device="cuda")
            for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, S, H), generator=g, device="cuda") - 2.0)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    return x, B, C, dt, A, dy


def ssd_phase(cfg):
    """The SSD scan's forward and backward kernels against their plain
    versions at the zamba2-1.2b training shapes (batch LMT_BATCH, its heads
    and state, chunks of ops.CHUNK) for each S in SSD_SEQS: y, the final
    and entry states, dx, dB, dC, ddt and dA, each to TOL_SSD of the
    larger of its largest and 1; each kernel a second time on the same
    inputs, bit for bit; kernel and plain times beside each bound.  No
    single PyTorch call computes the scan, so there is no library time."""
    import torch
    from repro_torch.kernels.ssm_scan import ops, ref
    from repro_torch.kernels.ssm_scan import ssm_scan as ssd
    di = cfg.ssm.expand * cfg.d_model
    H, P, N = di // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.state_dim
    Bt, L = LMT_BATCH, ops.CHUNK
    rows = []
    n0 = (ssd.FWD_LAUNCHES, ssd.BWD_LAUNCHES)
    for S in SSD_SEQS:
        x, B, C, dt, A, dy = ssd_inputs(Bt, S, H, P, N, seed=29 + S)
        fwd = ssd.ssm_scan_fwd(x, B, C, dt, A, chunk=L,
                               return_chunk_states=True)
        bwd = ssd.ssm_scan_bwd(x, B, C, dt, A, fwd[2], dy, chunk=L)
        pf = ref.ssd_fwd_ref(x, B, C, dt, A, chunk=L)
        pb = ref.ssd_bwd_ref(x, B, C, dt, A, pf[2], dy, chunk=L)
        again = (ssd.ssm_scan_fwd(x, B, C, dt, A, chunk=L,
                                  return_chunk_states=True)
                 + ssd.ssm_scan_bwd(x, B, C, dt, A, fwd[2], dy, chunk=L))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(fwd + bwd, again))
        finite = all(bool(torch.isfinite(t).all()) for t in fwd + bwd)
        bounds = ssd_work(Bt, S, H, P, N, L)
        outs = {"ssd_fwd": (("y", "final_state", "chunk_states"), fwd, pf),
                "ssd_bwd": (("dx", "dB", "dC", "ddt", "dA"), bwd, pb)}
        times = {
            "ssd_fwd": (lambda: ssd.ssm_scan_fwd(
                x, B, C, dt, A, chunk=L, return_chunk_states=True),
                lambda: ref.ssd_fwd_ref(x, B, C, dt, A, chunk=L)),
            "ssd_bwd": (lambda: ssd.ssm_scan_bwd(x, B, C, dt, A, fwd[2], dy,
                                                 chunk=L),
                        lambda: ref.ssd_bwd_ref(x, B, C, dt, A, pf[2], dy,
                                                chunk=L)),
        }
        for name, (names, got, want) in outs.items():
            errs, abs_err = {}, 0.0
            for n, a, b in zip(names, got, want):
                e = float((a - b).abs().max())
                abs_err = max(abs_err, e)
                errs[n] = e / max(float(b.abs().max()), 1.0)
            ms_k, ms_p = (cuda_ms(f) for f in times[name])
            bound, by, nbytes, flops = bounds[name]
            rows.append({"kernel": name, "seq": S,
                         "shape": [Bt, S, H, P, N], "chunk": L,
                         "max_abs_err": abs_err, "errors": errs,
                         "max_err_of_largest": max(errs.values()),
                         "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
                         "bound_ms": bound, "bound_by": by,
                         "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
                         "repeat_identical": same})
            worst = max(errs, key=errs.get)
            print(f"  {name} S={S:<5d} worst {worst} {errs[worst]:.2e} of "
                  f"its largest (tolerance {TOL_SSD[name]}); kernel_ms="
                  f"{ms_k:.4f} plain_ms={ms_p:.4f} bound_ms={bound:.4f} "
                  f"({by}, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
                  f"repeat bit-identical: {same}", flush=True)
            check(errs[worst] <= TOL_SSD[name],
                  f"{name} S={S}: kernel disagrees with plain ({errs})")
        check(same, f"SSD kernels S={S}: a second run differs")
        check(finite, f"SSD kernels S={S}: non-finite output")
        del x, B, C, dt, A, dy, fwd, bwd, pf, pb, again
    # launches made to compare and time are not main-path launches
    ssd.FWD_LAUNCHES, ssd.BWD_LAUNCHES = n0
    return rows


def train_launches(cfg, steps=1):
    """{kernel: launches} that ``steps`` training steps of ``cfg`` make with
    remat: per attention layer 2 ``flash_fwd`` (forward and recompute) and
    one of each backward kernel; per Mamba2 layer 2 ``ssd_fwd`` and one
    ``ssd_bwd``.  The dense family's attention layers are its n_layers;
    Zamba2's are its shared block's applications (after layers 0, k,
    2k, ... for k = shared_attn_every)."""
    if cfg.ssm is not None:
        attn = len(range(0, cfg.n_layers, max(cfg.shared_attn_every, 1)))
        mamba = cfg.n_layers
    else:
        attn, mamba = cfg.n_layers, 0
    per = {"flash_fwd": 2 * attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
           "ssd_fwd": 2 * mamba, "ssd_bwd": mamba}
    return {k: v * steps for k, v in per.items()}


def train_counts(reset=False):
    """{kernel: launches so far} of the five training kernels, each set to
    0 first when ``reset``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssm_scan import ssm_scan as ssd
    if reset:
        fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        ssd.FWD_LAUNCHES = ssd.BWD_LAUNCHES = 0
    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES, "ssd_fwd": ssd.FWD_LAUNCHES,
            "ssd_bwd": ssd.BWD_LAUNCHES}


def device_split(kernels):
    """Device ms of a profiled step by kind, from ``device_kernels``: the
    GEMMs (cuBLAS / CUTLASS names: gemm, gemv, split-K), the SSD kernels,
    the attention kernels, PyTorch's elementwise kernels and the rest."""
    out = {"gemm": 0.0, "ssd": 0.0, "attention": 0.0, "elementwise": 0.0,
           "other": 0.0}
    for k in kernels:
        name = k["kernel"].lower()
        if "ssd_fwd" in name or "ssd_bwd" in name:
            kind = "ssd"
        elif "flash_" in name:
            kind = "attention"
        elif any(w in name for w in ("gemm", "gemv", "splitk")):
            kind = "gemm"
        elif "elementwise" in name:
            kind = "elementwise"
        else:
            kind = "other"
        out[kind] += k["ms"]
    return out


def lm_train_check_phase(cfg):
    """One LM training step (qwen2-1.5b or zamba2-1.2b), card (kernels) vs
    CPU (plain versions), from the same parameters (seed 0) and tokens
    (numpy): full width, depth cut to LMT_CHECK_LAYERS (the CPU side sets
    the cut), batch LMT_CHECK_BATCH x seq LMT_CHECK_SEQ; AdamW on
    warmup_cosine(LMT_LR, 20, LMT_STEPS), clip 1.0.  Loss, grad norm, each
    gradient leaf (the step's own clipped gradient, read back from AdamW's
    first moment m = (1 - b1) g; a leaf the loss never reads, Zamba2's
    shared attn/wo, must be exactly 0 on both sides) and each AdamW update
    leaf, leaf by leaf."""
    import torch
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate.precision import get_policy, tree_map
    from repro_torch.train import steps as steps_lib
    cut = dataclasses.replace(cfg, n_layers=LMT_CHECK_LAYERS)
    model = api.get_model(cut)
    params = model.init(torch.Generator().manual_seed(0), cut, "cpu")
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (LMT_CHECK_BATCH, LMT_CHECK_SEQ)).astype(np.int32)
    schedule = opt_lib.warmup_cosine(LMT_LR, 20, LMT_STEPS)
    lr1 = float(schedule(torch.ones((), dtype=torch.int32)))
    b1 = 0.9
    opt = opt_lib.adamw(schedule, b1=b1, eps=ADAM_EPS)
    step = steps_lib.make_train_step(model, cut, opt, get_policy("f32"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        n0 = train_counts()
        t0 = time.perf_counter()
        new_p, new_s, metrics = step(p, opt.init(p),
                                     {"tokens": torch.from_numpy(tokens).to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = {k: v - n0[k] for k, v in train_counts().items()}
        upd = tree_map(lambda a, b: (a - b).cpu(), new_p, p)
        grads = tree_map(lambda m: m.cpu() / (1 - b1), new_s["m"])
        out[dev] = (grads, upd, {k: float(v) for k, v in metrics.items()}, n,
                    secs)
    (g_c, u_c, m_c, n_c, s_c), (g_g, u_g, m_g, n_g, s_g) = \
        out["cpu"], out["cuda"]
    loss_err = abs(m_g["loss"] - m_c["loss"]) / abs(m_c["loss"])
    norm_err = abs(m_g["grad_norm"] - m_c["grad_norm"]) / m_c["grad_norm"]
    p_of = dict(leaf_items(layer_tree(params)))
    grad_err, upd_err, upd_raw, decided = {}, {}, {}, {}
    for (path, gc), (_, gg), (_, uc), (_, ug) in zip(
            leaf_items(layer_tree(g_c)), leaf_items(layer_tree(g_g)),
            leaf_items(layer_tree(u_c)), leaf_items(layer_tree(u_g))):
        g_top, g_diff = float(gc.abs().max()), float((gg - gc).abs().max())
        # a leaf with no gradient on the CPU must have none on the card
        grad_err[path] = (g_diff / g_top if g_top > 0
                          else 0.0 if g_diff == 0 else float("inf"))
        diff, top = (ug - uc).abs(), float(uc.abs().max())
        adam = adam_allowance(gg, gc, lr1)
        allow = adam + F32_SPACING * p_of[path].abs()
        upd_err[path] = float((diff - allow).clamp_min(0).max()) / top
        upd_raw[path] = float(diff.max()) / top
        decided[path] = float((adam > LMT_UPD_TOL * top).float().mean())
    worst_g = max(grad_err, key=grad_err.get)
    worst_u = max(upd_err, key=upd_err.get)
    worst_r = max(upd_raw, key=upd_raw.get)
    print(f"  {LMT_CHECK_LAYERS} of {cfg.n_layers} layers at full width, "
          f"batch {LMT_CHECK_BATCH} x seq {LMT_CHECK_SEQ}, f32: card "
          f"{s_g:.2f} s, CPU {s_c:.2f} s for the step; loss "
          f"{m_g['loss']:.6f} vs {m_c['loss']:.6f} (rel {loss_err:.2e}), "
          f"grad norm {m_g['grad_norm']:.6f} vs {m_c['grad_norm']:.6f} (rel "
          f"{norm_err:.2e}); tolerance {LMT_LOSS_TOL}", flush=True)
    print(f"  gradient leaves: worst {worst_g} {grad_err[worst_g]:.2e} of its "
          f"largest (tolerance {LMT_GRAD_TOL}); AdamW update leaves: worst "
          f"{worst_u} {upd_err[worst_u]:.2e} of its largest beyond what "
          f"Adam's first step makes of the gradients' difference (tolerance "
          f"{LMT_UPD_TOL}) and one f32 spacing at the param; raw, worst "
          f"{worst_r} {upd_raw[worst_r]:.2e}; elements where that allowance "
          f"passes {LMT_UPD_TOL} of the largest: at most "
          f"{100 * max(decided.values()):.3f}% of a leaf; "
          f"launches on the card: {n_g}", flush=True)
    want_n = train_launches(cut)
    check(loss_err <= LMT_LOSS_TOL and norm_err <= LMT_LOSS_TOL,
          f"LM step card vs CPU: loss {loss_err}, grad norm {norm_err}")
    check(grad_err[worst_g] <= LMT_GRAD_TOL,
          f"LM step card vs CPU: gradient {worst_g} {grad_err[worst_g]}")
    check(upd_err[worst_u] <= LMT_UPD_TOL,
          f"LM step card vs CPU: update {worst_u} {upd_err[worst_u]}")
    check(n_g == want_n and not any(n_c.values()),
          f"LM check launches {n_g} (want {want_n}), CPU {n_c}")
    return {"loss": [m_g["loss"], m_c["loss"]], "loss_err": loss_err,
            "grad_norm_err": norm_err, "grad_err": grad_err,
            "update_err": upd_err, "update_err_raw": upd_raw,
            "update_rounding_share": decided, "card_s": s_g, "cpu_s": s_c,
            "launches": n_g}


def adam_allowance(a, b, lr):
    """The most by which Adam's first step, lr * g / (|g| + ADAM_EPS), can
    differ at gradients a and b: lr * eps |a - b| / (d + eps)^2, d the
    distance from 0 to the interval [a, b] (the slope's largest there)."""
    import torch
    d = torch.where(a * b > 0, torch.minimum(a.abs(), b.abs()),
                    torch.zeros_like(a))
    return lr * ADAM_EPS * (a - b).abs() / (d + ADAM_EPS) ** 2


def layer_tree(params):
    """The LM tree with its list of per-layer dicts (``blocks`` or
    ``mamba``) keyed ``<key>/<i>``."""
    return {k: ({str(i): b for i, b in enumerate(v)} if isinstance(v, list)
                else v) for k, v in params.items()}


def lm_train_phase(cfg, card):
    """An LM training main path: full-width qwen2-1.5b or zamba2-1.2b from
    seed 0 through ``Engine.fit`` on ``lm_task`` (f32, AdamW on
    warmup_cosine(LMT_LR, 20, steps), clip 1.0, remat), batch LMT_BATCH x
    seq LMT_SEQ of ``MarkovTokens`` made before the timed window, LMT_WARMUP
    + LMT_STEPS steps; counts reset just before and read just after; then
    the same step twice from one state, bit for bit, and one profiled step
    with its device time split by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import MarkovTokens
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate.precision import get_policy, tree_leaves
    from repro_torch.train import engine as engine_lib

    n = LMT_WARMUP + LMT_STEPS
    data = MarkovTokens(cfg.vocab, seed=0)
    batches = [{"tokens": data.sample(LMT_BATCH, LMT_SEQ)} for _ in range(n)]
    task = engine_lib.lm_task(
        api.get_model(cfg), cfg,
        opt_lib.adamw(opt_lib.warmup_cosine(LMT_LR, 20, n)),
        policy=get_policy("f32"))
    eng = engine_lib.Engine("cuda")
    t0 = time.perf_counter()
    # held only by this list, popped into fit: no second copy of the
    # state stays alive through the steps (it would count in the peak)
    init = [task.init(torch.Generator(device="cuda").manual_seed(0), "cuda")]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stamps = []

    def hook(gstep, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # the main path: counts reset just before, read just after
    train_counts(reset=True)
    t_start = time.perf_counter()
    state, metrics = eng.fit(task, batches, n, seed=0, state=init.pop(),
                             hooks=(hook,))
    counts = train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    step_ms = [1e3 * (b - a) for a, b in zip([t_start] + stamps, stamps)]
    timed = step_ms[LMT_WARMUP:]
    med = float(np.median(timed))
    spread = (max(timed) - min(timed)) / med
    tok_s = LMT_BATCH * LMT_SEQ / med * 1e3
    m = {k: float(v) for k, v in metrics.items()}
    want = train_launches(cfg, n)
    print(f"  {cfg.arch_id}: {n_params:,} params, init on the card "
          f"{init_s:.1f} s; {n} steps ({LMT_WARMUP} warm-up) of batch "
          f"{LMT_BATCH} x seq {LMT_SEQ}: step wall ms "
          f"{[round(t, 1) for t in step_ms]}; median of {LMT_STEPS} "
          f"{med:.1f} ms, spread (max-min)/median {100 * spread:.1f}%, "
          f"{tok_s:.0f} tokens/s; peak memory {peak_gb:.2f} GB [{card}]",
          flush=True)
    print(f"  launches: {counts} over {n} steps (want {want}: per step "
          f"{train_launches(cfg)}, the forward kernels twice with remat); "
          f"last step loss {m['loss']:.4f}, grad norm {m['grad_norm']:.4f}",
          flush=True)
    check(counts == want, f"LM training launches {counts} (want {want})")
    check(all(math.isfinite(v) for v in m.values()), f"LM metrics {m}")

    # the same step twice from one state: bit for bit (the first result
    # waits on the host, so two results never share the card)
    step = task.make_step()
    dev_batch = {"tokens": torch.as_tensor(batches[0]["tokens"]).cuda()}
    a, _ = step(state, dev_batch, None)
    a_host = [t.cpu() for t in tree_leaves([a.params, a.opt_state])]
    del a
    b, _ = step(state, dev_batch, None)
    same = sum(1 for x, y in zip(a_host, tree_leaves([b.params,
                                                      b.opt_state]))
               if torch.equal(x, y.cpu()))
    print(f"  the same step twice from one state: {same} of {len(a_host)} "
          f"param and AdamW leaves bit-identical", flush=True)
    check(same == len(a_host), "two runs of an LM step differ")
    del a_host, b

    # one profiled step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out, _ = step(state, dev_batch, None)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    del out
    kernels = device_kernels(prof)
    busy = sum(k["ms"] for k in kernels)
    by_name = {name: sum(k["ms"] for k in kernels if name + "_kernel"
                         in k["kernel"])
               for name in TRAIN_KERNELS if want[name]}
    split = device_split(kernels)
    print(f"  one f32 step, batch already on the card: wall {wall:.1f} ms",
          flush=True)
    if kernels:
        print(f"  device busy {busy:.1f} ms = {100 * busy / wall:.1f}% of "
              f"wall; by kind (ms) "
              f"{ {k: round(v, 2) for k, v in split.items()} }; the path's "
              f"kernels {by_name}; by kernel:", flush=True)
        for k in kernels[:14]:
            print(f"    {k['ms']:9.3f} ms  x{k['count']:<5d} {k['kernel']}",
                  flush=True)
    else:
        print("  device time: not measured (the profiler saw no device "
              "activity)", flush=True)
    return {"params": n_params, "steps": n, "step_ms": step_ms,
            "median_ms": med, "spread": spread, "tokens_per_s": tok_s,
            "peak_gb": peak_gb, "init_s": init_s, "counts": counts,
            "metrics": m, "repeat_identical": same,
            "profile": {"wall_ms": wall,
                        "device_ms": busy if kernels else None,
                        "kernel_ms": by_name if kernels else None,
                        "split_ms": split if kernels else None,
                        "kernels": kernels[:14]}}


def train_attention_entry(rows, name, source, replaces, launches, steps):
    """The kernels-line entry of one training attention kernel: its f32 row
    at the path's shapes (the main path runs f32), the bf16 error beside
    it."""
    r = next(r for r in rows if r["kernel"] == name
             and r["dtype"] == "float32")
    rb = next(r for r in rows if r["kernel"] == name
              and r["dtype"] == "bfloat16")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_step": launches // steps,
            "max_abs_err": r["max_abs_err"],
            "max_err_of_largest": r["max_err_of_largest"],
            "max_err_of_largest_bf16": rb["max_err_of_largest"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r["library"],
            "library_fwd_bwd_ms": r["library_fwd_bwd_ms"],
            "timed": "one f32 call at the LM training path's shapes"}


def ssd_entry(rows, name, source, replaces, launches, steps):
    """The kernels-line entry of one SSD scan kernel: its row at the
    training path's shapes (S = LMT_SEQ), the worst error over every S it
    was held at beside it."""
    r = next(r for r in rows if r["kernel"] == name and r["seq"] == LMT_SEQ)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_step": launches // steps,
            "max_abs_err": r["max_abs_err"],
            "max_err_of_largest": r["max_err_of_largest"],
            "max_err_of_largest_all_seqs": max(
                x["max_err_of_largest"] for x in rows if x["kernel"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan",
            "timed": "one f32 call at the zamba2-1.2b training shapes"}


def attention_entry(rows, kind, source, replaces, launches):
    """The kernels-line entry of one attention kernel: its f32 row at the
    path's shapes (the main path runs f32), the bf16 error beside it."""
    r = next(r for r in rows if r["kernel"] == kind
             and r["dtype"] == "float32")
    rb = next(r for r in rows if r["kernel"] == kind
              and r["dtype"] == "bfloat16")
    return {"name": kind, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16": rb["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "timed": "one f32 call at the LM main path's shapes"}


def main() -> int:
    import torch
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip smoke: no src/repro_torch beside {__file__}: run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import base as lm_base
    from repro_torch.configs import calo3dgan
    from repro_torch.core import adversarial
    from repro_torch.kernels import build
    from repro_torch.kernels.conv3d import conv3d as conv_mod

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # every comparison in full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for stem, log in build.build_logs.items():
        print(f"  nvcc {stem}:\n" + "\n".join(
            "    " + line for line in log.strip().splitlines()), flush=True)

    cfg = calo3dgan.config()
    phases = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        return out

    print("forward kernel vs plain (TF32 off):", flush=True)
    rows = timed("forward", kernel_phase, cfg)
    print("standalone gemm vs plain, with cuBLAS as the yardstick "
          "(N(0, 1) inputs, TF32 off):", flush=True)
    gemm_rows, gemm_launches = timed(
        "gemm", gemm_phase,
        gemm_shapes(cfg, lm_base.get_config("qwen2-1.5b"),
                    lm_base.get_config("zamba2-1.2b")))
    print("dx (forward kernel) and dw (dw kernel) vs plain (TF32 off):",
          flush=True)
    grad_rows = timed("gradients", grad_phase, cfg)
    print("serving attention kernels vs plain at the qwen2-1.5b shapes "
          "(N(0, 1) inputs, TF32 off):", flush=True)
    attn_rows = timed("attention", attention_phase,
                      lm_base.get_config("qwen2-1.5b"))
    print("decode split counts (the same shapes):", flush=True)
    splits = timed("decode_splits", decode_split_phase,
                   lm_base.get_config("qwen2-1.5b"))
    print("serving end to end (full calo3dgan.config(), f32 policy):",
          flush=True)
    e2e = timed("serve", e2e_phase, cfg, card)
    print("serving profile (full calo3dgan.config(), f32 policy):",
          flush=True)
    e2e["profile"] = timed("serve_profile", profile_phase, cfg)
    print("training step, card vs CPU (full calo3dgan.config()):",
          flush=True)
    check_step = timed("check_step", check_step_phase, cfg)
    print(f"training main path (full calo3dgan.config(), bf16, batch "
          f"{BATCH}, RMSprop 1e-4):", flush=True)
    train = timed("train", train_phase, cfg, card)
    lm_cfg = lm_base.get_config("qwen2-1.5b")
    print(f"qwen2-1.5b (full width, random weights), card vs CPU:",
          flush=True)
    lm_params, lm_check = timed("lm_check", lm_check_phase, lm_cfg, card)
    print(f"LM serving main path (full qwen2-1.5b, f32, {LM_SLOTS} slots, "
          f"{LM_MAX_LEN} positions, chunks of {LM_CHUNK}):", flush=True)
    lm_serve = timed("lm_serve", lm_serve_phase, lm_cfg, lm_params, card)
    del lm_params
    torch.cuda.empty_cache()
    print(f"LM training attention kernels vs plain at the qwen2-1.5b "
          f"training shapes (batch {LMT_BATCH} x seq {LMT_SEQ}, causal, "
          f"N(0, 1) inputs, TF32 off):", flush=True)
    train_attn_rows = timed("train_attention", train_attention_phase, lm_cfg)
    print("LM training step, card vs CPU (qwen2-1.5b at full width, depth "
          "cut):", flush=True)
    lm_train_check = timed("lm_train_check", lm_train_check_phase, lm_cfg)
    print(f"LM training main path (full qwen2-1.5b, f32, AdamW, batch "
          f"{LMT_BATCH} x seq {LMT_SEQ}, remat):", flush=True)
    lm_train = timed("lm_train", lm_train_phase, lm_cfg, card)
    # the qwen2 training state went with its phase: free its cache
    torch.cuda.empty_cache()
    z_cfg = lm_base.get_config("zamba2-1.2b")
    print(f"SSD scan kernels vs plain at the zamba2-1.2b training shapes "
          f"(batch {LMT_BATCH}, S in {SSD_SEQS}, N(0, 1) inputs):",
          flush=True)
    ssd_rows = timed("ssd", ssd_phase, z_cfg)
    print("Zamba2 training step, card vs CPU (zamba2-1.2b at full width, "
          "depth cut):", flush=True)
    z_train_check = timed("zamba_train_check", lm_train_check_phase, z_cfg)
    print(f"Zamba2 training main path (full zamba2-1.2b, f32, AdamW, batch "
          f"{LMT_BATCH} x seq {LMT_SEQ}, remat):", flush=True)
    z_train = timed("zamba_train", lm_train_phase, z_cfg, card)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phases.items()),
          flush=True)

    counts = adversarial.conv_launches_by_layer(cfg)
    # set to 0 after the gemm phase: no model path calls gemm()
    check(conv_mod.GEMM_LAUNCHES == 0,
          f"gemm: {conv_mod.GEMM_LAUNCHES} launches on the model paths")
    gemm = gemm_entry(gemm_rows, gemm_launches, conv_mod.GEMM_LAUNCHES)
    fwd = kernel_entry(rows, e2e["launches"] + train["fwd_launches"])
    serve = {k: fwd[k] for k in ("ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by")}
    serve.update(launches=e2e["launches"],
                 timed="one f32 bucket-128 generator pass, 4 launches")
    fwd_train = per_step(rows + grad_rows, counts, ("fwd", "dx"))
    fwd_train.update(steps=train["steps"], launches=train["fwd_launches"],
                     launches_per_step=fwd_train.pop("launches"),
                     profiled_ms=train["profile"]["conv3d_fwd_ms"],
                     timed="one bf16 training step at batch 128, the "
                           "per-layer fwd and dx times by launches")
    fwd["by_path"] = {"serve": serve, "train": fwd_train}
    dw_rows = [r for r in grad_rows if r["kind"] == "dw"]
    dw_step = per_step(grad_rows, counts, ("dw",))
    dw = {"name": "conv3d_dw", "route": "cuda",
          "source": "src/repro_torch/kernels/conv3d/csrc/conv3d_dw.cu",
          "replaces": "src/repro/kernels/conv3d/conv3d.py:292",
          "launches": train["dw_launches"],
          "max_abs_err": max(r["max_abs_err"] for r in dw_rows),
          "max_err_of_largest": max(r["max_abs_err"] / r["max_abs_ref"]
                                    for r in dw_rows),
          "ms": dw_step["ms"], "plain_ms": dw_step["plain_ms"],
          "bound_ms": dw_step["bound_ms"], "bound_by": dw_step["bound_by"],
          "library_ms": dw_step["library_ms"],
          "launches_per_step": dw_step["launches"],
          "profiled_ms": train["profile"]["conv3d_dw_ms"],
          "timed": "one bf16 training step at batch 128, the per-layer "
                   "dw times by launches"}
    fa_dir = "src/repro_torch/kernels/flash_attention/csrc/"
    chunk = attention_entry(
        attn_rows, "flash_chunk", fa_dir + "flash_chunk.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:183",
        lm_serve["counts"]["flash_chunk"])
    decode = attention_entry(
        attn_rows, "flash_decode", fa_dir + "flash_decode.cu",
        "src/repro/kernels/flash_attention/decode.py:104",
        lm_serve["counts"]["flash_decode"])
    train_kernels = [
        train_attention_entry(
            train_attn_rows, name, fa_dir + src,
            "src/repro/kernels/flash_attention/flash_attention.py:" + line,
            lm_train["counts"][name], lm_train["steps"])
        for name, src, line in (("flash_fwd", "flash_fwd.cu", "43"),
                                ("flash_bwd_dq", "flash_bwd.cu", "338"),
                                ("flash_bwd_dkv", "flash_bwd.cu", "380"))]
    for entry in train_kernels:
        entry["launches_by_path"] = {
            "qwen2_train": lm_train["counts"][entry["name"]],
            "zamba2_train": z_train["counts"][entry["name"]]}
    ssd_kernels = [
        ssd_entry(ssd_rows, name,
                  "src/repro_torch/kernels/ssm_scan/csrc/" + name + ".cu",
                  "src/repro/kernels/ssm_scan/ssm_scan.py:" + line,
                  z_train["counts"][name], z_train["steps"])
        for name, line in (("ssd_fwd", "42"), ("ssd_bwd", "160"))]
    os.makedirs(os.path.join(ROOT, "results"), exist_ok=True)
    with open(os.path.join(ROOT, "results", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "layers": rows + grad_rows, "e2e": e2e,
                   "check_step": check_step, "train": train,
                   "attention": attn_rows, "decode_splits": splits,
                   "lm_check": lm_check, "lm_serve": lm_serve,
                   "train_attention": train_attn_rows,
                   "lm_train_check": lm_train_check, "lm_train": lm_train,
                   "ssd": ssd_rows, "zamba_train_check": z_train_check,
                   "zamba_train": z_train, "gemm": gemm_rows,
                   "phase_s": phases}, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"kernels": [fwd, dw, chunk, decode, *train_kernels,
                                  *ssd_kernels, gemm]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
