"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   into ``build/kernels/`` and prints the build time;
3. holds the conv3d kernel, through the public entry points
   ``conv3d_fwd`` / ``conv3d_transpose_fwd``, against their plain PyTorch
   versions at the four generator-layer geometries of the full
   ``calo3dgan.config()`` at bucket 128, plus the discriminator's stride-2
   Ci=1 input layer, in f32 and bf16 with TF32 off, and times kernel,
   plain version and one cuDNN call;
4. serves a window of full-width requests through ``SimulateEngine`` on
   the card (the main path: conv launch count reset just before, read just
   after) and checks the results (exact event counts, finite non-negative
   showers, 4 conv kernel launches per bucket step, packing invariance,
   agreement with the plain-version generator on the CPU); serves the same
   window twice more for the spread of events/s, then an open-loop run of
   Poisson arrivals for request latency;
5. profiles one bucket-128 step (device time by kernel, busy share);
6. prints the kernels' JSON line, the card line again, and as its last
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no ok
line.  It needs a CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

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
    of the full generator at bucket 128, plus the discriminator's input
    conv (the next slice's first layer)."""
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
    out.append(("disc_conv0", (BATCH, *cfg.image_shape, 1),
                (3, 3, 3, 1, cfg.disc_channels[0]), 2, False, "none"))
    return out


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
            and r["layer"].startswith("gen_")]
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
    forward conv needs symmetric pads, which every geometry here has."""
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
        check(all(lo == hi for lo, hi in pads), f"asymmetric pads {pads}")
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
            row = {"layer": name, "dtype": dname, "x": list(xs),
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
# end to end
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import calo3dgan
    from repro_torch.kernels import build

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
    print("kernel vs plain (TF32 off):", flush=True)
    rows = kernel_phase(cfg)
    print("end to end (full calo3dgan.config(), f32 policy):", flush=True)
    e2e = e2e_phase(cfg, card)
    print("profile (full calo3dgan.config(), f32 policy):", flush=True)
    e2e["profile"] = profile_phase(cfg)

    entry = kernel_entry(rows, e2e["launches"])
    print(json.dumps({"layers": rows, "e2e": e2e}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
