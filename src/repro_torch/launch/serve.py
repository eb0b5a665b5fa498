"""Serving launcher of the port: 3DGAN fast simulation or LM continuous
batching, on the card.

Two routes, selected by ``--model``:

- ``--model gan`` (default) — calorimeter showers from a 3DGAN generator
  (restored from a checkpoint, or random when none is given) through the
  bucketed engine (`serve/simulate.py`), with the rolling physics gate
  checking every window against fresh Monte Carlo.  Every generator conv
  runs through the CUDA conv kernel.
- ``--model lm`` — batched-request greedy decode of a dense language model
  (random weights from ``--seed``) through the slot engine
  (`serve/engine.py`): chunked prefill and split-KV decode run through
  the CUDA attention kernels.

Both run on the card unless given ``--device cpu`` (the plain versions of
the kernels, no launches).

Usage:
  python -m repro_torch.launch.serve --model gan --full
  python -m repro_torch.launch.serve --device cpu --reduced --requests 4
  python -m repro_torch.launch.serve --full --ckpt ckpts/gan  # a generator
      # saved by the JAX package's launch/train --ckpt loads unchanged
  python -m repro_torch.launch.serve --model lm --arch qwen2-1.5b --full \
      --slots 8 --max-len 1024 --prompt-len 512 --max-new 32 --requests 32
  python -m repro_torch.launch.serve --model lm --device cpu --reduced
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def serve_gan(args):
    from repro_torch.configs import calo3dgan
    from repro_torch.core import gan, validation
    from repro_torch.data.calo import CaloSimulator, CaloSpec
    from repro_torch.kernels.conv3d import conv3d
    from repro_torch.serve.scheduler import SchedulerConfig
    from repro_torch.serve.simulate import (PhysicsGate, SimRequest,
                                            SimulateEngine)
    from repro_torch.train import checkpoint as ckpt_lib

    cfg = calo3dgan.reduced() if args.reduced else calo3dgan.config()
    if args.ckpt and os.path.exists(os.path.join(args.ckpt, "arrays.npz")):
        params = ckpt_lib.restore_gan_generator(args.ckpt, cfg, args.device)
        policy_name = ckpt_lib.manifest_precision(args.ckpt)
        print(f"restored generator from {args.ckpt} "
              f"(step {ckpt_lib.latest_step(args.ckpt)}, "
              f"precision={policy_name})")
    else:
        params = gan.init_generator(torch.Generator().manual_seed(args.seed),
                                    cfg, args.device)
        policy_name = "f32"
        print("WARNING: no --ckpt given (or not found) — serving an "
              "UNTRAINED generator; the physics gate will show it")

    sim = CaloSimulator(CaloSpec(image_shape=cfg.image_shape),
                        seed=args.seed + 1)
    mc = next(sim.batches(max(args.gate_window, 256)))
    gate = PhysicsGate(validation.reference_profiles(mc["image"], mc["e_p"]),
                       window=args.gate_window)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    sched = None
    if args.sla_s > 0 and args.drain_rate > 0:
        sched = SchedulerConfig.for_sla(args.drain_rate, args.sla_s,
                                        promote_after_steps=args.promote_after)
    elif args.promote_after > 0:
        sched = SchedulerConfig(promote_after_steps=args.promote_after)
    eng = SimulateEngine(cfg, params, buckets=buckets, gate=gate,
                         policy_name=policy_name, sched=sched,
                         max_kl=args.max_kl, device=args.device)
    eng.warmup()

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(SimRequest(
            rid=rid,
            primary_energy=float(rng.uniform(10.0, 500.0)),
            n_events=int(rng.integers(1, args.max_events + 1)),
            seed=int(rng.integers(0, 2**31 - 1)),
            deadline_s=args.sla_s if args.sla_s > 0 else None,
            priority=int(rng.integers(0, args.priorities))))
    launches0 = conv3d.LAUNCHES
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    gate.flush()
    n_ev = eng.stats["events_generated"]
    lats = sorted(r.latency_s for r in done)

    def pct(q):   # empty-safe percentile
        return 1e3 * lats[min(len(lats) - 1, int(len(lats) * q))] if lats \
            else 0.0

    where = (f"{torch.cuda.get_device_name(0)}" if eng.device.type == "cuda"
             else "cpu (plain conv, no kernel)")
    print(f"served {len(done)} requests / {n_ev} events in {dt:.2f}s "
          f"({n_ev / dt:.1f} events/s) on {where}; "
          f"latency p50={pct(0.50):.0f}ms p99={pct(0.99):.0f}ms")
    print(f"  steps={eng.stats['steps']} bucket_steps="
          f"{eng.stats['bucket_steps']} padded={eng.stats['padded_events']} "
          f"transfers={eng.stats['device_transfers']} "
          f"conv_kernel_launches={conv3d.LAUNCHES - launches0}")
    if eng.rejected:
        print(f"  rejected {len(eng.rejected)} requests:")
        for r in eng.rejected[:8]:
            print(f"    req {r.rid}: {r.error['reason']} — "
                  f"{r.error['detail']}")
    report = eng.degraded_report()
    if report["mode"] != "healthy":
        print(f"  DEGRADED: {report['mode']} shed={report['shed']}")
    for i, rep in enumerate(gate.reports):
        print(f"  gate window {i}: "
              + " ".join(f"{k}={rep[k]:.4f}" for k in
                         ("longitudinal_kl", "transverse_x_kl",
                          "transverse_y_kl", "response_rel_err")))
    if gate.drifted(args.max_kl):
        print(f"  GATE: profile divergence exceeds --max-kl {args.max_kl} "
              "— generator drift (or an untrained generator)")
    return eng


def serve_lm(args):
    from repro_torch.configs import base as config_base
    from repro_torch.kernels.flash_attention import decode as decode_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = (config_base.reduced_config(args.arch) if args.reduced
           else config_base.get_config(args.arch))
    model = api.get_model(cfg)
    # a family the port does not serve yet refuses here, before any weights
    model.init_cache(cfg, 1, 1, device="cpu")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = model.init(gen, cfg, args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      device=args.device)
    del params
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab, plen,
                                               dtype=np.int32),
                           max_new_tokens=args.max_new))
    chunk0, decode0 = fa_mod.LAUNCHES, decode_mod.LAUNCHES
    t0 = time.perf_counter()
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.tokens) for r in done)
    where = (torch.cuda.get_device_name(0) if eng.device.type == "cuda"
             else "cpu (plain attention, no kernel)")
    print(f"served {len(done)} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s) on {where}")
    print(f"  prefill_launches={eng.stats['prefill_launches']} "
          f"decode_steps={eng.stats['decode_steps']} "
          f"chunk_kernel_launches={fa_mod.LAUNCHES - chunk0} "
          f"decode_kernel_launches={decode_mod.LAUNCHES - decode0}")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> {r.tokens[:8]}...")
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("gan", "lm"), default="gan",
                    help="gan: 3DGAN fast-simulation service; lm: "
                         "continuous-batching decode of a language model")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # lm route
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    # gan route
    ap.add_argument("--ckpt", default="",
                    help="generator checkpoint dir (launch/train --ckpt)")
    ap.add_argument("--max-events", type=int, default=64,
                    help="request sizes drawn uniformly from [1, max]")
    ap.add_argument("--buckets", default="8,32,128",
                    help="comma-separated fixed batch buckets")
    ap.add_argument("--gate-window", type=int, default=256,
                    help="events per physics-gate report")
    ap.add_argument("--max-kl", type=float, default=1.0,
                    help="drift threshold on the worst profile KL")
    ap.add_argument("--sla-s", type=float, default=0.0,
                    help="per-request latency SLA in seconds (0 = no "
                         "deadlines, no admission bound)")
    ap.add_argument("--drain-rate", type=float, default=0.0,
                    help="measured service throughput (events/s) used to "
                         "derive the admission bound from --sla-s")
    ap.add_argument("--promote-after", type=int, default=0,
                    help="age-based promotion after this many passed-over "
                         "bucket steps (0 = off)")
    ap.add_argument("--priorities", type=int, default=1,
                    help="draw request priorities uniformly from "
                         "[0, priorities)")
    args = ap.parse_args(argv)
    return serve_lm(args) if args.model == "lm" else serve_gan(args)


if __name__ == "__main__":
    main()
