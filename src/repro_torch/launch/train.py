"""Training launcher of the port, on one card through the single-device
engine: the 3DGAN (the paper's workload, Algorithm 1 as a fused step),
the dense language model ``qwen2-1.5b`` or the hybrid ``zamba2-1.2b``.

GAN: every conv, forward and both gradients, runs a hand-written CUDA
kernel on ``--device cuda`` (the default); then the physics validation of
the trained generator against fresh Monte Carlo, and with ``--ckpt`` the
generator saved in the reference's checkpoint format, which
``launch.serve --ckpt`` serves.  LM: AdamW on ``warmup_cosine(lr, 20,
steps)``, clip 1.0, remat, batches of ``MarkovTokens``; attention runs the
flash forward kernel (again in each block's recompute) and the dq and
dk/dv kernels, and each Zamba2 Mamba2 layer the SSD scan's forward kernel
(again in its recompute) and its backward kernel; ``--ckpt`` saves the
parameters as the reference does.  ``--device cpu`` runs every kernel's
plain version.

Usage:
  python -m repro_torch.launch.train --arch calo3dgan --steps 3
  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 3
  python -m repro_torch.launch.train --arch zamba2-1.2b --steps 3
  python -m repro_torch.launch.train --device cpu --reduced --steps 2 \\
      --ckpt ckpts/gan && \\
  python -m repro_torch.launch.serve --device cpu --reduced --ckpt ckpts/gan
"""
from __future__ import annotations

import argparse
import time

import torch

LM_ARCHS = ("qwen2-1.5b", "zamba2-1.2b")
# values the reference takes that the port does not yet, and where they wait
WAITS = {
    "arch": "the other LM families (ROADMAP.md, Queue 1, item 10)",
    "custom": "the data-parallel slice (ROADMAP.md, Queue 1, item 7: mesh, "
              "collectives, ZeRO-1)",
    "naive": "the naive host-orchestrated loop (ROADMAP.md, Queue 1, "
             "item 9)",
}


def train_gan(args, log):
    from repro_torch.configs import calo3dgan
    from repro_torch.core import gan, validation
    from repro_torch.data.calo import CaloSimulator, CaloSpec
    from repro_torch.kernels.conv3d import conv3d
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate.precision import get_policy
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import engine as engine_lib

    cfg = calo3dgan.reduced() if args.reduced else calo3dgan.config()
    precision = args.precision or cfg.precision
    g_opt = opt_lib.rmsprop(args.lr)
    d_opt = opt_lib.rmsprop(args.lr)
    sim = CaloSimulator(CaloSpec(image_shape=cfg.image_shape), seed=args.seed)
    B = args.batch or cfg.batch_size

    task = engine_lib.gan_task(cfg, g_opt, d_opt,
                               policy=get_policy(precision),
                               microbatches=args.microbatches)
    eng = engine_lib.Engine(args.device)
    fwd0, dw0 = conv3d.LAUNCHES, conv3d.DW_LAUNCHES
    t0 = time.perf_counter()
    state, _ = eng.fit(task, sim.batches(B), args.steps, seed=args.seed,
                       log=log, log_every=args.log_every,
                       sync_every=args.sync_every or None)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu (plain convs, no kernel)")
    print(f"{args.steps} steps of batch {B} ({precision}, "
          f"{'reduced' if args.reduced else 'full'} calo3dgan) in {dt:.2f}s "
          f"on {where}, Monte Carlo included; kernel launches: conv3d_fwd "
          f"{conv3d.LAUNCHES - fwd0}, conv3d_dw {conv3d.DW_LAUNCHES - dw0}")

    # physics validation vs fresh Monte Carlo
    mc = next(sim.batches(256))
    noise_gen = torch.Generator(device=eng.device).manual_seed(7)
    noise = torch.randn((256, cfg.latent_dim), generator=noise_gen,
                        device=eng.device)
    with torch.no_grad():
        fake = gan.generate(state.g_params, noise,
                            torch.as_tensor(mc["e_p"], device=eng.device),
                            torch.as_tensor(mc["theta"], device=eng.device),
                            cfg)
    rep = validation.validation_report(fake.cpu().numpy(), mc["image"],
                                       mc["e_p"], mc["e_p"])
    print("physics validation:", {k: round(v, 4) for k, v in rep.items()})
    if args.ckpt:
        ckpt_lib.save(args.ckpt, state.g_params, step=args.steps,
                      extra={"kind": "gan_generator",
                             "precision": precision})
        print(f"saved generator to {args.ckpt} (precision={precision})")
    return state


def train_lm(args, log):
    from repro_torch.configs import base as config_base
    from repro_torch.data.tokens import MarkovTokens
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssm_scan import ssm_scan as ssd
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.substrate.precision import get_policy, tree_leaves
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import engine as engine_lib

    cfg = (config_base.reduced_config(args.arch) if args.reduced
           else config_base.get_config(args.arch))
    model = api.get_model(cfg)
    policy = get_policy(args.policy or "f32")
    optimizer = opt_lib.adamw(opt_lib.warmup_cosine(args.lr, 20, args.steps))
    task = engine_lib.lm_task(model, cfg, optimizer, policy=policy,
                              microbatches=args.microbatches)
    eng = engine_lib.Engine(args.device)
    B, S = args.batch or 8, args.seq or 256
    data = MarkovTokens(cfg.vocab, seed=args.seed)
    n0 = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES,
          ssd.FWD_LAUNCHES, ssd.BWD_LAUNCHES)
    t0 = time.perf_counter()
    state, _ = eng.fit(task, data.batches(B, S), args.steps, seed=args.seed,
                       log=log, log_every=args.log_every,
                       sync_every=args.sync_every or None)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu (plain versions, no "
                                               "kernel)")
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"{args.arch}: {n_params:,} params "
          f"({'reduced' if args.reduced else 'full'}), "
          f"{args.policy or 'f32'}, batch {B} x seq {S}, microbatches "
          f"{args.microbatches}")
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps * B * S / dt:.0f} "
          f"tok/s, init and data included) on {where}; kernel launches: "
          f"flash_fwd {fa.FWD_LAUNCHES - n0[0]}, flash_bwd_dq "
          f"{fa.DQ_LAUNCHES - n0[1]}, flash_bwd_dkv {fa.DKV_LAUNCHES - n0[2]}"
          + (f", ssd_fwd {ssd.FWD_LAUNCHES - n0[3]}, ssd_bwd "
             f"{ssd.BWD_LAUNCHES - n0[4]}" if cfg.ssm is not None else ""))
    if args.ckpt:
        ckpt_lib.save(args.ckpt, state.params, step=args.steps,
                      extra={"arch": args.arch})
        print(f"saved params to {args.ckpt}")
    return state


def main(argv=None):
    from repro_torch.train.metrics import MetricLog

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="calo3dgan",
                    help="calo3dgan, qwen2-1.5b or zamba2-1.2b (the "
                         "architectures ported so far)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0,
                    help="0: the GAN config's batch, or 8 for an LM")
    ap.add_argument("--seq", type=int, default=0,
                    help="LM sequence length (0: 256)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", default="builtin",
                    choices=("builtin", "custom", "fused", "naive"),
                    help="builtin: the fused single-device loop; fused: "
                         "its legacy alias; custom and naive are not "
                         "ported yet")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation inside each step")
    ap.add_argument("--precision", default="",
                    help="GAN: f32|bf16|fp16; empty defers to the config "
                         "(bf16)")
    ap.add_argument("--policy", default="",
                    help="LM precision policy (f32|bf16); empty: f32")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="save the trained generator (GAN) or parameters "
                         "(LM) here")
    ap.add_argument("--log", default="")
    ap.add_argument("--log-every", type=int, default=1,
                    help="steps per metric window; >1 removes the "
                         "per-step device->host sync")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="force a device sync every N steps (0: never)")
    args = ap.parse_args(argv)
    if args.arch != "calo3dgan" and args.arch not in LM_ARCHS:
        raise NotImplementedError(
            f"--arch {args.arch}: the port trains calo3dgan and "
            f"{', '.join(LM_ARCHS)}; {args.arch} waits for "
            f"{WAITS.get(args.arch, WAITS['arch'])}")
    if args.loop in ("custom", "naive"):
        raise NotImplementedError(
            f"--loop {args.loop} waits for {WAITS[args.loop]}")
    log = MetricLog(args.log or None, print_every=max(args.steps // 20, 1))
    if args.arch == "calo3dgan":
        return train_gan(args, log)
    return train_lm(args, log)


if __name__ == "__main__":
    main()
