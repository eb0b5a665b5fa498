"""Training launcher of the port: the 3DGAN (the paper's workload) on one
card, Algorithm 1 as a fused step through the single-device engine.

Every conv, forward and both gradients, runs a hand-written CUDA kernel on
``--device cuda`` (the default); ``--device cpu`` runs their plain
versions.  Then the physics validation of the trained generator against
fresh Monte Carlo, and with ``--ckpt`` the generator saved in the
reference's checkpoint format, which ``launch.serve --ckpt`` serves.

Usage:
  python -m repro_torch.launch.train --arch calo3dgan --steps 3
  python -m repro_torch.launch.train --device cpu --reduced --steps 2 \\
      --ckpt ckpts/gan && \\
  python -m repro_torch.launch.serve --device cpu --reduced --ckpt ckpts/gan
"""
from __future__ import annotations

import argparse
import time

import torch

# values the reference takes that the port does not yet, and where they wait
WAITS = {
    "arch": "the LM substrate and models (ROADMAP, Queue 4)",
    "custom": "the data-parallel slice (ROADMAP, Queue 4: mesh, "
              "collectives, ZeRO-1)",
    "naive": "the naive host-orchestrated loop (ROADMAP, Queue 4)",
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


def main(argv=None):
    from repro_torch.train.metrics import MetricLog

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="calo3dgan",
                    help="calo3dgan (the only architecture ported so far)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0)
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
                    help="f32|bf16|fp16; empty defers to the config (bf16)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="save the trained generator here")
    ap.add_argument("--log", default="")
    ap.add_argument("--log-every", type=int, default=1,
                    help="steps per metric window; >1 removes the "
                         "per-step device->host sync")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="force a device sync every N steps (0: never)")
    args = ap.parse_args(argv)
    if args.arch != "calo3dgan":
        raise NotImplementedError(
            f"--arch {args.arch}: the port trains calo3dgan only; the other "
            f"architectures wait for {WAITS['arch']}")
    if args.loop in ("custom", "naive"):
        raise NotImplementedError(
            f"--loop {args.loop} waits for {WAITS[args.loop]}")
    log = MetricLog(args.log or None, print_every=max(args.steps // 20, 1))
    return train_gan(args, log)


if __name__ == "__main__":
    main()
