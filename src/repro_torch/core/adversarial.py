"""Algorithm 1 of the paper as one fused training step (the reference's
`core/adversarial.make_fused_step`): D on real, D on fake, then G twice.

The whole body runs on the training device: the generator inputs are
drawn there (from the step's ``torch.Generator``), the fakes are made
there, and each phase accumulates its gradients over ``microbatches``
before its one optimizer update.  Under a loss-scaling policy each
phase's loss is scaled before the backward pass, its UNSCALED gradients
are checked for finiteness, and a nonfinite phase keeps its params and
optimizer state and halves the scale.  Nothing in a step syncs the host.

The naive host-orchestrated loop of the reference (``NaiveStep``) is not
part of the port yet.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import gan
from repro_torch.optim import optimizers as opt_lib
from repro_torch.substrate import precision as precision_lib
from repro_torch.substrate.precision import tree_leaves, tree_map

THETA_RANGE = (math.radians(60.0), math.radians(120.0))
E_P_RANGE = (10.0, 500.0)


class GANState(NamedTuple):
    g_params: dict
    d_params: dict
    g_opt: dict
    d_opt: dict
    step: torch.Tensor          # int32 scalar
    # precision_lib.LossScaleState when the policy scales; else None
    loss_scale: Any = None


def init_state(gen: torch.Generator, cfg, g_optimizer, d_optimizer,
               policy=None, device="cuda") -> GANState:
    """Master params and optimizer state are ALWAYS f32; ``policy`` only
    adds the loss-scale state its scaling mode needs.  The generator's
    params are drawn from ``gen`` first, then the discriminator's."""
    g_params = gan.init_generator(gen, cfg, device)
    d_params = gan.init_discriminator(gen, cfg, device)
    return GANState(g_params, d_params, g_optimizer.init(g_params),
                    d_optimizer.init(d_params),
                    torch.zeros((), dtype=torch.int32, device=device),
                    precision_lib.init_loss_scale(policy, device))


def conv_launches_by_layer(cfg, microbatches: int = 1):
    """{(layer, kind): kernel launches in one fused step on a card}.
    ``layer`` is ``gen_up{i}``, ``gen_out`` or ``disc_conv{i}``; ``kind``
    is ``fwd`` or ``dx`` (both on the conv3d_fwd kernel) or ``dw``.
    D on real: the D convs, dx of all but the first (the batch needs no
    gradient), dw of all.  D on fake: the G convs (no gradient), then as
    D on real.  Each G step: G and D convs, dx of both, dw of G only (D
    is frozen).  Each phase runs once per microbatch."""
    n_g, M = cfg.gen_steps_per_disc, microbatches
    g_layers = [f"gen_up{i}" for i in range(len(cfg.gen_channels) - 1)]
    out = {}
    for name in g_layers + ["gen_out"]:
        out.update({(name, "fwd"): (1 + n_g) * M, (name, "dx"): n_g * M,
                    (name, "dw"): n_g * M})
    for i in range(len(cfg.disc_channels)):
        name = f"disc_conv{i}"
        out.update({(name, "fwd"): (2 + n_g) * M,
                    (name, "dx"): ((0 if i == 0 else 2) + n_g) * M,
                    (name, "dw"): 2 * M})
    return out


def conv_launches_per_step(cfg, microbatches: int = 1):
    """(conv3d_fwd, conv3d_dw) kernel launches in one fused step on a card:
    the sums of :func:`conv_launches_by_layer`."""
    counts = conv_launches_by_layer(cfg, microbatches)
    fwd = sum(n for (_, kind), n in counts.items() if kind != "dw")
    return fwd, sum(n for (_, kind), n in counts.items() if kind == "dw")


def draw_inputs(gen: torch.Generator, mb: int, latent: int):
    """Generator inputs of one microbatch from ``gen``, on its device:
    (noise (mb, latent) f32 N(0, 1), E_p uniform in GeV, theta uniform)."""
    dev = gen.device
    noise = torch.randn((mb, latent), generator=gen, device=dev)
    lo, hi = E_P_RANGE
    f_ep = lo + (hi - lo) * torch.rand((mb,), generator=gen, device=dev)
    lo, hi = THETA_RANGE
    f_th = lo + (hi - lo) * torch.rand((mb,), generator=gen, device=dev)
    return noise, f_ep, f_th


def _tensor(v, device, dtype=torch.float32):
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return torch.as_tensor(v).to(device=device, dtype=dtype)


def _unflatten(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def make_fused_step(cfg, g_optimizer, d_optimizer, policy=None,
                    grad_reduce=None, microbatches: int = 1,
                    sample_inputs: Optional[Callable] = None):
    """The full Algorithm-1 body as ``step(state, batch, gen) -> (state,
    metrics)``.

    ``policy``: the batch and both networks' params are cast to
    ``policy.compute_dtype`` at phase entry (every conv runs at compute
    precision, with f32 sums inside the kernels); losses, gradients,
    master params and optimizer state stay f32.  With ``policy.loss_scale``
    set, each phase runs the skip-on-nonfinite guard described above.

    ``grad_reduce``: applied to every phase's gradients before its update
    (identity on one device; the data-parallel slice passes a reduction).

    ``microbatches``: gradient accumulation inside each phase; the batch
    and the fake-input draws are split into this many microbatches.

    ``sample_inputs(phase_index, mb) -> (noise, e_p, theta)``: the
    generator inputs of one microbatch.  ``phase_index`` counts the draws
    of a step as the reference splits its key: ``m`` for microbatch ``m``
    of D-on-fake, ``M + j * M + m`` for microbatch ``m`` of G step ``j``.
    By default each call draws from the step's ``gen`` (:func:`draw_inputs`)
    in that order; tests pass numpy-made inputs instead.
    """
    M = int(microbatches)
    if M < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    reduce_grads = grad_reduce if grad_reduce is not None else (lambda g: g)
    compute_dtype = (policy.compute_dtype if policy is not None
                     else torch.float32)
    to_compute = (policy.cast_to_compute if policy is not None
                  else (lambda t: t))
    scaling = policy is not None and bool(policy.loss_scale)
    n_g = cfg.gen_steps_per_disc

    def accum(loss_fn, params, xs):
        """Mean (loss, aux, grads) of ``loss_fn(params, x)`` over the
        microbatches ``xs``, summed in their order then divided by M."""
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        flat = tree_leaves(p)
        tot = None
        for x in xs:
            loss, aux = loss_fn(p, x)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(f) if g is None else g
                     for f, g in zip(flat, grads)]
            vals = [loss.detach(), *(a.detach() for a in aux.values()),
                    *grads]
            tot = vals if tot is None else [a + b for a, b in zip(tot, vals)]
        if M > 1:
            tot = [v / M for v in tot]
        n_aux = len(aux)
        aux = dict(zip(aux.keys(), tot[1:1 + n_aux]))
        return tot[0], aux, _unflatten(params, tot[1 + n_aux:])

    def phase(loss_fn, params, xs, opt_state, optimizer, ls):
        """One Algorithm-1 phase: accumulate grads, reduce, update.
        Returns (loss, aux, params, opt_state, ls, finite)."""
        if ls is None:
            loss, aux, g = accum(loss_fn, params, xs)
            upd, new_opt = optimizer.update(reduce_grads(g), opt_state,
                                            params)
            return (loss, aux, opt_lib.apply_updates(params, upd), new_opt,
                    None, torch.ones((), device=loss.device))

        def scaled(p, x):
            loss_, aux_ = loss_fn(p, x)
            return loss_ * ls.scale, aux_

        loss, aux, g = accum(scaled, params, xs)
        g = reduce_grads(precision_lib.unscale(ls, g))
        finite = precision_lib.all_finite(g)
        upd, new_opt = optimizer.update(g, opt_state, params)
        new_params = precision_lib.select_finite(
            finite, opt_lib.apply_updates(params, upd), params)
        new_opt = precision_lib.select_finite(finite, new_opt, opt_state)
        ls2 = precision_lib.next_loss_scale(ls, finite,
                                            policy.growth_interval)
        return loss / ls.scale, aux, new_params, new_opt, ls2, finite.float()

    def fused_step(state: GANState, batch, gen: torch.Generator):
        device = state.step.device
        img = _tensor(batch["image"], device, compute_dtype)
        e_p, theta, ecal = (_tensor(batch[k], device)
                            for k in ("e_p", "theta", "ecal"))
        bs = img.shape[0]
        if bs % M:
            raise ValueError(f"batch {bs} does not split into {M} "
                             "microbatches")
        mb = bs // M
        ecal_frac = torch.mean(ecal / e_p)

        def inputs(i):
            if sample_inputs is None:
                noise, f_ep, f_th = draw_inputs(gen, mb, cfg.latent_dim)
            else:
                noise, f_ep, f_th = sample_inputs(i, mb)
            return (_tensor(noise, device, compute_dtype),
                    _tensor(f_ep, device), _tensor(f_th, device))

        real = [{"image": img[m * mb:(m + 1) * mb],
                 "labels": tuple(t[m * mb:(m + 1) * mb]
                                 for t in (e_p, theta, ecal))}
                for m in range(M)]
        ls = state.loss_scale if scaling else None

        # ---- D on real ----------------------------------------------
        def d_loss_real(dp, x):
            return gan.disc_loss(to_compute(dp), x["image"], x["labels"],
                                 cfg, real=True)
        d_lr, d_mr, d_params, d_opt, ls, fin_r = phase(
            d_loss_real, state.d_params, real, state.d_opt, d_optimizer, ls)

        # ---- D on fake (the fakes made on the device, no G gradient) ---
        g_params_c = to_compute(state.g_params)

        def d_loss_fake(dp, i):
            noise, f_ep, f_th = inputs(i)
            with torch.no_grad():
                fake = gan.generate(g_params_c, noise, f_ep, f_th, cfg)
            return gan.disc_loss(to_compute(dp), fake,
                                 (f_ep, f_th, f_ep * ecal_frac), cfg,
                                 real=False)
        d_lf, d_mf, d_params, d_opt, ls, fin_f = phase(
            d_loss_fake, d_params, range(M), d_opt, d_optimizer, ls)

        # ---- G twice, against the updated (frozen) D ------------------
        d_params_c = to_compute(d_params)

        def g_loss(gp, i):
            noise, f_ep, f_th = inputs(i)
            return gan.gen_loss(to_compute(gp), d_params_c, noise,
                                (f_ep, f_th, f_ep * ecal_frac), cfg)
        g_params, g_opt = state.g_params, state.g_opt
        g_ls, g_fins = [], []
        for j in range(n_g):
            g_l, _, g_params, g_opt, ls, fin = phase(
                g_loss, g_params, range(M + j * M, M + (j + 1) * M), g_opt,
                g_optimizer, ls)
            g_ls.append(g_l)
            g_fins.append(fin)

        new = GANState(g_params, d_params, g_opt, d_opt, state.step + 1,
                       ls if scaling else state.loss_scale)
        metrics = {"d_loss_real": d_lr, "d_loss_fake": d_lf,
                   "g_loss": torch.stack(g_ls).mean(),
                   "d_acc_real": d_mr["acc"], "d_acc_fake": d_mf["acc"]}
        if ls is not None:
            metrics["loss_scale"] = ls.scale
            metrics["nonfinite_skips"] = (
                2.0 + n_g - (fin_r + fin_f + torch.stack(g_fins).sum()))
        return new, metrics

    return fused_step
