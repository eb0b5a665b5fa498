"""Plain PyTorch versions of the Mamba2 (SSD) scan.

:func:`ssm_scan_seq_ref` is the sequential oracle, one timestep at a time
(the reference's ``kernels/ssm_scan/ref.py``), independent of the chunked
form.  :func:`ssd_fwd_ref` and :func:`ssd_bwd_ref` compute what the
reference's Pallas kernels ``_ssd_kernel`` and ``_ssd_bwd_kernel``
compute, chunk by chunk, for every (batch row, head) at once: the zero
padding to whole chunks, the f32 state carried across chunks, the
per-chunk entry states, and the hand-written reverse-chunk backward with
its carried dL/d(chunk-end state), plus the wrapper's sums over heads and
dA = sum(dt * dla).  The decay factor exp(F_t - F_s) is taken only where
s <= t (elsewhere it is exactly 0, never inf times 0).  As in the port's
kernels, the log-decay cumsum F and the sums the reverse cumsum dla is cut
from are kept in f64 (F falls to a few hundred within a chunk, where an
f32 spacing puts 1e-5 of relative error on each exp(F_t - F_s); the TPU
kernel keeps them in f32); every exp is rounded to f32 once.  These are
references: a CPU tensor takes them, and the card's main path never
calls them.

Shapes: x (Bt, S, H, P); B, C (Bt, S, N), shared by all heads; dt
(Bt, S, H); A (H,), negative.  All math is f32.
"""
from __future__ import annotations

import torch


def ssm_scan_seq_ref(x, B, C, dt, A):
    """s_t = exp(dt_t A_h) s_{t-1} + dt_t x_t B_t^T; y_t = C_t . s_t, from a
    zero state.  Returns (y (Bt, S, H, P), final state (Bt, H, P, N));
    differentiable."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    x, B, C, dt = x.float(), B.float(), C.float(), dt.float()
    s = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                          # (Bt, H)
        s = s * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], s))
    return torch.stack(ys, dim=1), s


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length the kernels run: ``chunk`` clamped to S."""
    return min(chunk, S)


def _chunked(x, B, C, dt, L):
    """Zero-pad to whole chunks of L: x (Bt, H, nC, L, P), B/C (Bt, nC, L,
    N), dt (Bt, H, nC, L), all f32."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nC = -(-S // L)
    pad = nC * L - S
    f = torch.nn.functional.pad
    x = f(x.float(), (0, 0, 0, 0, 0, pad))
    B = f(B.float(), (0, 0, 0, pad))
    C = f(C.float(), (0, 0, 0, pad))
    dt = f(dt.float(), (0, 0, 0, pad))
    return (x.reshape(Bt, nC, L, H, P).permute(0, 3, 1, 2, 4),
            B.reshape(Bt, nC, L, N), C.reshape(Bt, nC, L, N),
            dt.reshape(Bt, nC, L, H).permute(0, 3, 1, 2), nC)


def _log_decay(d, A):
    """F = cumsum(dt A) over each chunk, in f64: (Bt, H, L)."""
    return torch.cumsum((d * A[None, :, None]).double(), dim=-1)


def _exp(F):
    return torch.exp(F).float()


def _decay(F):
    """exp(F_t - F_s) where s <= t, exactly 0 elsewhere: (..., L, L) f32."""
    L = F.shape[-1]
    low = torch.ones((L, L), dtype=torch.bool, device=F.device).tril()
    dec = F[..., :, None] - F[..., None, :]
    return _exp(torch.where(low, dec, torch.full_like(dec, -torch.inf)))


def ssd_fwd_ref(x, B, C, dt, A, *, chunk: int):
    """The chunked forward.  Returns (y (Bt, S, H, P), the final state
    (Bt, H, P, N), each chunk's entry state (Bt, H, nC, P, N)), f32."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk_len(S, chunk)
    xc, bc, cc, dtc, nC = _chunked(x, B, C, dt, L)
    A = A.float()
    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys, entry = [], []
    for c in range(nC):
        xs, Bm, Cm, d = xc[:, :, c], bc[:, c], cc[:, c], dtc[:, :, c]
        F = _log_decay(d, A)                                     # (Bt, H, L)
        Ftot = F[..., -1]
        entry.append(state)
        y_inter = torch.einsum("bln,bhpn->bhlp", Cm, state) \
            * _exp(F)[..., None]
        cb = torch.einsum("btn,bsn->bts", Cm, Bm)[:, None]      # (Bt,1,L,L)
        M = cb * _decay(F) * d[..., None, :]
        y_intra = torch.einsum("bhts,bhsp->bhtp", M, xs)
        ys.append(y_inter + y_intra)
        wgt = _exp(Ftot[..., None] - F) * d                      # (Bt, H, L)
        dstate = torch.einsum("bhsp,bsn->bhpn", xs * wgt[..., None], Bm)
        state = state * _exp(Ftot)[..., None, None] + dstate
    y = torch.stack(ys, dim=2).permute(0, 2, 3, 1, 4).reshape(
        Bt, nC * L, H, P)[:, :S]
    return y, state, torch.stack(entry, dim=2)


def ssd_bwd_ref(x, B, C, dt, A, chunk_states, dy, *, chunk: int):
    """The reverse-chunk backward, from the forward's entry states and the
    y cotangent ``dy``.  Returns (dx, dB, dC, ddt, dA), f32: dB and dC
    summed over heads (B and C are shared by all heads), dA = sum over
    (batch, position) of dt * dla."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk_len(S, chunk)
    xc, bc, cc, dtc, nC = _chunked(x, B, C, dt, L)
    dyc = _chunked(dy, B, C, dt, L)[0]
    A = A.float()
    last = torch.arange(L, device=x.device) == L - 1
    G = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    dxs, dbs, dcs, ddts, dlas = ([None] * nC for _ in range(5))
    for c in reversed(range(nC)):
        xs, Bm, Cm, d = xc[:, :, c], bc[:, c], cc[:, c], dtc[:, :, c]
        s0, dyk = chunk_states[:, :, c].float(), dyc[:, :, c]
        F = _log_decay(d, A)
        Ftot = F[..., -1]
        eF = _exp(F)
        # recompute the forward chunk
        cb = torch.einsum("btn,bsn->bts", Cm, Bm)[:, None]
        edec = _decay(F)
        Mnodt = cb * edec
        y_inter = torch.einsum("bln,bhpn->bhlp", Cm, s0) * eF[..., None]
        w_exp = _exp(Ftot[..., None] - F)
        w = w_exp * d
        dstate = torch.einsum("bhsp,bsn->bhpn", xs * w[..., None], Bm)
        eTot = _exp(Ftot)[..., None, None]
        s1 = s0 * eTot + dstate
        # shared intermediates
        dyx = torch.einsum("bhtp,bhsp->bhts", dyk, xs)
        DM = dyx * Mnodt
        T1 = dyx * edec
        BG = torch.einsum("bsn,bhpn->bhsp", Bm, G)
        xG = torch.einsum("bhsp,bhpn->bhsn", xs, G)
        xBG = (xs * BG).sum(-1)
        # operand grads
        M = Mnodt * d[..., None, :]
        dxs[c] = torch.einsum("bhts,bhtp->bhsp", M, dyk) + w[..., None] * BG
        dbs[c] = d[..., None] * torch.einsum("bhts,btn->bhsn", T1, Cm) \
            + w[..., None] * xG
        dcs[c] = torch.einsum("bhts,bsn->bhtn", T1 * d[..., None, :], Bm) \
            + eF[..., None] * torch.einsum("bhtp,bhpn->bhtn", dyk, s0)
        # the log-decay cotangent, with the <G, s1> bump on the last row
        DMdt = DM * d[..., None, :]
        dF = ((dyk * y_inter).sum(-1) + DMdt.sum(-1) - DMdt.sum(-2)
              - w * xBG)
        gs1 = (G * s1).sum((-2, -1))
        dF = dF + torch.where(last, gs1[..., None], torch.zeros_like(dF))
        dF = dF.double()
        dla = (dF.sum(-1, keepdim=True) - torch.cumsum(dF, -1) + dF).float()
        ddts[c] = A[None, :, None] * dla + DM.sum(-2) + w_exp * xBG
        dlas[c] = dla
        # dL/d(the previous chunk's end state)
        G = G * eTot + torch.einsum(
            "bhtp,btn->bhpn", dyk * eF[..., None], Cm)
    Sp = nC * L

    def seq(parts):          # (Bt, H, L, K) per chunk -> (Bt, S, H, K)
        t = torch.stack(parts, dim=2)
        return t.permute(0, 2, 3, 1, 4).reshape(Bt, Sp, H, -1)[:, :S]

    dx = seq(dxs)
    dB = seq(dbs).sum(2)
    dC = seq(dcs).sum(2)
    ddt = seq([t[..., None] for t in ddts])[..., 0]
    dla = seq([t[..., None] for t in dlas])[..., 0]
    dA = (dt.float() * dla).sum((0, 1))
    return dx, dB, dC, ddt, dA
