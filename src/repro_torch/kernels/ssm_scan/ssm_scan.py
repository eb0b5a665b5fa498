"""The Mamba2 (SSD) scan's wrappers: the chunked forward and its
reverse-chunk backward.

On a CUDA tensor :func:`ssm_scan_fwd` launches ``csrc/ssd_fwd.cu`` and
adds one to :data:`FWD_LAUNCHES`; :func:`ssm_scan_bwd` launches
``csrc/ssd_bwd.cu`` and adds one to :data:`BWD_LAUNCHES`.  On a CPU
tensor each runs its plain version in ``ref.py``.  There is no fallback
from a kernel to its plain version.  The kernels mask a ragged last chunk
themselves, so the wrappers pad nothing; the backward's per-head dB and
dC are summed over heads here, and dA = sum(dt * dla) is formed here, as
the reference's wrapper does.  ``ops.ssm_scan`` wraps both as an
autograd Function.

Shapes: x (Bt, S, H, P); B, C (Bt, S, N), shared by all heads; dt
(Bt, S, H); A (H,), negative; all f32.  The chunk is clamped to S.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ssm_scan.ref import chunk_len

# kernel launches of ssm_scan_fwd and ssm_scan_bwd (one per call each)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64    # what the kernels are built for


def _check(name, t, shape, x, what):
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
            or t.device != x.device:
        raise ValueError(f"{what}: {name} must be f32 {tuple(shape)} on "
                         f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def check_inputs(x, B, C, dt, A, chunk, what):
    """Raise unless x (Bt, S, H, P), B/C (Bt, S, N), dt (Bt, S, H) and A
    (H,) are f32 on x's device and the chunk is positive."""
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"{what}: x must be (Bt, S, H, P) and B (Bt, S, N), "
                         f"got {tuple(x.shape)} and {tuple(B.shape)}")
    Bt, S, H, _ = x.shape
    N = B.shape[-1]
    for name, t, shape in (("x", x, x.shape), ("B", B, (Bt, S, N)),
                           ("C", C, (Bt, S, N)), ("dt", dt, (Bt, S, H)),
                           ("A", A, (H,))):
        _check(name, t, shape, x, what)
    if chunk <= 0:
        raise ValueError(f"{what}: chunk must be positive, got {chunk}")


def _kernel_shapes(x, B, L, what):
    """Raise unless x is a CUDA tensor of shapes the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    P, N = x.shape[3], B.shape[2]
    if L > MAX_CHUNK or P > MAX_P or N > MAX_N:
        raise ValueError(f"{what} kernel takes chunk <= {MAX_CHUNK}, P <= "
                         f"{MAX_P}, N <= {MAX_N}, got {L}, {P}, {N}")


def _launch(name, tensors, x, B, L):
    """Launch ``name`` on the pointers of ``tensors`` (inputs, then outputs,
    as its C signature lists them), all contiguous."""
    from repro_torch.kernels import build
    Bt, S, H, P = x.shape
    fn = getattr(build.load(name), name)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), Bt, S, H, P, B.shape[2], L,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def ssm_scan_fwd(x, B, C, dt, A, *, chunk: int,
                 return_chunk_states: bool = False):
    """The chunked scan from a zero state.  Returns (y (Bt, S, H, P), the
    final state (Bt, H, P, N)) and, when ``return_chunk_states``, each
    chunk's entry state (Bt, H, nC, P, N), the backward's residual; f32."""
    global FWD_LAUNCHES
    check_inputs(x, B, C, dt, A, chunk, "ssm_scan_fwd")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk_len(S, chunk)
    if x.device.type == "cpu":
        from repro_torch.kernels.ssm_scan.ref import ssd_fwd_ref
        y, sf, si = ssd_fwd_ref(x, B, C, dt, A, chunk=L)
    else:
        _kernel_shapes(x, B, L, "ssm_scan_fwd")
        ins = tuple(t.contiguous() for t in (x, B, C, dt, A))
        y = torch.empty_like(ins[0])
        sf = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
        si = torch.empty((Bt, H, -(-S // L), P, N), dtype=torch.float32,
                         device=x.device)
        _launch("ssd_fwd", ins + (y, sf, si), x, B, L)
        FWD_LAUNCHES += 1
    return (y, sf, si) if return_chunk_states else (y, sf)


def ssm_scan_bwd(x, B, C, dt, A, chunk_states, dy, *, chunk: int):
    """The reverse-chunk backward from the forward's ``chunk_states`` and
    the y cotangent ``dy``.  Returns (dx, dB, dC, ddt, dA), f32: dB and dC
    summed over heads, dA = sum over (batch, position) of dt * dla."""
    global BWD_LAUNCHES
    check_inputs(x, B, C, dt, A, chunk, "ssm_scan_bwd")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk_len(S, chunk)
    _check("chunk_states", chunk_states, (Bt, H, -(-S // L), P, N), x,
           "ssm_scan_bwd")
    _check("dy", dy, x.shape, x, "ssm_scan_bwd")
    if x.device.type == "cpu":
        from repro_torch.kernels.ssm_scan.ref import ssd_bwd_ref
        return ssd_bwd_ref(x, B, C, dt, A, chunk_states, dy, chunk=L)
    _kernel_shapes(x, B, L, "ssm_scan_bwd")
    ins = tuple(t.contiguous() for t in (x, B, C, dt, A, chunk_states, dy))
    dx = torch.empty_like(ins[0])
    dB_h, dC_h = (torch.empty((Bt, H, S, N), dtype=torch.float32,
                              device=x.device) for _ in range(2))
    ddt, dla = (torch.empty_like(ins[3]) for _ in range(2))
    _launch("ssd_bwd", ins + (dx, dB_h, dC_h, ddt, dla), x, B, L)
    BWD_LAUNCHES += 1
    # B and C are shared by all heads: their gradients sum over heads
    dA = (ins[3] * dla).sum((0, 1))
    return dx, dB_h.sum(1), dC_h.sum(1), ddt, dA
