"""Forward-only public conv3d ops with the fused bias + activation epilogue.

The backward kernels (dx through the same kernel, dw) are the training
slice's work; until then an input that requires grad raises instead of
returning a wrong gradient.
"""
from __future__ import annotations

from repro_torch.kernels.conv3d.conv3d import conv3d_fwd, conv3d_transpose_fwd


def _forward_only(*tensors):
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "conv3d has no backward yet: its gradient kernels come with the "
            "training slice; call it on tensors that do not require grad")


def conv3d_bias_act(x, w, b, stride: int = 1, activation: str = "none",
                    slope: float = 0.2):
    """Fused SAME conv + bias + activation; one kernel launch on a card."""
    _forward_only(x, w, b)
    return conv3d_fwd(x, w, b, stride, activation=activation, slope=slope)


def conv3d_transpose_bias_act(x, w, b, stride: int = 2,
                              activation: str = "none", slope: float = 0.2):
    """Fused SAME transposed conv + bias + activation."""
    _forward_only(x, w, b)
    return conv3d_transpose_fwd(x, w, b, stride, activation=activation,
                                slope=slope)
