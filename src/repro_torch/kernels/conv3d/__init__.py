"""conv3d family: the direct CUDA conv kernel (`csrc/conv3d_fwd.cu`), the
dw kernel (`csrc/conv3d_dw.cu`), the standalone tiled GEMM
(`csrc/gemm.cu`, :func:`gemm`), their wrappers and geometry
(`conv3d.py`), the plain versions (`ref.py`) and the forward entry points
(`ops.py`)."""
from repro_torch.kernels.conv3d.conv3d import gemm

__all__ = ["gemm"]
