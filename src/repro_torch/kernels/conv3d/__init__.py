"""conv3d family: the direct CUDA conv kernel (`csrc/conv3d_fwd.cu`), its
wrapper and geometry (`conv3d.py`), the plain versions (`ref.py`) and the
forward entry points (`ops.py`)."""
