"""Hand-written CUDA kernels of the port and their builder (`build.py`)."""
