"""PyTorch / CUDA port of the 3DGAN fast-simulation system.

A second package beside the JAX reference (`src/repro/`): module paths and
names mirror the reference so each module's counterpart is easy to find,
public functions keep the reference's layouts (NDHWC activations, DHWIO
conv weights, ``(d_in, d_out)`` dense weights), and every TPU kernel on a
ported path has a hand-written CUDA kernel for Hopper under
``kernels/*/csrc/``.  The package imports neither ``jax`` nor ``repro``.
"""
