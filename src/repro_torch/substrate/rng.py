"""64-bit seed mixing for the port's ``torch.Generator`` streams.

JAX derives keys with ``fold_in``; the port seeds a fresh generator from a
splitmix64 mix of (seed, index) instead: per event in the serving engine,
per global step in the training engine.  A stream then depends on its
(seed, index) alone, whatever ran before it.
"""
from __future__ import annotations

MASK64 = (1 << 64) - 1


def splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def mix_seed(seed: int, index: int) -> int:
    """The 64-bit generator seed of stream ``index`` under ``seed``."""
    return splitmix64(splitmix64(int(seed) & MASK64) ^ (int(index) & MASK64))
