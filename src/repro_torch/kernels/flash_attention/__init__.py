"""Attention kernels: split-KV decode and chunked prefill for serving; the
flash forward and its dq and dk/dv backward for training."""
