"""Serving attention kernels: split-KV decode and chunked prefill."""
