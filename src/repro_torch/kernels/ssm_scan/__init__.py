"""The Mamba2 (SSD) chunked scan: the forward kernel and its reverse-chunk
backward, their plain versions and the autograd Function."""
