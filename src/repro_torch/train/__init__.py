"""Training-side modules of the port (so far: checkpoints)."""
