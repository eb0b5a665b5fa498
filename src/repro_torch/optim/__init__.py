"""Optimizers of the port (pure functions over nested dicts of tensors)."""
