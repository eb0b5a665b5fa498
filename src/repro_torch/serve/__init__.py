"""Serving side of the port: the bucketed 3DGAN fast-simulation engine and
its scheduler."""
