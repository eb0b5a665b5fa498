"""Data sources of the port (the synthetic calorimeter Monte Carlo)."""
