"""Data sources of the port (the synthetic calorimeter Monte Carlo and the
Markov token stream)."""
