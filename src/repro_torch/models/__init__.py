"""Models of the port (the dense language-model family so far)."""
