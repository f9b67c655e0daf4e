"""The benchmark's yardstick: plain NumPy and torch, importing nothing of
the program (gf3x_torch) or of the JAX package (gf3x)."""
