"""Microbenchmarks of the port's probe kernels; they run on the card."""
