"""Fused kernels for the hot inference ops (Pallas, Triton route) and
their plain jnp twins."""
