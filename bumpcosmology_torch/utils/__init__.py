"""Utilities; see the JAX package's ``utils``."""
