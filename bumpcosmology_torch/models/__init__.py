"""L1 population & cosmology models (PyTorch); see the JAX package's ``models``."""
