"""L2 priors, potential, joint likelihood and NUTS sampling; see the JAX package's ``inference``."""
