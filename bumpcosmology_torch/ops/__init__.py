"""L0 numerics and the hand-written CUDA kernels; see the JAX package's ``ops``.

``cuda_bump`` (kernel A) and ``cuda_logwts`` (kernel B) replace the Pallas
kernels ``ops/pallas_bump.py`` and ``ops/pallas_logwts.py`` of the JAX package.
"""
