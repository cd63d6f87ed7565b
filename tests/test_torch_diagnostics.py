"""The port's convergence diagnostics against the JAX package's (both numpy):
``split_rhat``, ``ess`` and ``summary`` equal at rtol 1e-12 on AR(1) chains,
one-chain arrays, chains shorter than 4 draws and zero-variance arrays."""
import numpy as np
import pytest

from bumpcosmology_tpu.inference import diagnostics as jdiag
from bumpcosmology_torch.inference import diagnostics


def _ar1(chains, draws, rho, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    x = np.empty((chains, draws))
    x[:, 0] = rng.normal(size=chains)
    for t in range(1, draws):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho ** 2) * rng.normal(size=chains)
    return x + shift * np.arange(chains)[:, None]


ARRAYS = {
    "ar1_fast": _ar1(4, 500, 0.2, 0),
    "ar1_slow": _ar1(4, 500, 0.95, 1),
    "ar1_apart": _ar1(3, 200, 0.5, 2, shift=2.0),  # chains that disagree: R-hat well above 1
    "anticorrelated": _ar1(2, 301, -0.6, 3),
    "one_chain": _ar1(1, 400, 0.7, 4),
    "one_chain_1d": _ar1(1, 64, 0.3, 5)[0],
    "three_draws": _ar1(4, 3, 0.5, 6),
    "seven_draws": _ar1(4, 7, 0.5, 7),
    "zero_variance": np.full((4, 100), 2.5),
    "constant_chains": np.repeat(np.arange(4.0)[:, None], 100, axis=1),
    "float32": _ar1(4, 200, 0.8, 8).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_rhat_and_ess_equal_jax(name):
    x = ARRAYS[name]
    np.testing.assert_allclose(diagnostics.split_rhat(x), jdiag.split_rhat(x), rtol=1e-12)
    np.testing.assert_allclose(diagnostics.ess(x), jdiag.ess(x), rtol=1e-12)


def test_summary_equals_jax():
    samples = {k: v for k, v in ARRAYS.items() if np.ndim(v) == 2}
    samples["vector_site"] = np.zeros((4, 10, 3))  # skipped by both
    got, ref = diagnostics.summary(samples), jdiag.summary(samples)
    assert list(got) == list(ref) and "vector_site" not in got
    for site in ref:
        assert list(got[site]) == list(ref[site])
        for stat in ref[site]:
            np.testing.assert_allclose(got[site][stat], ref[site][stat], rtol=1e-12, err_msg=f"{site} {stat}")
    assert ref["ar1_apart"]["rhat"] > 1.5 and ref["zero_variance"]["rhat"] == 1.0
