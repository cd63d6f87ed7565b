"""Prior-sensitivity reweighting (``inference/prior_sens.py``).

The port computes every log-density in float64 on the host with its own
distributions; the JAX package's are held here under ``jax.enable_x64``, so
both packages do the same float64 arithmetic:

* ``prior_sensitivity_suite`` on the same synthetic joint-model trace (every
  site of the bump's and PLPeak's joint priors, and so every family of
  prior) equal to the JAX package's at rtol 1e-10: the same perturbations,
  ESS fractions, means, sds, shifts and sd ratios;
* ``reweight_posterior`` on the JAX test's conjugate-normal oracle, and its
  zero-support ``ValueError``;
* ``scaled_prior`` of each family equal to the JAX package's.
"""
import math

import jax
import numpy as np
import pytest

from bumpcosmology_tpu.inference import distributions as jdist
from bumpcosmology_tpu.inference import likelihoods as jlk
from bumpcosmology_tpu.inference import prior_sens as jps
from bumpcosmology_torch.inference import distributions as dist
from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference import prior_sens as ps


def _trace(priors, rng, shape=(4, 250)):
    """Draws inside every site's support, concentrated about the middle of it."""
    post = {}
    for name, d in priors.items():
        if isinstance(d, jdist.Uniform):
            lo, hi = d.low, d.high
        else:
            lo = getattr(d, "low", None)
            hi = getattr(d, "high", None)
            lo = d.loc - 3 * d.scale if lo is None else lo
            hi = d.loc + 3 * d.scale if hi is None else hi
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        post[name] = (mid + 0.3 * half * np.tanh(rng.standard_normal(shape))).astype(np.float32)
    return post


@pytest.mark.parametrize("family", ["bump", "plpeak"])
def test_suite_equals_jax_in_float64(family):
    jpriors, priors = jlk.MASS_FAMILIES[family].cosmo_priors, lk.MASS_FAMILIES[family].cosmo_priors
    post = _trace(jpriors, np.random.default_rng(3))
    with jax.enable_x64(True):
        ref = jps.prior_sensitivity_suite(post, jpriors)
    got = ps.prior_sensitivity_suite(post, priors)
    assert [r.name for r in got] == [r.name for r in ref] and len(got) > len(priors)
    for g, r in zip(got, ref):
        assert g.site == r.site
        assert g.ess_frac == pytest.approx(r.ess_frac, rel=1e-10)
        for field in ("mean", "sd", "shift_sd", "sd_ratio"):
            a, b = getattr(g, field), getattr(r, field)
            assert sorted(a) == sorted(b)
            np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b], rtol=1e-10, atol=1e-12)


def test_reweight_matches_conjugate_normal_and_jax():
    rng = np.random.default_rng(0)
    mu_p, s_p, tau, tau_new = 1.0, 0.8, 2.0, 1.0
    draws = rng.normal(mu_p, s_p, 200_000)
    got = ps.reweight_posterior({"t": draws}, {"t": dist.Normal(0.0, tau)}, {"t": dist.Normal(0.0, tau_new)},
                                name="tighten", site="t")
    with jax.enable_x64(True):
        ref = jps.reweight_posterior({"t": draws}, {"t": jdist.Normal(0.0, tau)}, {"t": jdist.Normal(0.0, tau_new)},
                                     name="tighten", site="t")
    prec = 1.0 / s_p**2 + 1.0 / tau_new**2 - 1.0 / tau**2
    assert got.mean["t"] == pytest.approx((mu_p / s_p**2) / prec, abs=5e-3)
    assert got.sd["t"] == pytest.approx(1.0 / math.sqrt(prec), abs=5e-3)
    assert got.ess_frac == pytest.approx(ref.ess_frac, rel=1e-10)
    assert got.mean["t"] == pytest.approx(ref.mean["t"], rel=1e-10)
    with pytest.raises(ValueError):
        ps.reweight_posterior({"x": np.full(100, 5.0)}, {"x": dist.Uniform(0.0, 10.0)}, {"x": dist.Uniform(0.0, 1.0)})


@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_scaled_prior_equals_jax(factor):
    cases = [(dist.Normal(0.0, 2.0), jdist.Normal(0.0, 2.0)),
             (dist.TruncatedNormal(0.7, 0.2, low=0.35, high=1.4), jdist.TruncatedNormal(0.7, 0.2, low=0.35, high=1.4)),
             (dist.TruncatedNormal(2.0, 2.0, low=1.0), jdist.TruncatedNormal(2.0, 2.0, low=1.0)),
             (dist.Uniform(-4.0, 12.0), jdist.Uniform(-4.0, 12.0))]
    for d, jd in cases:
        got, ref = ps.scaled_prior(d, factor), jps.scaled_prior(jd, factor)
        assert (got is None) == (ref is None)
        if got is not None:
            assert type(got).__name__ == type(ref).__name__ and tuple(got) == tuple(ref)
