"""The batched joint potential against the JAX package's, end to end.

Port: ``make_potential(pop_cosmo_model_spec(data, device="cpu"))`` with both
kernels' plain twins; reference: JAX ``make_potential(pop_cosmo_model_spec(…))``
(on the CPU the fused path with the detector table at ``n_z``), on the same
``synthetic_pop_cosmo_data(nobs=8, nsamp=32, nsel=128)`` carried across by
``bumpcosmology_torch.convert``, small grids, 4 prior chains.

Tolerances (those the on-card check uses): |ΔU|/(1+|U|) < 2e-4 and
|Δgrad|/(1+|grad|) < 5e-3 per component.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference.likelihoods import pop_cosmo_model_spec as jspec
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import make_potential as jpotential
from bumpcosmology_tpu.inference.model import prior_sample as jprior
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as jsynthetic
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS, pop_cosmo_model_spec
from bumpcosmology_torch.inference.model import (
    constrain,
    make_potential,
    prior_sample,
    unconstrain,
    value_and_grad,
)

N_GRID, N_Z = 48, 64
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair():
    jd = jsynthetic(nobs=8, nsamp=32, nsel=128, seed=0)
    js = jspec(jd, n_grid=N_GRID, n_z=N_Z)
    spec = pop_cosmo_model_spec(convert.pop_cosmo_data(jd, "cpu"), n_grid=N_GRID, n_z=N_Z, device="cpu")
    return js, spec


def test_potential_value_and_grad_match_jax(pair):
    js, spec = pair
    theta = jprior(js, jax.random.PRNGKey(1), (4,))
    ju, jg = (np.asarray(x) for x in jax.vmap(jax.value_and_grad(jpotential(js)))(theta))
    u, g = value_and_grad(make_potential(spec), convert.theta_batch(theta, "cpu"))
    assert np.isfinite(ju).all() and np.isfinite(jg).all()
    assert np.all(np.abs(u.numpy() - ju) / (1.0 + np.abs(ju)) < 2e-4)
    assert np.all(np.abs(g.numpy() - jg) / (1.0 + np.abs(jg)) < 5e-3)


def test_potential_at_a_large_detector_table_matches_jax():
    """At ``n_z`` = 8,192 detector-table rows, a table whose cotangent bins no
    longer fit in a block's shared memory on the card (kernel B's backward
    takes its second route there), the plain path's value+grad against the
    JAX package's fused route, at the same limits."""
    jd = jsynthetic(nobs=8, nsamp=32, nsel=128, seed=0)
    js = jspec(jd, n_grid=N_GRID, n_z=8192)
    spec = pop_cosmo_model_spec(convert.pop_cosmo_data(jd, "cpu"), n_grid=N_GRID, n_z=8192, device="cpu")
    theta = jprior(js, jax.random.PRNGKey(5), (4,))
    ju, jg = (np.asarray(x) for x in jax.vmap(jax.value_and_grad(jpotential(js)))(theta))
    u, g = value_and_grad(make_potential(spec), convert.theta_batch(theta, "cpu"))
    assert np.isfinite(ju).all() and np.isfinite(jg).all()
    assert np.all(np.abs(u.numpy() - ju) / (1.0 + np.abs(ju)) < 2e-4)
    assert np.all(np.abs(g.numpy() - jg) / (1.0 + np.abs(jg)) < 5e-3)


def test_constrain_round_trip_matches_jax(pair):
    js, spec = pair
    theta = jprior(js, jax.random.PRNGKey(2), (4,))
    sites = constrain(spec, convert.theta_batch(theta, "cpu"))
    jsites = jconstrain(js, theta)
    assert list(sites) == list(jsites) == list(POP_COSMO_PRIORS)
    for k in sites:
        np.testing.assert_allclose(sites[k].numpy(), np.asarray(jsites[k]), rtol=1e-6, atol=1e-6)
    back = unconstrain(spec, sites)
    np.testing.assert_allclose(back.numpy(), np.asarray(theta), rtol=1e-4, atol=1e-4)


def test_warmup_state_carries_across():
    """The JAX package's loaded adapted state and the port's loader agree exactly."""
    from bumpcosmology_tpu.utils.checkpoint import load_warmup as jload_warmup
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    path = ROOT / "benchmarks" / "flagship_warmup16.npz"
    via_convert = convert.warmup_result(jload_warmup(str(path)), device="cpu")
    direct = load_warmup(path, device="cpu")
    for a, b in zip((*via_convert.state, *via_convert[1:]), (*direct.state, *direct[1:])):
        assert torch.equal(a, b)
    assert direct.state.theta.shape == (16, 15) and direct.cov.shape == (16, 15, 15)


def test_prior_sample_lies_in_support(pair):
    _, spec = pair
    gen = torch.Generator().manual_seed(0)
    theta = prior_sample(spec, gen, (64,))
    assert theta.shape == (64, 15) and torch.isfinite(theta).all()
    sites = constrain(spec, theta)
    for name, dist in spec.priors.items():
        assert torch.isfinite(dist.log_prob(sites[name])).all(), name


def test_event_sel_logwts_and_neff_terms_match_jax(pair):
    """The per-row weights behind the deterministics (the ``rows`` epilogue)
    and the selection effective sample size, chain by chain against the JAX
    package's fused branch.  Weights: atol 5e-4 nats + rtol 2e-5 (the tables
    are built by different float32 cumulative sums on the two sides);
    ``log_mu_sel`` atol 2e-4, ``neff_sel`` and the per-event ``neff`` rtol 2e-3."""
    from jax.scipy.special import logsumexp as jlogsumexp

    from bumpcosmology_tpu.inference.likelihoods import _pop_cosmo_event_sel_logwts, _selection_neff_terms
    from bumpcosmology_tpu.inference.likelihoods import dl_bounds_of as jbounds
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_event_sel_logwts, selection_neff_terms

    js, spec = pair
    jd = jsynthetic(nobs=8, nsamp=32, nsel=128, seed=0)
    td = convert.pop_cosmo_data(jd, "cpu")
    bounds = jbounds(jd)
    theta = jprior(js, jax.random.PRNGKey(3), (3,))
    jsites = jconstrain(js, theta)
    sites = constrain(spec, convert.theta_batch(theta, "cpu"))
    pop, cosmo, log_w, log_sel_w = pop_cosmo_event_sel_logwts(sites, td, N_GRID, N_Z, bounds)
    assert log_w.shape == (3, 8, 32) and log_sel_w.shape == (3, 128)
    assert pop.mass_table.log_bump.shape == (3, N_GRID) and cosmo.dl.shape == (3, N_Z)
    log_mu, neff_sel = selection_neff_terms(log_sel_w, td.selection.log_ndraw)
    neff = torch.exp(2.0 * torch.logsumexp(log_w, -1) - torch.logsumexp(2.0 * log_w, -1))
    for c in range(3):
        _, _, jw, jsw = _pop_cosmo_event_sel_logwts({k: v[c] for k, v in jsites.items()}, jd, N_GRID, N_Z, bounds)
        jw, jsw = np.asarray(jw), np.asarray(jsw)
        for got, ref in ((log_w[c].numpy(), jw), (log_sel_w[c].numpy(), jsw)):
            assert np.array_equal(np.isneginf(got), np.isneginf(ref))
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=2e-5, atol=5e-4)
        jmu, jneff_sel = _selection_neff_terms(jsw, jd.selection.log_ndraw)
        np.testing.assert_allclose(float(log_mu[c]), float(jmu), atol=2e-4)
        np.testing.assert_allclose(float(neff_sel[c]), float(jneff_sel), rtol=2e-3)
        jneff = np.exp(2.0 * np.asarray(jlogsumexp(jw, axis=1)) - np.asarray(jlogsumexp(2.0 * jw, axis=1)))
        np.testing.assert_allclose(neff[c].numpy(), jneff, rtol=2e-3)


def test_loglike_is_the_segment_reduction_of_the_rows(pair):
    """``pop_cosmo_loglike`` (one fused ``lse`` call) equals the log-sum-exps
    taken over the ``rows`` weights, as the JAX package's likelihood takes them."""
    import math

    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_event_sel_logwts, pop_cosmo_loglike

    _, spec = pair
    td = convert.pop_cosmo_data(jsynthetic(nobs=8, nsamp=32, nsel=128, seed=0), "cpu")
    sites = constrain(spec, prior_sample(spec, torch.Generator().manual_seed(5), (4,)))
    _, _, log_w, log_sel_w = pop_cosmo_event_sel_logwts(sites, td, N_GRID, N_Z)
    ref = (torch.logsumexp(log_w, -1) - math.log(32)).sum(-1) \
        - 8 * (torch.logsumexp(log_sel_w, -1) - td.selection.log_ndraw)
    got = pop_cosmo_loglike(sites, td, N_GRID, N_Z)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5)
