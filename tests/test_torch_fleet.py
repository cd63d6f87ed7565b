"""The SBC fleet: S catalogs on a leading axis, chain s reading catalog s.

* The fleet potential of the joint model (kernel B's twin on per-chain query
  tables) and of the population-only model (kernel A's twin), at S = 3
  distinct catalogs, against ``jax.vmap`` of the JAX package's potential over
  the same catalogs: |ΔU|/(1+|U|) < 2e-4 and |Δgrad|/(1+|grad|) < 5e-3
  (``chip_smoke.py`` phase 4's limits).
* The other two families' fleet potentials against one evaluation per
  catalog (their one-catalog potentials are held to the JAX package in
  ``test_torch_families.py``).
* ``fleet_fit`` on a Gaussian toy with a mean and width per simulation, and
  its progress reports at the JAX package's points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import likelihoods as jlk
from bumpcosmology_tpu.inference.model import ModelSpec as JModelSpec
from bumpcosmology_tpu.inference.model import _log_prior_and_jac as j_log_prior_and_jac
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import prior_sample as jprior_sample
from bumpcosmology_tpu.inference.nuts import warmup_schedule as j_warmup_schedule
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_tpu.testing import synthetic_pop_data as j_synthetic_pop_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference.fleet import FleetPotential, fleet_fit
from bumpcosmology_torch.inference.model import ModelSpec, _log_prior_and_jac, constrain, value_and_grad
from bumpcosmology_torch.inference.nuts import NutsConfig

N_GRID, N_Z = 48, 64
S = 3
NOBS, NSAMP, NSEL = 5, 32, 200


def _jax_fleet(make):
    """S distinct catalogs from the JAX package's helper, stacked on a leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[make(NOBS, NSAMP, NSEL, seed=40 + s) for s in range(S)])


def _jax_potential(priors, loglike):
    spec = JModelSpec(priors=priors, loglike=None)

    def pot(theta, data):
        return -(j_log_prior_and_jac(spec, theta) + loglike(jconstrain(spec, theta), data))

    return spec, jax.jit(jax.vmap(jax.value_and_grad(pot)))


def _port_fleet_potential(priors, data, loglike):
    spec = ModelSpec(priors=priors, loglike=None, device=torch.device("cpu"))
    return lambda theta: -(_log_prior_and_jac(spec, theta) + loglike(constrain(spec, theta), data))


def _hold(u_t, g_t, u_j, g_j):
    u_j, g_j = np.asarray(u_j, np.float64), np.asarray(g_j, np.float64)
    assert np.isfinite(u_j).all()
    du = np.abs(u_t.numpy() - u_j) / (1.0 + np.abs(u_j))
    dg = np.abs(g_t.numpy() - g_j) / (1.0 + np.abs(g_j))
    assert du.max() < 2e-4, du
    assert dg.max() < 5e-3, dg


@pytest.fixture(scope="module")
def cosmo_fleet():
    jd = _jax_fleet(j_synthetic_pop_cosmo_data)
    return jd, convert.pop_cosmo_data(jd, "cpu"), jlk.dl_bounds_of(jd, margin=0.1)


def test_fleet_joint_potential_matches_vmapped_jax(cosmo_fleet):
    """Kernel B's twin on a (3, N, 4) query table, the fleet-wide detector-table bounds."""
    jd, td, bounds = cosmo_fleet
    assert td.events.a.shape == (S, NOBS, NSAMP) and lk.query_table(td).shape == (S, NOBS * NSAMP + NSEL, 4)
    spec, vg = _jax_potential(jlk.POP_COSMO_PRIORS,
                              lambda s, d: jlk.pop_cosmo_loglike(s, d, N_GRID, N_Z, bounds))
    theta = jax.vmap(lambda k: jprior_sample(spec, k))(jax.random.split(jax.random.PRNGKey(3), S))
    u_j, g_j = vg(theta, jd)
    pot = _port_fleet_potential(lk.POP_COSMO_PRIORS, td,
                                lambda s, d: lk.pop_cosmo_loglike(s, d, N_GRID, N_Z, bounds))
    _hold(*value_and_grad(pot, convert.theta_batch(theta, "cpu")), u_j, g_j)


def test_fleet_pop_potential_matches_vmapped_jax():
    jd = _jax_fleet(j_synthetic_pop_data)
    td = convert.pop_data(jd, "cpu")
    assert td.events.a.shape == (S, NOBS, NSAMP) and lk.pop_rows(td).shape == (4, S, NOBS * NSAMP + NSEL)
    spec, vg = _jax_potential(jlk.POP_PRIORS, lambda s, d: jlk.pop_loglike(s, d, N_GRID))
    theta = jax.vmap(lambda k: jprior_sample(spec, k))(jax.random.split(jax.random.PRNGKey(4), S))
    u_j, g_j = vg(theta, jd)
    pot = _port_fleet_potential(lk.POP_PRIORS, td, lambda s, d: lk.pop_loglike(s, d, N_GRID))
    _hold(*value_and_grad(pot, convert.theta_batch(theta, "cpu")), u_j, g_j)


@pytest.mark.parametrize("family", ["bump", "plpeak", "brokenpl"])
def test_fleet_joint_potential_is_one_evaluation_per_catalog(cosmo_fleet, family):
    """Chain s of the fleet sees catalog s and nothing else: the fleet's value
    and gradient are those of S one-chain evaluations (the families' fused
    route gathers one bracket per chain and row)."""
    _, td, bounds = cosmo_fleet
    build = lk.MASS_FAMILIES[family].build
    priors = lk.MASS_FAMILIES[family].cosmo_priors
    loglike = lambda s, d: lk.pop_cosmo_loglike(s, d, N_GRID, N_Z, bounds, build=build)  # noqa: E731
    spec = ModelSpec(priors=priors, loglike=None, device=torch.device("cpu"))
    from bumpcosmology_torch.inference.model import prior_sample

    theta = prior_sample(spec, torch.Generator().manual_seed(5), shape=(S,))
    u, g = value_and_grad(_port_fleet_potential(priors, td, loglike), theta)
    assert torch.isfinite(u).all()
    for s in range(S):
        one = lk.take_fleet(td, torch.tensor([s]))
        u1, g1 = value_and_grad(_port_fleet_potential(priors, one, loglike), theta[s : s + 1])
        torch.testing.assert_close(u[s : s + 1], u1, rtol=2e-6, atol=2e-5)
        torch.testing.assert_close(g[s : s + 1], g1, rtol=2e-5, atol=2e-4)


def test_stack_and_take_fleet():
    datas = [lk.make_pop_data(*(np.full((2, 3), v) for v in (30.0 + s, 0.5, 0.4, 1.0)), *(np.full(4, v) for v in
                              (25.0, 0.6, 0.3, 2.0)), ndraw=100.0 * (s + 1), device="cpu") for s in range(3)]
    fleet = lk.stack_fleet(datas)
    assert fleet.events.a.shape == (3, 2, 3) and fleet.selection.log_ndraw.shape == (3,)
    assert fleet.planck is datas[0].planck
    sub = lk.take_fleet(fleet, torch.tensor([2, 0]))
    assert torch.equal(sub.events.a[:, 0, 0], torch.tensor([32.0, 30.0]))
    assert torch.allclose(sub.selection.log_ndraw, torch.log(torch.tensor([300.0, 100.0])))
    assert lk.take_fleet(torch.arange(6.0).reshape(3, 2), torch.tensor([1])).tolist() == [[2.0, 3.0]]


def _gauss_make_pot(d):
    """U of S independent Gaussians: ``d`` (S, 2, dim) holds each simulation's means and widths."""
    return lambda theta: 0.5 * (((theta - d[:, 0]) / d[:, 1]) ** 2).sum(-1)


def test_fleet_potential_on_a_subset_reads_those_catalogs():
    d = torch.tensor([[[0.0], [1.0]], [[5.0], [2.0]], [[-3.0], [0.5]]])
    pot = FleetPotential(_gauss_make_pot, d)
    theta = torch.tensor([[1.0], [1.0], [1.0]])
    idx = torch.tensor([2, 0])
    assert torch.equal(pot.on_chains(idx)(theta[idx]), pot(theta)[idx])


def test_fleet_fit_recovers_each_simulations_gaussian():
    """Three simulations with their own means and widths (0.02 to 30): each
    fit's draws have its simulation's mean and variance within Monte-Carlo
    error (800 draws)."""
    mu = torch.tensor([[0.0, 3.0], [-50.0, 1.0], [7.0, -2.0]])
    sd = torch.tensor([[1.0, 0.02], [30.0, 5.0], [0.5, 2.0]])
    d = torch.stack([mu, sd], dim=1)  # (S, 2, dim)
    theta0 = mu + 3.0 * sd
    res = fleet_fit(_gauss_make_pot, d, theta0, num_warmup=200, num_samples=800, cfg=NutsConfig(max_depth=6),
                    seed=11, device="cpu")
    assert res.thetas.shape == (3, 800, 2) and res.accept.shape == (3, 800) and res.eps.shape == (3,)
    z = (res.thetas - mu[:, None]) / sd[:, None]  # standard normal draws if the fits are right
    assert float(z.mean(1).abs().max()) < 0.25, z.mean(1)
    assert float((z.var(1) - 1.0).abs().max()) < 0.3, z.var(1)


def test_fleet_fit_reports_progress_at_the_jax_packages_points():
    """``progress`` after each chunk of at most ``chunk_size`` transitions in
    each window, as the JAX package's fleet reports after each compiled chunk."""
    calls = []
    d = torch.tensor([[[0.0], [1.0]], [[1.0], [2.0]]])
    fleet_fit(_gauss_make_pot, d, torch.zeros(2, 1), num_warmup=30, num_samples=7, chunk_size=4,
              progress=lambda *a: calls.append(a), cfg=NutsConfig(max_depth=3), seed=1, device="cpu")
    expected, done = [], 0
    for n_steps, _ in j_warmup_schedule(30):
        left = n_steps
        while left > 0:
            n = min(4, left)
            left -= n
            done += n
            expected.append(("warmup", done, 30))
    expected += [("sampling", k, 7) for k in (4, 7)]
    assert calls == expected
