"""The port's posterior against brute-force quadrature, and its quadrature against the JAX package's.

Counterpart of ``tests/test_posterior_oracle.py``: a reduced two-site
posterior p(a, lam | catalog) of the population-only model, every other
site fixed at ``constrain(0)``, on ``synthetic_pop_data(nobs=24, nsamp=64,
nsel=256, seed=3)`` at ``n_grid`` 64, integrated by a two-pass trapezoid
rule (64 x 64 over the prior's support, then 128 x 128 over mean +- 6 sd),
through the port's batched log-likelihood.

* The quadrature itself is held against the JAX package's on the same two
  grids (tier-1): ``lp - max lp`` within 2e-3 nats at every point (an
  absolute limit: |lp| reaches 161 nats here, and a relative one would let
  the moments drift; measured 2.1e-4, the two packages' float32 sums taken
  in another order), and the two packages' four moments within 1e-4 of the
  posterior's sd (measured 1.5e-6).
* Both samplers, ``fit(sampler="nuts")`` and ``fit(sampler="nuts+chees",
  chees_num_adapt=50)``, 400 + 400 steps x 4 chains, against the
  quadrature with the JAX test's limits: r-hat < 1.02, |z| < 4 against the
  quadrature mean with the Monte-Carlo error sd / sqrt(ESS), sd ratio in
  (0.9, 1.1).  On the CPU NUTS is ``slow`` (about 100 s on eight cores), as
  its JAX twin is; the hybrid (about 43 s) stays in tier-1.  The same
  checks run on the card as ``cuda`` tests:
  ``python -m pytest tests/test_torch_posterior_oracle.py -m cuda --noconftest``.
  JAX is imported only inside the test that compares with it.
"""
import numpy as np
import pytest
import torch

from bumpcosmology_torch.inference.diagnostics import summary
from bumpcosmology_torch.inference.likelihoods import POP_PRIORS, pop_loglike, pop_rows
from bumpcosmology_torch.inference.model import ModelSpec
from bumpcosmology_torch.inference.sampler import fit
from bumpcosmology_torch.testing import synthetic_pop_data

N_GRID = 64
FREE = ("a", "lam")
BATCH = 1024
LP_ATOL = 2e-3  # nats, on lp - max lp
MOMENT_TOL = 1e-4  # in units of the posterior's sd


def reduced_spec(device="cpu") -> ModelSpec:
    data = synthetic_pop_data(nobs=24, nsamp=64, nsel=256, seed=3, device=device)
    rows = pop_rows(data)
    fixed = {n: d for n, d in POP_PRIORS.items() if n not in FREE}

    def loglike2(sites):
        zero = torch.zeros_like(sites["a"])
        return pop_loglike({**{n: d.constrain(zero) for n, d in fixed.items()}, **sites}, data, N_GRID, rows)

    return ModelSpec(priors={n: POP_PRIORS[n] for n in FREE}, loglike=loglike2, device=torch.device(device))


def log_posterior(spec: ModelSpec, a: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """log prior + log-likelihood at the constrained points (a, lam), any shape, in batches of chains."""
    pa, pl = spec.priors["a"], spec.priors["lam"]
    flat_a, flat_l = a.reshape(-1), lam.reshape(-1)
    out = []
    with torch.no_grad():
        for lo in range(0, flat_a.size, BATCH):
            ta = torch.as_tensor(flat_a[lo:lo + BATCH], dtype=torch.float32, device=spec.device)
            tl = torch.as_tensor(flat_l[lo:lo + BATCH], dtype=torch.float32, device=spec.device)
            lp = spec.loglike({"a": ta, "lam": tl}) + pa.log_prob(ta) + pl.log_prob(tl)
            out.append(lp.cpu().numpy())
    return np.concatenate(out).reshape(a.shape)


def moments(a_grid, l_grid, lp):
    """(mean a, sd a, mean lam, sd lam) of exp(lp) on the (a, lam) grid by the trapezoid rule."""
    A, L = np.meshgrid(a_grid, l_grid, indexing="ij")
    w = np.exp(lp - lp.max())
    integral = lambda f: np.trapezoid(np.trapezoid(f, l_grid, axis=1), a_grid)  # noqa: E731
    z = integral(w)
    ma, ml = integral(w * A) / z, integral(w * L) / z
    return (ma, np.sqrt(integral(w * (A - ma) ** 2) / z), ml, np.sqrt(integral(w * (L - ml) ** 2) / z))


def coarse_grids(spec):
    pa, pl = spec.priors["a"], spec.priors["lam"]
    return np.linspace(pa.low + 1e-3, pa.high - 1e-3, 64), np.linspace(pl.low + 1e-3, pl.high - 1e-3, 64)


def fine_grids(spec, coarse_moments):
    pa, pl = spec.priors["a"], spec.priors["lam"]
    ma, sa, ml, sl = coarse_moments
    return (np.linspace(max(pa.low + 1e-4, ma - 6 * sa), min(pa.high - 1e-4, ma + 6 * sa), 128),
            np.linspace(max(pl.low + 1e-4, ml - 6 * sl), min(pl.high - 1e-4, ml + 6 * sl), 128))


def quadrature(logpost, spec):
    """The two-pass quadrature: ((coarse grids, lp), (fine grids, lp), the fine pass's moments)."""
    ca, cl = coarse_grids(spec)
    clp = logpost(*np.meshgrid(ca, cl, indexing="ij"))
    fa, fl = fine_grids(spec, moments(ca, cl, clp))
    flp = logpost(*np.meshgrid(fa, fl, indexing="ij"))
    return ((ca, cl), clp), ((fa, fl), flp), moments(fa, fl, flp)


@pytest.fixture(scope="module")
def oracle():
    spec = reduced_spec()
    return spec, quadrature(lambda a, lam: log_posterior(spec, a, lam), spec)


def _assert_lp_close(lp, ref, where: str):
    assert np.array_equal(np.isfinite(lp), np.isfinite(ref)), where
    fin = np.isfinite(ref)
    d = np.abs((lp - lp[fin].max()) - (ref - ref[fin].max()))[fin]
    assert d.max() < LP_ATOL, (where, float(d.max()))


def test_quadrature_matches_jax(oracle):
    """The port's log-posterior on both grids and its four moments against the
    JAX package's (``tests/test_posterior_oracle.py``'s spec and quadrature),
    the fine grid being the JAX package's own."""
    import jax
    import jax.numpy as jnp

    from bumpcosmology_tpu.inference.likelihoods import POP_PRIORS as JPRIORS
    from bumpcosmology_tpu.inference.likelihoods import pop_loglike as jloglike
    from bumpcosmology_tpu.testing import synthetic_pop_data as jsynthetic

    spec, (_, _, port_moments) = oracle
    jdata = jsynthetic(nobs=24, nsamp=64, nsel=256, seed=3)
    jfixed = {n: d.constrain(jnp.asarray(0.0)) for n, d in JPRIORS.items() if n not in FREE}

    def jlogpost(a, lam):
        return (jloglike({**jfixed, "a": a, "lam": lam}, jdata, N_GRID) + JPRIORS["a"].log_prob(a)
                + JPRIORS["lam"].log_prob(lam))

    f = jax.jit(jax.vmap(jax.vmap(jlogpost)))
    jax_logpost = lambda a, lam: np.asarray(f(jnp.asarray(a, jnp.float32), jnp.asarray(lam, jnp.float32)))  # noqa: E731
    ((ca, cl), jclp), ((fa, fl), jflp), jax_moments = quadrature(jax_logpost, spec)
    _assert_lp_close(log_posterior(spec, *np.meshgrid(ca, cl, indexing="ij")), jclp, "coarse 64 x 64")
    _assert_lp_close(log_posterior(spec, *np.meshgrid(fa, fl, indexing="ij")), jflp, "fine 128 x 128")
    ma, sa, ml, sl = jax_moments
    for got, ref, sd in zip(port_moments, jax_moments, (sa, sa, sl, sl)):
        assert abs(got - ref) < MOMENT_TOL * sd, (port_moments, jax_moments)


def check_against_oracle(spec, oracle_moments, sampler, device, **fit_kwargs):
    """The JAX test's sampler check (``_check_against_oracle``) through the
    port's ``fit``; returns each site's z, sd ratio, r-hat and ESS."""
    res = fit(spec, 11, num_warmup=400, num_samples=400, num_chains=4, sampler=sampler, verbose=False,
              device=device, **fit_kwargs)
    s = summary(res.posterior)
    ma, sa, ml, sl = oracle_moments
    out = {site: dict(z=(s[site]["mean"] - mq) / (s[site]["sd"] / np.sqrt(s[site]["ess"])),
                      sd_ratio=s[site]["sd"] / sq, rhat=s[site]["rhat"], ess=s[site]["ess"])
           for site, mq, sq in (("a", ma, sa), ("lam", ml, sl))}
    for site, r in out.items():
        assert r["rhat"] < 1.02, (sampler, site, r)
        assert abs(r["z"]) < 4.0, (sampler, site, r, s[site])
        assert 0.9 < r["sd_ratio"] < 1.1, (sampler, site, r)
    return out


SAMPLERS = [("nuts", {}), ("nuts+chees", {"chees_num_adapt": 50})]


# NUTS takes about 100 s on the CPU (so it is slow, as its JAX twin is), the hybrid about 43 s
@pytest.mark.parametrize("sampler,kwargs", [pytest.param(*SAMPLERS[0], marks=pytest.mark.slow), SAMPLERS[1]],
                         ids=["nuts", "nuts+chees"])
def test_posterior_matches_quadrature_oracle(oracle, sampler, kwargs):
    spec, (_, _, oracle_moments) = oracle
    check_against_oracle(spec, oracle_moments, sampler, "cpu", **kwargs)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sampler,kwargs", SAMPLERS, ids=["nuts", "nuts+chees"])
def test_posterior_matches_quadrature_oracle_on_the_card(dev, oracle, sampler, kwargs):
    """The same checks with the fit on the card (kernel A builds the bump
    table); the quadrature stays the CPU's."""
    _, (_, _, oracle_moments) = oracle
    result = check_against_oracle(reduced_spec(dev), oracle_moments, sampler, dev, **kwargs)
    print(f"{sampler} on {torch.cuda.get_device_name(0)}: {result}")
