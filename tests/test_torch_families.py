"""The POWER-LAW+PEAK and BROKEN POWER LAW families of the port against the
JAX package's, on the CPU.

* The pieces (``log_planck_taper``, ``_log_pl_norm_inv``, ``log_pm1_*``,
  ``_log_nq_grid``, ``build_*_population``'s ``log_nq`` and ``log_norm``, the
  intensity's ``log_dndmdqdv``): values rtol 1e-5 / atol 1e-5, gradients rtol
  1e-4 / atol 1e-5, at the points where a guard works: the taper at x = 0,
  X_C·δ, 0.98δ and δ and at δ = 0; the norm at α = 1 exactly; m1 at the
  break, beyond mmax, beyond M_TAB_HI - 10 (plpeak) and beyond M_TAB_HI
  (brokenpl).  Three chains with different parameters, so that a parameter
  broadcast against the wrong axis shows.
* ``*_loglike`` and ``*_cosmo_loglike`` at prior draws: rtol 2e-5
  (``tests/test_model_compare.py:93`` holds the bump so), the joint model on
  the fused route (``dl_bounds`` given) and the non-fused one; the
  potentials' value: rtol 1e-4 / atol 1e-5, and gradient: the same for the
  population-only model, |Δ|/(1+|grad|) < 5e-3 for the joint one (see the test).
* The deterministics of every (family, model) pair: rtol 1e-4 / atol 1e-5.
* At the edges of the Uniform(0, 1) priors (``lam_peak``, ``bfrac``), where
  float32 rounds the constrained value to 0 or 1, the potential is held to
  JAX's where JAX's is finite, and makes a NaN gradient exactly where JAX's does.
* The specs' sites in JAX's order, the registry's keys, trace names and
  fields; kernel B (and its twin) never reached by a family other than the
  bump, and the bump never reaching the families' plain routes.

Data: 8 events x 32 samples and 128 injections, ``n_grid`` 48, ``n_z`` 64
(every route compared here is the same in both packages at any ``n_z``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import likelihoods as jl
from bumpcosmology_tpu.inference import sampler as jsampler
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import make_potential as jpotential
from bumpcosmology_tpu.inference.model import prior_sample as jprior
from bumpcosmology_tpu.models import brokenpl as jb
from bumpcosmology_tpu.models import plpeak as jp
from bumpcosmology_tpu.models.population import log_dndmdqdv as jlog_dndmdqdv
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as jsynthetic_cosmo
from bumpcosmology_tpu.testing import synthetic_pop_data as jsynthetic
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import likelihoods as tl
from bumpcosmology_torch.inference.model import constrain, make_potential, value_and_grad
from bumpcosmology_torch.models import brokenpl as tb
from bumpcosmology_torch.models import plpeak as tp
from bumpcosmology_torch.models.population import log_dndmdqdv
from bumpcosmology_torch.testing import synthetic_pop_data

N_GRID, N_Z = 48, 64
SHAPE = dict(nobs=8, nsamp=32, nsel=128, seed=0)
FAMILIES = ("plpeak", "brokenpl")
MODELS = ("pop", "cosmo")
VALUE = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _leaves(cls, values):
    """A torch params NamedTuple of ``(C,)`` leaves that require grad."""
    return cls(*(torch.tensor(_f32(v), requires_grad=True) for v in values))


def _grads(leaves):
    """Each leaf's gradient (zero for a leaf the function does not read)."""
    return [np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy() for x in leaves]


# ---------------------------------------------------------------- the taper and the norm


def _taper_points():
    """(m, mmin, delta_m) float32 columns: the guard points of the taper with
    mmin = 0 (so m - mmin is exactly x), then the same at mmin = 5, then δ = 0."""
    xc = np.float32(jp.X_C)
    rows = []
    for d in (4.9, 0.5):
        d32 = np.float32(d)
        for x in (0.0, xc * d32, np.float32(0.98) * d32, d32, -1.0, 0.3 * d32, 0.6 * d32, 2.0 * d32):
            rows.append((x, 0.0, d32))
            rows.append((np.float32(5.0) + np.float32(x), 5.0, d32))
    for x in (-0.5, 0.0, 1e-7, 0.5):
        rows.append((np.float32(5.0) + np.float32(x), 5.0, 0.0))
    return [_f32(c) for c in zip(*rows)]


def test_planck_taper_matches_jax():
    m, mmin, dm = _taper_points()
    # eagerly: compiled, XLA may round X_C·δ otherwise and lose the tie at x = X_C·δ
    ref = np.asarray(jax.vmap(jp.log_planck_taper)(m, mmin, dm))
    ref_g = [np.asarray(g) for g in jax.vmap(jax.grad(jp.log_planck_taper, argnums=(0, 1, 2)))(m, mmin, dm)]
    args = [torch.tensor(v, requires_grad=True) for v in (m, mmin, dm)]
    got = tp.log_planck_taper(*args)
    got.sum().backward()
    assert np.isfinite(ref).all() and all(np.isfinite(g).all() for g in ref_g)
    np.testing.assert_allclose(got.detach().numpy(), ref, **VALUE)
    for name, a, r in zip(("m", "mmin", "delta_m"), args, ref_g):
        np.testing.assert_allclose(a.grad.numpy(), r, **GRAD, err_msg=name)


def test_pl_norm_inv_matches_jax():
    """Through α = 1 exactly and one ulp either side, and at ordinary slopes.

    One ulp from α = 1 the values agree, but neither package's gradient does
    better than float32 noise: the guard swaps in ``x_safe`` only where |x| <
    1e-12, and beside it the derivative of expm1(x)/x (about 1/2) is the
    difference of two terms near 1/x.  So there the gradients are held only
    to be finite (at mmin 5, mmax 87 the true d/dα is -3.04; JAX gives -2.32
    and -4.47, the port -3.04 and -0.18)."""
    one = np.float32(1.0)
    alpha = _f32([one, np.nextafter(one, np.float32(2)), np.nextafter(one, np.float32(0)), 3.5, -2.0, 0.999])
    mmin = _f32([5.0, 5.0, 5.0, 2.0, 9.0, 4.0])
    mmax = _f32([87.0, 87.0, 87.0, 100.0, 30.0, 60.0])
    ref = np.asarray(jax.vmap(jp._log_pl_norm_inv)(alpha, mmin, mmax))
    ref_g = jax.vmap(jax.grad(jp._log_pl_norm_inv, argnums=(0, 1, 2)))(alpha, mmin, mmax)
    args = [torch.tensor(v, requires_grad=True) for v in (alpha, mmin, mmax)]
    got = tp._log_pl_norm_inv(*args)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, **VALUE)
    held = [0, 3, 4, 5]  # not the two points one ulp from α = 1
    for a, r in zip(args, ref_g):
        assert np.isfinite(np.asarray(r)).all() and np.isfinite(a.grad.numpy()).all()
        np.testing.assert_allclose(a.grad.numpy()[held], np.asarray(r)[held], **GRAD)


# ---------------------------------------------------------------- the mass densities, the tables, the intensity

# three chains each: defaults; edges (α = 1, δ_m = 0, a peak/break in the middle); another draw
PARAMS = {
    "plpeak": dict(
        mass=[(3.5, 1.1, 5.0, 87.0, 0.04, 34.0, 3.6, 4.9), (1.0, -1.0, 2.5, 45.0, 0.5, 30.0, 1.5, 0.0),
              (6.0, 4.0, 8.0, 99.0, 0.9, 45.0, 9.0, 9.5)],
        jmod=jp, tmod=tp, mass_cls="PLPeakMassParams", pop_cls="PLPeakPopulationParams",
        build="build_plpeak_population", pm1="log_pm1_plpeak"),
    "brokenpl": dict(
        mass=[(1.6, 5.6, 0.43, 1.4, 4.0, 87.0, 4.8), (1.0, 1.0, 0.5, -1.0, 2.5, 60.0, 0.0),
              (-2.0, 9.0, 0.9, 6.0, 9.0, 199.0, 9.5)],
        jmod=jb, tmod=tb, mass_cls="BrokenPLMassParams", pop_cls="BrokenPLPopulationParams",
        build="build_brokenpl_population", pm1="log_pm1_brokenpl"),
}
REDSHIFT = [(4.7, 7.0, 3.0), (2.0, 5.0, 1.5), (0.5, 9.0, 3.5)]


def _mass_points(family, mass):
    """(C, M) masses: a spread, the taper's guard points, and the walls."""
    base = np.concatenate([np.linspace(1.0, 220.0, 40), [30.0, 34.0]])
    out = []
    for p in mass:
        if family == "plpeak":
            mmin, mmax, dm = p[2], p[3], p[7]
            extra = [mmax + 0.5, mmax + 3.0, jp.M_TAB_HI - 10.0 + 1.0, jp.M_TAB_HI - 5.0]
        else:
            mmin, mmax, dm = p[4], p[5], p[6]
            mbreak = jb.BrokenPLMassParams(*map(np.float32, p))
            mbreak = np.float32(mbreak.mmin + mbreak.bfrac * (mbreak.mmax - mbreak.mmin))
            extra = [mbreak, np.nextafter(mbreak, np.float32(0)), mmax + 0.5, jb.M_TAB_HI + 0.5, jb.M_TAB_HI + 5.0]
        dm32 = np.float32(max(dm, 1e-6))
        extra += [mmin, mmin + np.float32(jp.X_C) * dm32, mmin + 0.98 * dm32, mmin + dm32, mmin - 1.0]
        out.append(np.concatenate([base, extra]))
    return _f32(out)


@pytest.mark.parametrize("family", FAMILIES)
def test_log_pm1_matches_jax(family):
    cfg = PARAMS[family]
    mass = _f32(cfg["mass"])
    m1 = _mass_points(family, cfg["mass"])
    jcls = getattr(cfg["jmod"], cfg["mass_cls"])
    jfn = getattr(cfg["jmod"], cfg["pm1"])

    def one(p, m):
        return jnp.sum(jfn(jcls(*p), m))

    ref = np.asarray(jax.jit(jax.vmap(lambda p, m: jfn(jcls(*p), m)))(mass, m1))
    ref_gp, ref_gm = jax.jit(jax.vmap(jax.grad(one, argnums=(0, 1))))(mass, m1)
    leaves = _leaves(getattr(cfg["tmod"], cfg["mass_cls"]), mass.T)
    m = torch.tensor(m1, requires_grad=True)
    got = getattr(cfg["tmod"], cfg["pm1"])(leaves, m)
    got.sum().backward()
    assert np.isfinite(ref).all() and np.isfinite(np.asarray(ref_gp)).all()
    np.testing.assert_allclose(got.detach().numpy(), ref, **VALUE)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(ref_gm), **GRAD)
    np.testing.assert_allclose(np.stack(_grads(leaves), 1), np.asarray(ref_gp), **GRAD)


def _jax_population(family, mass, redshift):
    cfg = PARAMS[family]
    jmod = cfg["jmod"]
    return getattr(jmod, cfg["pop_cls"])(getattr(jmod, cfg["mass_cls"])(*mass), jl.RedshiftParams(*redshift))


@pytest.mark.parametrize("family", FAMILIES)
def test_population_table_and_intensity_match_jax(family):
    """``_log_nq_grid`` through ``build_*_population`` (``log_nq``, ``log_norm``)
    and ``log_dndmdqdv`` at (C, M) queries, values and gradients (the
    gradients of the tables' sums and of the intensity's sum)."""
    cfg = PARAMS[family]
    mass, redshift = _f32(cfg["mass"]), _f32(REDSHIFT)
    rng = np.random.default_rng(1)
    m1 = _mass_points(family, cfg["mass"])
    q = _f32(rng.uniform(0.02, 1.0, m1.shape))
    z = _f32(rng.uniform(0.0, 2.5, m1.shape))
    jbuild = getattr(cfg["jmod"], cfg["build"])

    def tables(p, r):
        pop = jbuild(_jax_population(family, p, r), n_m=N_GRID)
        return pop.log_nq, pop.log_norm

    def rate(p, r, m, qq, zz):
        return jlog_dndmdqdv(jbuild(_jax_population(family, p, r), n_m=N_GRID), m, qq, zz)

    def everything(p, r, m, qq, zz):
        g_tab = jax.grad(lambda p, r: sum(jnp.sum(t) for t in tables(p, r)), argnums=(0, 1))(p, r)
        g_rate = jax.grad(lambda *a: jnp.sum(rate(*a)), argnums=(0, 1, 2, 3, 4))(p, r, m, qq, zz)
        return tables(p, r), g_tab, rate(p, r, m, qq, zz), g_rate

    (j_nq, j_norm), j_g_tab, j_rate, j_g_rate = jax.jit(jax.vmap(everything))(mass, redshift, m1, q, z)

    tmod = cfg["tmod"]
    tbuild = getattr(tmod, cfg["build"])

    def torch_params():
        ml = _leaves(getattr(tmod, cfg["mass_cls"]), mass.T)
        rl = _leaves(tl.RedshiftParams, redshift.T)
        return ml, rl, getattr(tmod, cfg["pop_cls"])(ml, rl)

    ml, rl, params = torch_params()
    pop = tbuild(params, n_m=N_GRID)
    assert pop.log_nq.shape == (3, N_GRID) and pop.log_norm.shape == (3,)
    (pop.log_nq.sum() + pop.log_norm.sum()).backward()
    np.testing.assert_allclose(pop.log_nq.detach().numpy(), np.asarray(j_nq), **VALUE)
    np.testing.assert_allclose(pop.log_norm.detach().numpy(), np.asarray(j_norm), **VALUE)
    np.testing.assert_allclose(np.stack(_grads(ml), 1), np.asarray(j_g_tab[0]), **GRAD)
    np.testing.assert_allclose(np.stack(_grads(rl), 1), np.asarray(j_g_tab[1]), **GRAD)

    ml, rl, params = torch_params()
    qs = [torch.tensor(v, requires_grad=True) for v in (m1, q, z)]
    got = log_dndmdqdv(tbuild(params, n_m=N_GRID), *qs)
    got.sum().backward()
    assert np.isfinite(np.asarray(j_rate)).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(j_rate), **VALUE)
    for got_g, ref_g in zip([np.stack(_grads(ml), 1), np.stack(_grads(rl), 1)] + [x.grad.numpy() for x in qs],
                            j_g_rate):
        np.testing.assert_allclose(got_g, np.asarray(ref_g), **GRAD)


@pytest.mark.parametrize("family", FAMILIES)
def test_params_convert_from_jax(family):
    """``convert.<family>_params`` carries the JAX package's defaults across as one chain."""
    jmod, tmod = PARAMS[family]["jmod"], PARAMS[family]["tmod"]
    default = getattr(jmod, f"DEFAULT_{family.upper()}_POPULATION")
    got = getattr(convert, f"{family}_params")(default, device="cpu")
    assert type(got) is getattr(tmod, PARAMS[family]["pop_cls"])
    for a, b in zip((*got.mass, *got.redshift), (*default.mass, *default.redshift)):
        assert a.shape == (1,) and float(a) == np.float32(b)
    assert getattr(tmod, f"DEFAULT_{family.upper()}_POPULATION") == default


# ---------------------------------------------------------------- likelihoods, potentials, deterministics


@pytest.fixture(scope="module")
def datasets():
    jd, jdc = jsynthetic(**SHAPE), jsynthetic_cosmo(**SHAPE)
    return {"pop": (jd, synthetic_pop_data(**SHAPE, device="cpu")),
            "cosmo": (jdc, convert.pop_cosmo_data(jdc, "cpu"))}


def _specs(family, model, datasets):
    jd, td = datasets[model]
    if model == "pop":
        return (getattr(jl, f"{family}_model_spec")(jd, n_grid=N_GRID),
                getattr(tl, f"{family}_model_spec")(td, n_grid=N_GRID, device="cpu"))
    return (getattr(jl, f"{family}_cosmo_model_spec")(jd, n_grid=N_GRID, n_z=N_Z),
            getattr(tl, f"{family}_cosmo_model_spec")(td, n_grid=N_GRID, n_z=N_Z, device="cpu"))


@pytest.fixture(scope="module")
def jax_at_prior_draws(datasets):
    """For each (family, model): 4 prior draws, JAX's log-likelihood (the
    joint one on both routes), potential and gradient there, and the
    deterministics at the draws (as 2 chains x 2 draws).  For the
    population-only models the same compiled program also takes the 4 draws
    of :func:`_edge_thetas`, which follow the prior draws."""
    out = {}
    for i, family in enumerate(FAMILIES):
        for model in MODELS:
            jd = datasets[model][0]
            js, ts = _specs(family, model, datasets)
            theta = jprior(js, jax.random.PRNGKey(10 + 2 * i + (model == "cosmo")), (4,))
            if model == "pop":
                theta = jnp.concatenate([theta, jnp.asarray(_edge_thetas(ts, EDGE_SITE[family]))])
            if model == "pop":
                like = lambda th: (getattr(jl, f"{family}_loglike")(jconstrain(js, th), jd, N_GRID),)  # noqa: E731
                det = lambda s: getattr(jl, f"{family}_deterministics")(s, jd, N_GRID)  # noqa: E731
            else:
                bounds = jl.dl_bounds_of(jd)
                fn = getattr(jl, f"{family}_cosmo_loglike")
                like = lambda th: (fn(jconstrain(js, th), jd, N_GRID, N_Z, bounds),  # noqa: E731
                                   fn(jconstrain(js, th), jd, N_GRID, N_Z))
                det = lambda s: getattr(jl, f"{family}_cosmo_deterministics")(s, jd, N_GRID, N_Z)  # noqa: E731
            pot = jpotential(js)
            res = jax.jit(jax.vmap(lambda th: (*like(th), *jax.value_and_grad(pot)(th))))(theta)
            dets = jsampler.compute_deterministics(js, theta[:4].reshape(2, 2, -1), det)
            out[family, model] = (np.array(theta), [np.asarray(x) for x in res], dets, ts)
    return out


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("family", FAMILIES)
def test_loglike_matches_jax(family, model, datasets, jax_at_prior_draws):
    theta, ref, _, ts = jax_at_prior_draws[family, model]
    theta, ref = theta[:4], [r[:4] for r in ref]
    td = datasets[model][1]
    sites = constrain(ts, torch.as_tensor(theta))
    if model == "pop":
        got = [getattr(tl, f"{family}_loglike")(sites, td, N_GRID)]
    else:
        fn = getattr(tl, f"{family}_cosmo_loglike")
        got = [fn(sites, td, N_GRID, N_Z, tl.dl_bounds_of(td)), fn(sites, td, N_GRID, N_Z)]
    for g, r in zip(got, ref):
        assert g.shape == (4,) and np.isfinite(r).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-5)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("family", FAMILIES)
def test_potential_value_and_grad_match_jax(family, model, jax_at_prior_draws):
    """The joint model's gradient is held to |Δ|/(1+|grad|) < 5e-3, the limit of
    ``tests/test_torch_potential.py`` and ``tests/test_torch_pop.py``: a soft
    wall of 25 nats/Msun turns the packages' one-ulp differences in a
    constrained parameter or in z into about 1e-3 of a gradient entry
    (plpeak, first draw: h, Om and mmax)."""
    theta, ref, _, ts = jax_at_prior_draws[family, model]
    theta, (ju, jg) = theta[:4], [r[:4] for r in ref[-2:]]
    u, g = value_and_grad(make_potential(ts), torch.as_tensor(theta))
    assert np.isfinite(ju).all() and np.isfinite(jg).all() and g.shape == (4, ts.dim)
    np.testing.assert_allclose(u.numpy(), ju, **GRAD)
    if model == "pop":
        np.testing.assert_allclose(g.numpy(), jg, **GRAD)
    else:
        assert np.all(np.abs(g.numpy() - jg) / (1.0 + np.abs(jg)) < 5e-3)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("family", FAMILIES)
def test_deterministics_match_jax(family, model, datasets, jax_at_prior_draws):
    """On JAX's own constrained sites (so that a one-ulp difference in a
    parameter does not meet a wall's 25 nats/Msun), in chunks of 3 draws (the
    last one short), as ``compute_deterministics`` cuts them."""
    theta, _, ref, ts = jax_at_prior_draws[family, model]
    td = datasets[model][1]
    js = _specs(family, model, datasets)[0]
    sites = {k: torch.as_tensor(np.array(v)) for k, v in jconstrain(js, jnp.asarray(theta[:4])).items()}
    if model == "pop":
        det = lambda s: getattr(tl, f"{family}_deterministics")(s, td, N_GRID)  # noqa: E731
    else:
        det = lambda s: getattr(tl, f"{family}_cosmo_deterministics")(s, td, N_GRID, N_Z)  # noqa: E731
    chunks = [det({k: v[lo:lo + 3] for k, v in sites.items()}) for lo in (0, 3)]
    got = {k: np.concatenate([c[k].numpy() for c in chunks]) for k in chunks[0]}
    assert set(got) == set(ref)
    assert ("hz" in got) == (model == "cosmo") and "mbhmax" not in got
    for k, r in ref.items():
        r = np.asarray(r).reshape((4,) + np.shape(r)[2:])
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k], r, **GRAD, err_msg=k)


EDGE_SITE = {"plpeak": "lam_peak", "brokenpl": "bfrac"}


def _edge_thetas(ts, site):
    """Thetas with ``site`` (a Uniform(0, 1)) pushed to where float32 rounds
    it to 0 or 1 (sigmoid of ±20 and of ±120), every other site at 0."""
    u = [-120.0, -20.0, 20.0, 120.0]
    theta = np.zeros((len(u), ts.dim), dtype=np.float32)
    theta[:, list(ts.priors).index(site)] = u
    return theta


@pytest.mark.parametrize("family", FAMILIES)
def test_potential_at_the_edges_of_the_unit_priors(family, jax_at_prior_draws):
    """Where JAX's potential and gradient are finite, the port's match them,
    and the port makes a NaN exactly where JAX does.  Both packages' values
    stay finite at every edge, but once float32 rounds the site to 0 or 1
    (sigmoid of 20 is 1.0) its gradient is NaN in both: an inf·0 through
    ``log1p(-lam_peak)``, or ``log(L)`` of an empty power-law segment."""
    theta, ref, _, ts = jax_at_prior_draws[family, "pop"]
    theta, ju, jg = theta[4:], ref[-2][4:], ref[-1][4:]
    u, g = (x.numpy() for x in value_and_grad(make_potential(ts), torch.as_tensor(theta)))
    fin = np.isfinite(ju) & np.isfinite(jg).all(1)
    assert fin.any()
    np.testing.assert_allclose(u[fin], ju[fin], **GRAD)
    np.testing.assert_allclose(g[fin], jg[fin], **GRAD)
    assert np.isfinite(u).all() and np.isfinite(ju).all()
    assert np.array_equal(np.isnan(g), np.isnan(jg)) and np.isnan(jg).any()


# ---------------------------------------------------------------- specs and the registry


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("family", FAMILIES)
def test_spec_sites_equal_jax(family, model, datasets):
    js, ts = _specs(family, model, datasets)
    prefix = "" if model == "pop" else "COSMO_"
    assert list(ts.priors) == list(js.priors) == list(getattr(tl, f"{family.upper()}_{prefix}PRIORS"))
    assert ts.dim == {"plpeak": 12, "brokenpl": 11}[family] + 3 * (model == "cosmo")
    for name, dist in ts.priors.items():
        jdist = js.priors[name]
        assert type(dist).__name__ == type(jdist).__name__ and tuple(dist) == tuple(jdist), name


def test_registry_matches_jax():
    # the port's registry holds the JAX package's families in its order, then POWER LAW + SPLINE, which the JAX
    # package lacks (tests/test_torch_pspline.py holds it to the benchmark's plain reference)
    assert list(jl.MASS_FAMILIES) == ["bump", "plpeak", "brokenpl"]
    assert list(tl.MASS_FAMILIES) == list(jl.MASS_FAMILIES) + ["pspline"]
    assert tl.MassFamily._fields == jl.MassFamily._fields
    for name, jfam in jl.MASS_FAMILIES.items():
        fam = tl.MASS_FAMILIES[name]
        assert fam.trace_name == jfam.trace_name.replace(".h5", ".npz")
        assert fam.cosmo_trace_name == jfam.cosmo_trace_name.replace(".h5", ".npz")
        assert list(fam.pop_priors) == list(jfam.pop_priors)
        assert list(fam.cosmo_priors) == list(jfam.cosmo_priors)
        assert (fam.build is None) == (jfam.build is None)
        if name != "bump":
            assert fam.pop_spec is getattr(tl, f"{name}_model_spec")
            assert fam.cosmo_det is getattr(tl, f"{name}_cosmo_deterministics")


@pytest.fixture
def route_calls(monkeypatch):
    """Counts of kernel B's two entries and of its plain twin's core, of kernel
    A's entry, and of the families' two plain joint routes."""
    from bumpcosmology_torch.models import mass
    from bumpcosmology_torch.ops import cuda_logwts

    calls = {}

    def counted(module, name):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("cosmo_frame_logwts", "cosmo_frame_logwts_lse", "_cosmo_frame_logwts",
                 "_cosmo_frame_logwts_fused"):
        counted(tl, name)
    counted(cuda_logwts, "_evaluate")
    counted(mass, "bump_log_dn")
    return calls


@pytest.mark.parametrize("family, plain", [("plpeak", False), ("brokenpl", False), ("bump", False),
                                           ("plpeak", True), ("brokenpl", True)],
                         ids=["plpeak", "brokenpl", "bump", "plpeak-plain", "brokenpl-plain"])
def test_only_the_bump_reaches_kernels_a_and_b(family, plain, datasets, route_calls):
    """The joint potential (``dl_bounds`` given), the per-row weights, the
    registry's deterministics and the pop likelihood of each family, counted
    by route; the q-normalised families also with ``plain=True``, whose
    routes on the CPU are those without it."""
    _, td = datasets["cosmo"]
    _, tpd = datasets["pop"]
    fam = tl.MASS_FAMILIES[family]
    gen = torch.Generator().manual_seed(0)
    sites = {k: d.sample(gen, (2,), "cpu") for k, d in fam.cosmo_priors.items()}
    with torch.no_grad():
        tl.pop_cosmo_loglike(sites, td, N_GRID, N_Z, tl.dl_bounds_of(td), plain=plain, build=fam.build)
        tl.pop_cosmo_event_sel_logwts(sites, td, N_GRID, N_Z, plain=plain, build=fam.build)
        fam.cosmo_det(sites, td, N_GRID, N_Z)
        tl.pop_loglike({k: sites[k] for k in fam.pop_priors}, tpd, N_GRID, plain=plain, build=fam.build)
    if family == "bump":
        assert route_calls.pop("_evaluate") >= 3  # the twin, as these are CPU tensors
        assert route_calls == {"cosmo_frame_logwts_lse": 1, "cosmo_frame_logwts": 2, "bump_log_dn": 4}
    else:  # the JAX package's fused route in the potential, its non-fused one in the deterministics
        assert route_calls == {"_cosmo_frame_logwts_fused": 1, "_cosmo_frame_logwts": 2}


def test_unknown_family_raises_the_jax_message():
    from bumpcosmology_torch.pipeline.stages import mass_family

    with pytest.raises(ValueError) as err:
        mass_family("gaussian")
    # the JAX package's message, naming the port's families: its three and POWER LAW + SPLINE
    assert str(err.value) == ("unknown mass_family 'gaussian' (expected one of ['brokenpl', 'bump', 'plpeak', "
                              "'pspline'])")
    assert mass_family("plpeak") is tl.MASS_FAMILIES["plpeak"]
    assert math.isfinite(tp.X_C) and tp.X_C == jp.X_C and tb.M_TAB_HI == jb.M_TAB_HI
