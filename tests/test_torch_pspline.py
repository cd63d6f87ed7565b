"""POWER LAW + SPLINE (``models/pspline.py``, ``likelihoods.MASS_FAMILIES["pspline"]``) on the CPU.

* The joint potential against the benchmark's plain reference
  (``cardbench/reference/pspline_joint.py``, which solves the natural
  spline's tridiagonal system itself) in float64, at seeded prior draws and
  at sites and rows on the model's edges.
* The spline against SciPy's natural cubic spline, and the coefficient map's
  linearity in the heights.
* The fixed-order gather that reads a row's coefficients on the card
  (``ops/interp.py::rows_in_fixed_order``) repeats bit for bit in any order.
* The family through ``fit`` for a few NUTS transitions, and kernel F's
  wrapper guards for the spline table.

CPU-sized throughout (``n_grid=48, n_z=64``, a few events).
"""
import math

import numpy as np
import pytest
import torch

from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference.model import constrain, make_potential, prior_sample, unconstrain, value_and_grad
from bumpcosmology_torch.models import pspline
from bumpcosmology_torch.ops import cuda_families, interp
from bumpcosmology_torch.testing import synthetic_pop_cosmo_data
from cardbench import harness
from cardbench.reference import pspline_joint as ref

N_GRID, N_Z = 48, 64
NOBS, NSAMP, NSEL = 4, 32, 512

# Sites on the model's edges, a chain each: mmin at its lowest (2 Msun, the first knot) with the narrowest
# taper, heights at +3 and at -3 everywhere, heights alternating +-3 from knot to knot, and a steep slope
# with mmax at its lowest
EDGES = {
    "h": (0.7, 0.36, 1.39, 0.68), "Om": (0.3, 0.02, 0.95, 0.31), "w": (-1.0, -1.45, -0.55, -0.9),
    "alpha": (2.5, 11.9, 1.0, -3.9), "beta_q": (1.0, -3.9, 0.0, 11.9), "mmin": (2.0, 9.5, 2.1, 5.0),
    "mmax": (99.9, 30.05, 60.0, 45.0), "delta_m": (0.05, 9.95, 4.0, 0.001),
    **{f"f_{i}": (3.0, -3.0, 3.0 * (-1) ** i, 0.5 * (i % 5) - 1.0) for i in range(1, 19)},
    "lam": (2.7, -1.2, 6.6, 0.0), "dkappa": (3.0, 1.1, 6.8, 2.0), "zp": (1.9, 0.05, 3.8, 1.0),
    "R_unit": (0.0, 1.0, -1.0, 0.5),
}


def _raw(edge_rows: bool):
    """A tiny cut of the committed catalog; with ``edge_rows`` the first
    samples of each event moved below 2 Msun and above 100 Msun in the
    source frame at any cosmology of the prior (detector-frame 1.5 and
    800 Msun), and one injection to each side as well."""
    config = {"catalog": "data/flagship_catalog.npz",
              "catalog_sha256": "2e525b8e29dd46b2903a2ec081fdd0a00fa3928c0689c0085c9a382abd98f523"}
    raw = harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog")), NOBS, NSAMP, NSEL)
    if edge_rows:
        raw["ev_a"] = raw["ev_a"].copy()
        raw["ev_a"][:, 0], raw["ev_a"][:, 1] = 1.5, 800.0
        raw["sel_a"] = raw["sel_a"].copy()
        raw["sel_a"][0], raw["sel_a"][1] = 1.5, 800.0
    return raw


def _port_spec(raw):
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in raw.items()}
    data = lk.PopCosmoData(events=lk.EventData(t["ev_a"], t["ev_q"], t["ev_c"], t["ev_lp"]),
                           selection=lk.SelectionData(t["sel_a"], t["sel_q"], t["sel_c"], t["sel_lp"], t["sel_ln"]))
    return lk.MASS_FAMILIES["pspline"].cosmo_spec(data, n_grid=N_GRID, n_z=N_Z, device="cpu")


def _reference_inputs(raw):
    ev = {k: raw["ev_" + k][None] for k in ("a", "q", "c", "lp")}
    sel = {k: raw["sel_" + k][None] for k in ("a", "q", "c", "lp")}
    cat = ref.catalogs(ev, sel, np.asarray([float(raw["sel_ln"])]), torch.float64, "cpu")
    return cat, ref.dl_bounds(raw["ev_c"], raw["sel_c"], 0.05)


def _gap(a, b):
    return float(((a - b).abs() / (1 + b.abs())).max())


@pytest.mark.parametrize("draw", ["prior", "edges"])
def test_the_joint_potential_is_the_references_in_float64(draw):
    """The port's log-likelihood and its gradient by all 30 sites against the
    plain reference in float64, at 4 chains of seeded prior draws on the cut
    catalog, and at sites on the model's edges on the catalog with rows
    outside the spline's knots.

    Tolerances, each of |port - reference| / (1 + |reference|): 1e-12 for the
    log-likelihood (float64's rounding, 1e-16, over some thousand terms summed
    in another order, and the two splines' formulas, which differ in their
    roundings); 1e-10 for its gradient (the log-sum-exps' backward cancels
    terms of a hundred or so, and the spline's second derivatives come from
    two solves of one system).  With prior draws also the whole potential by
    the positions: 1e-8 for its value (the port's priors keep their constants
    in float32, some 5e-8 nats a site over 30 sites, against a potential of
    about a hundred nats; read 1.4e-9) and 1e-10 for its gradient."""
    raw = _raw(edge_rows=draw == "edges")
    spec = _port_spec(raw)
    assert list(spec.priors) == list(ref.NAMES) and spec.dim == 30
    if draw == "prior":
        theta = prior_sample(spec, torch.Generator().manual_seed(2**31 + 25), (4,)).double()
        sites = constrain(spec, theta)
    else:
        sites = {k: torch.tensor(v, dtype=torch.float64) for k, v in EDGES.items()}
    cat, bounds = _reference_inputs(raw)
    with torch.enable_grad():
        leaves = {k: sites[k].detach().requires_grad_(True) for k in ref.NAMES}
        ll = spec.loglike(leaves)
        grads = torch.autograd.grad(ll.sum(), [leaves[k] for k in ref.NAMES], allow_unused=True)
    g = torch.stack([torch.zeros_like(ll) if x is None else x for x in grads], dim=1)
    ll_r, g_r = ref.loglike_and_site_grad({k: v.detach() for k, v in sites.items()}, cat, N_GRID, N_Z, bounds)
    assert bool(torch.isfinite(ll_r).all() and torch.isfinite(g_r).all())
    assert _gap(ll.detach(), ll_r) < 1e-12
    assert _gap(g, g_r) < 1e-10
    heights = [ref.NAMES.index(k) for k in ref.HEIGHTS]
    assert bool((g_r[:, heights].abs() > 0).any())  # the heights move the log-likelihood
    if draw == "prior":
        u, gu = value_and_grad(make_potential(spec), theta)
        u_r, gu_r = ref.value_and_grad(theta, cat, N_GRID, N_Z, bounds)
        assert _gap(u, u_r) < 1e-8
        assert _gap(gu, gu_r) < 1e-10


def test_the_spline_is_scipys_natural_cubic_spline():
    """f(log m) against ``scipy.interpolate.CubicSpline(..., bc_type="natural")``
    through (0, heights, 0) on the knots, in float64 to 1e-12 (both solve the
    same system, in other orders): at every knot, between the knots, and 0
    below 2 and above 100 Msun.  The coefficient table is linear in the
    heights: the table of a h1 + b h2 is a c1 + b c2 (to 1e-13, float64's
    rounding of a sum of 18 products)."""
    from scipy.interpolate import CubicSpline

    gen = torch.Generator().manual_seed(7)
    h = 2.0 * torch.randn((3, pspline.N_HEIGHTS), generator=gen, dtype=torch.float64)
    coef = pspline.spline_coefficients(h)
    assert coef.shape == (3, pspline.N_KNOTS - 1, 4) and coef.dtype == torch.float64
    knots = pspline.X0 + pspline.H * np.arange(pspline.N_KNOTS)
    x = np.concatenate([knots, np.linspace(math.log(1.2), math.log(150.0), 701)])
    m = torch.as_tensor(np.exp(x))[None].expand(3, -1)
    got = pspline.log_spline(coef, m, torch.log(m))
    inside = (m[0] >= 2.0) & (m[0] <= 100.0)
    assert bool(inside[: pspline.N_KNOTS].all()) and bool((~inside).any())
    for c in range(3):
        y = np.concatenate([[0.0], h[c].numpy(), [0.0]])
        want = np.where(inside.numpy(), CubicSpline(knots, y, bc_type="natural")(np.log(m[0].numpy())), 0.0)
        assert float(np.abs(got[c].numpy() - want).max()) < 1e-12
    a, b = 0.7, -1.9
    h2 = torch.randn((3, pspline.N_HEIGHTS), generator=gen, dtype=torch.float64)
    both = pspline.spline_coefficients(a * h + b * h2)
    assert float((both - (a * coef + b * pspline.spline_coefficients(h2))).abs().max()) < 1e-13
    assert pspline.coefficient_matrix(torch.float32, "cpu").dtype == torch.float32
    assert torch.equal(pspline.coefficient_matrix(torch.float32, "cpu"),
                       pspline.coefficient_matrix(torch.float64, "cpu").float())


def test_the_fixed_order_gather_repeats_bit_for_bit():
    """The gather that reads each row's coefficients on the card
    (``rows_in_fixed_order``): its values are ``torch.gather``'s, and its
    table cotangent is the same bits whatever the order of the rows, twice
    over, and ``gather``'s sum to float64's rounding of the fixed point
    (n 2^-52 of a bin's largest)."""
    gen = torch.Generator().manual_seed(3)
    table = torch.randn((4, 19, 4), generator=gen, dtype=torch.float32).requires_grad_(True)
    idx = torch.randint(0, 19, (4, 5000), generator=gen)
    g = torch.randn((4, 5000, 4), generator=gen, dtype=torch.float32)
    perm = torch.randperm(5000, generator=gen)

    def cotangent(order):
        out = interp.rows_in_fixed_order(table, idx[:, order])
        return out, torch.autograd.grad(out, table, g[:, order])[0]

    out, first = cotangent(torch.arange(5000))
    _, again = cotangent(torch.arange(5000))
    _, shuffled = cotangent(perm)
    assert torch.equal(out, interp.take_rows(table, idx))
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    assert torch.equal(first.view(torch.int32), shuffled.view(torch.int32))
    (plain,) = torch.autograd.grad(interp.take_rows(table, idx), table, g)
    assert float((first - plain).abs().max()) <= 1e-6 * float(plain.abs().max())


@pytest.mark.parametrize("model", ["pop", "cosmo"])
def test_the_family_fits_through_fit_on_the_cpu(model):
    """``MASS_FAMILIES["pspline"]`` through ``fit``: a few NUTS transitions
    of its population-only (27 sites) or joint (30 sites) model on a tiny
    synthetic catalog, finite draws of every site and its deterministics."""
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.testing import synthetic_pop_data

    fam = lk.MASS_FAMILIES["pspline"]
    if model == "pop":
        data = synthetic_pop_data(NOBS, NSAMP, 256, seed=5, device="cpu")
        spec, dim = fam.pop_spec(data, n_grid=N_GRID, device="cpu"), 27
        det_fn = lambda sites: fam.pop_det(sites, data, N_GRID)  # noqa: E731
    else:
        data = synthetic_pop_cosmo_data(NOBS, NSAMP, 256, seed=5, device="cpu")
        spec, dim = fam.cosmo_spec(data, n_grid=N_GRID, n_z=N_Z, device="cpu"), 30
        det_fn = lambda sites: fam.cosmo_det(sites, data, N_GRID, N_Z)  # noqa: E731
    assert spec.dim == dim and list(spec.priors) == list(fam.pop_priors if model == "pop" else fam.cosmo_priors)
    res = fit(spec, seed=11, num_warmup=8, num_samples=4, num_chains=2, cfg=NutsConfig(max_depth=3),
              deterministics_fn=det_fn, verbose=False, device="cpu")
    for name in spec.priors:
        assert res.posterior[name].shape == (2, 4) and np.isfinite(res.posterior[name]).all(), name
    assert np.isfinite(res.posterior["R"]).all() and np.isfinite(res.posterior["mdNdmdVdt_fixed_qz"]).all()


def test_the_heights_are_the_sites_f_1_to_f_18_in_order():
    """``pspline_from_sites`` stacks ``f_1`` … ``f_18`` into the ``(C, 18)``
    heights in order; the 18 priors are unit normals and kernel P takes them."""
    from bumpcosmology_torch.inference.distributions import Normal
    from bumpcosmology_torch.ops import cuda_priors

    sites = {k: torch.full((2,), float(v[0])) for k, v in EDGES.items()}
    sites.update({f"f_{i}": torch.tensor([float(i), -float(i)]) for i in range(1, 19)})
    p = lk.pspline_from_sites(sites)
    assert torch.equal(p.mass.heights[0], torch.arange(1.0, 19.0))
    assert torch.equal(p.mass.heights[1], -torch.arange(1.0, 19.0))
    priors = lk.PSPLINE_COSMO_PRIORS
    assert [k for k in priors if k.startswith("f_")] == list(lk.SPLINE_SITES)
    assert all(isinstance(priors[k], Normal) and tuple(priors[k]) == (0.0, 1.0) for k in lk.SPLINE_SITES)
    assert len(cuda_priors.table_rows(priors)) == 30


def test_the_spline_table_rides_through_the_sites_round_trip():
    """Positions unconstrained from the edge sites come back to them, the
    heights among them (the normal sites are their own coordinates)."""
    spec = _port_spec(_raw(edge_rows=False))
    sites = {k: torch.tensor(v, dtype=torch.float64) for k, v in EDGES.items()}
    sites["mmin"] = torch.tensor((2.5, 9.5, 2.1, 5.0), dtype=torch.float64)  # inside the prior's open interval
    back = constrain(spec, unconstrain(spec, sites))
    for k in lk.SPLINE_SITES:
        assert torch.equal(back[k], sites[k]), k


class _OnCuda:
    """A CPU tensor that reports a CUDA device."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("fault", ["missing", "shape", "float64", "for_plpeak", "well_formed"])
def test_kernel_f_takes_the_spline_table_for_pspline_alone(fault):
    """Kernel F's wrapper raises ``ValueError`` for POWER LAW + SPLINE
    without its ``(C, 19, 4)`` table of the type of the others, and for
    another family with one; a well-formed call goes on to the launch, which
    this host cannot make, and counts nothing."""
    from bumpcosmology_torch.models.cosmology import DetectorFrameTable

    c, n = 2, 17
    spline = torch.zeros((c, 19, 4))
    family = "pspline"
    if fault == "missing":
        spline = None
    elif fault == "shape":
        spline = torch.zeros((c, 20, 4))
    elif fault == "float64":
        spline = spline.double()
    elif fault == "for_plpeak":
        family = "plpeak"
    det = DetectorFrameTable(params=None, v0=0.0, dv=0.1, cols=_OnCuda(torch.zeros(c, 8, 2)))
    args = (family, det, _OnCuda(torch.zeros(c, 6)), 0.5, _OnCuda(torch.zeros(c, 11)), _OnCuda(torch.zeros(n, 4)), 3,
            4)
    before, by_family = dict(cuda_families.LAUNCHES), dict(cuda_families.BY_FAMILY)
    with pytest.raises(Exception) as err:
        cuda_families.family_lse(*args, spline=None if spline is None else _OnCuda(spline))
    assert isinstance(err.value, ValueError) == (fault != "well_formed"), err.value
    assert cuda_families.LAUNCHES == before and cuda_families.BY_FAMILY == by_family


def test_the_counters_name_kernel_f_launches_by_family():
    """``profiling.counters()`` carries kernel F's launches by mass family as
    well as by layout and route (all 0 on a host that launches none), the
    former under a prefix of its own."""
    from bumpcosmology_torch.utils import profiling

    got = profiling.counters()
    for family in cuda_families.FAMILIES:
        for way in ("fwd", "bwd"):
            assert f"cuda_families_by_family.{family}_{way}" in got
    # a sum over the prefix cuda_families. counts each launch once, by its layout and route
    assert {k for k in got if k.startswith("cuda_families.")} == {f"cuda_families.{k}" for k in cuda_families.LAUNCHES}
