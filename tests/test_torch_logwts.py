"""Kernel B's plain twin against the JAX package's fused path.

``logwts`` on CPU tensors (the plain twin, with the hand-derived backward)
must reproduce ``inference.likelihoods._cosmo_frame_logwts_fused`` — value,
and gradient through the per-draw tables and scalars back to the 13 raw
population/cosmology parameters — as ``tests/test_pallas_logwts.py:95-130``
does for the Pallas kernel (rtol 2e-5 on values; rtol 5e-4 on gradients).
The hand-derived backward is also held against PyTorch autograd of the same
forward (rtol 1e-5: same float32 arithmetic, different summation order).

``logwts_lse`` (the ``lse`` epilogue: per-event and selection log-sum-exps of
the rows) is held the same way against ``jax.scipy.special.logsumexp`` over
the fused rows, dead rows and one all-dead segment included.

The tests above the last section build smooth tables from population
parameters.  The last section repeats value and cotangents on rough tables
(independent random entries, as the on-card tests use), where a bracket
position that is rounded differently shows up in the weight at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jlogsumexp

from bumpcosmology_tpu.inference.likelihoods import _cosmo_frame_logwts_fused
from bumpcosmology_tpu.models.cosmology import DetectorFrameTable
from bumpcosmology_tpu.models.cosmology import build_cosmology as jbuild_cosmology
from bumpcosmology_tpu.models.cosmology import build_detector_table as jbuild_det
from bumpcosmology_tpu.models.cosmology import z_and_logjac_at_dl
from bumpcosmology_tpu.models.mass import MassFunctionTable
from bumpcosmology_tpu.models.parameters import DEFAULT_POPULATION, CosmoParams, PopulationParams
from bumpcosmology_tpu.models.population import PopulationIntensity
from bumpcosmology_tpu.models.population import build_population as jbuild_population
from bumpcosmology_torch.models import parameters as tparam
from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table
from bumpcosmology_torch.models.cosmology import z_and_logjac_at_dl as tz_and_logjac_at_dl
from bumpcosmology_torch.models.population import build_population, log_dndmdqdv
from bumpcosmology_torch.ops.cuda_logwts import (
    SLOTS,
    _evaluate,
    cosmo_frame_logwts,
    cosmo_frame_logwts_lse,
    logwts,
    logwts_lse,
    logwts_lse_plain,
    logwts_plain,
    pack_scalars,
    query_rows,
)

DL_LO, DL_HI = 1.0, 20.0
N_GRID = 256
N_Z = 257
NAMES = "a mpisn mbhmax sigma fpl beta c lam kappa zp h Om w".split()
THETA0 = [1.8, 31.0, 36.0, 2.3, 0.21, -2.2, 2.9, 4.7, 7.0, 3.0, 0.7, 0.3, -1.0]


def _jax_tables(theta):
    mass = DEFAULT_POPULATION.mass._replace(
        a=theta[0], mpisn=theta[1], mbhmax=theta[2], sigma=theta[3], fpl=theta[4],
        beta=theta[5], c=theta[6])
    red = DEFAULT_POPULATION.redshift._replace(lam=theta[7], kappa=theta[8], zp=theta[9])
    pop = jbuild_population(PopulationParams(mass=mass, redshift=red), n_grid=N_GRID)
    det = jbuild_det(jbuild_cosmology(CosmoParams(h=theta[10], Om=theta[11], w=theta[12]), n=N_Z),
                     DL_LO, DL_HI, n=N_Z)
    return pop, det


def _torch_tables(theta):
    """The same construction in the port, one chain; ``theta`` is (13,)."""
    t = [theta[i : i + 1] for i in range(13)]
    b = torch.tensor([DEFAULT_POPULATION.mass.b], dtype=torch.float32)
    mass = tparam.MassParams(a=t[0], b=b, c=t[6], mpisn=t[1], mbhmax=t[2], sigma=t[3], fpl=t[4], beta=t[5])
    red = tparam.RedshiftParams(lam=t[7], kappa=t[8], zp=t[9])
    pop = build_population(tparam.PopulationParams(mass, red), n_grid=N_GRID)
    det = build_detector_table(build_cosmology(tparam.CosmoParams(t[10], t[11], t[12]), n=N_Z),
                               DL_LO, DL_HI, n=N_Z)
    return pop, det


def _queries(seed: int, n: int):
    """Queries with both masses safely inside the bump-table support (as the
    Pallas test draws them)."""
    _, det = _jax_tables(jnp.asarray(THETA0, jnp.float32))
    rng = np.random.default_rng(seed)
    dl = rng.uniform(DL_LO * 1.1, DL_HI * 0.9, n).astype(np.float32)
    z, _ = z_and_logjac_at_dl(det, jnp.asarray(dl))
    m1_src = rng.uniform(10.0, 38.0, n).astype(np.float32)
    q = rng.uniform(0.6, 1.0, n).astype(np.float32)
    a = (m1_src * (1.0 + np.asarray(z))).astype(np.float32)
    log_pdraw = rng.normal(size=n).astype(np.float32)
    return a, q, dl, log_pdraw


def _qry(a, q, dl, log_pdraw):
    return query_rows(*(torch.as_tensor(x) for x in (a, q, dl, log_pdraw)))


def test_logwts_forward_matches_fused():
    a, q, dl, lp = _queries(0, 1000)
    a[0] = 0.05 * a[0]  # m1 below MBH_MIN: weight -inf on both sides
    pop, det = _jax_tables(jnp.asarray(THETA0, jnp.float32))
    ref = np.asarray(_cosmo_frame_logwts_fused(pop, det, a, q, dl, lp))
    tpop, tdet = _torch_tables(torch.tensor(THETA0))
    got = cosmo_frame_logwts(tpop, tdet, _qry(a, q, dl, lp))[0].numpy()
    assert ref[0] == -np.inf and got[0] == -np.inf
    assert np.isfinite(ref[1:]).all()
    np.testing.assert_allclose(got[1:], ref[1:], rtol=2e-5, atol=2e-5)


def test_logwts_grad_matches_fused():
    """Cotangents through tables + scalars back to the 13 raw parameters."""
    a, q, dl, lp = _queries(3, 512)
    g = np.random.default_rng(4).normal(size=512).astype(np.float32)

    def jloss(theta):
        pop, det = _jax_tables(theta)
        return jnp.vdot(g, _cosmo_frame_logwts_fused(pop, det, a, q, dl, lp))

    v_ref, g_ref = jax.value_and_grad(jloss)(jnp.asarray(THETA0, jnp.float32))
    theta = torch.tensor(THETA0, requires_grad=True)
    pop, det = _torch_tables(theta)
    v = (cosmo_frame_logwts(pop, det, _qry(a, q, dl, lp))[0] * torch.as_tensor(g)).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=2e-5)
    for name, r, p in zip(NAMES, np.asarray(g_ref), theta.grad.numpy()):
        np.testing.assert_allclose(
            p, r, rtol=5e-4, atol=5e-4 * max(1.0, abs(float(v_ref))) * 1e-3 + 1e-3,
            err_msg=f"grad wrt {name}",
        )


def test_hand_backward_matches_autograd_with_dead_and_cut_rows():
    """The hand-derived backward equals autograd of the same forward, rows
    with -inf weight (m < 5; m beyond the bump) included, and gives no NaN."""
    a, q, dl, lp = _queries(5, 300)
    a[:3] = 0.05 * a[:3]  # m1 < MBH_MIN
    q[3:6] = 0.1  # m2 < MBH_MIN
    a[6:9] = 3.0 * a[6:9]  # m1 beyond mbhmax + 7 sigma: the bump is cut, the tail remains
    pop, det = _torch_tables(torch.tensor(THETA0))
    det_c, bump, scal = det.cols.detach(), pop.mass_table.log_bump.detach(), pack_scalars(pop, det).detach()
    qry = _qry(a, q, dl, lp)
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(1, 300)).astype(np.float32))

    leaves = [x.clone().requires_grad_(True) for x in (det_c, bump, scal)]
    (logwts(*leaves, qry).nan_to_num(neginf=0.0) * g).sum().backward()
    hand = [x.grad for x in leaves]
    auto_leaves = [x.clone().requires_grad_(True) for x in (det_c, bump, scal)]
    out = _evaluate(*auto_leaves, qry)["out"]
    assert torch.isinf(out[0, :6]).all() and torch.isfinite(out[0, 6:]).all()
    (out.nan_to_num(neginf=0.0) * g).sum().backward()
    for name, h, x in zip(("det", "bump", "scal"), hand, auto_leaves):
        assert torch.isfinite(h).all(), name
        np.testing.assert_allclose(h.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("slot", ["mbh_hi", "k_det", "k_bump"])
def test_mask_only_scalars_have_zero_cotangent(slot):
    a, q, dl, lp = _queries(7, 64)
    pop, det = _torch_tables(torch.tensor(THETA0))
    scal = pack_scalars(pop, det).detach().requires_grad_(True)
    logwts(det.cols.detach(), pop.mass_table.log_bump.detach(), scal, _qry(a, q, dl, lp)).sum().backward()
    assert float(scal.grad[0, SLOTS.index(slot)]) == 0.0


def test_query_rows_store_log_dl_and_give_the_same_weights():
    """The query table keeps log dL (taken once, per row); the weights equal
    those of the port's unfused composition, which takes dL itself."""
    a, q, dl, lp = _queries(8, 400)
    qry = _qry(a, q, dl, lp)
    assert qry.shape == (400, 4) and qry.is_contiguous()
    np.testing.assert_allclose(qry[:, 2].numpy(), np.log(dl), rtol=3e-7)
    np.testing.assert_array_equal(qry[:, [0, 1, 3]].numpy(), np.stack([a, q, lp], 1))
    pop, det = _torch_tables(torch.tensor(THETA0))
    ta, tq, tdl, tlp = (torch.as_tensor(x)[None] for x in (a, q, dl, lp))
    z, log_jac = tz_and_logjac_at_dl(det, tdl)
    ref = log_dndmdqdv(pop, ta / (1.0 + z), tq, z) - 2.0 * torch.log1p(z) + log_jac - tlp
    got = cosmo_frame_logwts(pop, det, qry)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def _segmented_queries(seed, nobs, nsamp, nsel, dead_event=None):
    """nobs x nsamp PE-sample rows then nsel injection rows, some with -inf
    weight (m1 or m2 below MBH_MIN) and some past the bump cut; every row of
    ``dead_event`` is dead."""
    n = nobs * nsamp + nsel
    a, q, dl, lp = _queries(seed, n)
    a[1::17] = 0.05 * a[1::17]  # m1 < MBH_MIN
    q[2::19] = 0.1  # m2 < MBH_MIN
    a[3::23] = 3.0 * a[3::23]  # m1 beyond the bump: the tail remains
    if dead_event is not None:
        a[dead_event * nsamp : (dead_event + 1) * nsamp] = 1.0
    return a, q, dl, lp


def _jax_lse(theta, a, q, dl, lp, nobs, nsamp):
    pop, det = _jax_tables(theta)
    out = _cosmo_frame_logwts_fused(pop, det, a, q, dl, lp)
    n_ev = nobs * nsamp
    return jlogsumexp(out[:n_ev].reshape(nobs, nsamp), axis=1), jlogsumexp(out[n_ev:])


@pytest.mark.parametrize("nobs,nsamp,nsel", [(5, 32, 200), (7, 96, 1000), (3, 37, 11), (4, 130, 0)])
def test_logwts_lse_matches_logsumexp_of_fused_rows(nobs, nsamp, nsel):
    """Values of both outputs, -inf rows inside the segments; nsamp not a power of two."""
    a, q, dl, lp = _segmented_queries(11, nobs, nsamp, nsel)
    ev_ref, sel_ref = _jax_lse(jnp.asarray(THETA0, jnp.float32), a, q, dl, lp, nobs, nsamp)
    pop, det = _torch_tables(torch.tensor(THETA0))
    rows = cosmo_frame_logwts(pop, det, _qry(a, q, dl, lp))
    assert torch.isneginf(rows).any() and torch.isfinite(rows).any()
    lse_ev, lse_sel = cosmo_frame_logwts_lse(pop, det, _qry(a, q, dl, lp), nobs, nsamp)
    assert lse_ev.shape == (1, nobs) and lse_sel.shape == (1,)
    np.testing.assert_allclose(lse_ev[0].numpy(), np.asarray(ev_ref), rtol=2e-5, atol=2e-5)
    if nsel:
        np.testing.assert_allclose(float(lse_sel), float(sel_ref), rtol=2e-5, atol=2e-5)
    else:
        assert float(lse_sel) == -np.inf


def test_logwts_lse_grad_matches_fused():
    """Cotangents of both outputs through tables + scalars back to the 13 raw
    parameters, against JAX autodiff of logsumexp over the fused rows."""
    nobs, nsamp, nsel = 6, 48, 300
    a, q, dl, lp = _segmented_queries(12, nobs, nsamp, nsel)
    rng = np.random.default_rng(13)
    g_ev, g_sel = rng.normal(size=nobs).astype(np.float32), np.float32(rng.normal())

    def jloss(theta):
        ev, sel = _jax_lse(theta, a, q, dl, lp, nobs, nsamp)
        return jnp.vdot(g_ev, ev) + g_sel * sel

    v_ref, g_ref = jax.value_and_grad(jloss)(jnp.asarray(THETA0, jnp.float32))
    assert np.isfinite(np.asarray(g_ref)).all()
    theta = torch.tensor(THETA0, requires_grad=True)
    pop, det = _torch_tables(theta)
    lse_ev, lse_sel = cosmo_frame_logwts_lse(pop, det, _qry(a, q, dl, lp), nobs, nsamp)
    v = (lse_ev[0] * torch.as_tensor(g_ev)).sum() + float(g_sel) * lse_sel[0]
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=2e-5)
    for name, r, p in zip(NAMES, np.asarray(g_ref), theta.grad.numpy()):
        np.testing.assert_allclose(
            p, r, rtol=5e-4, atol=5e-4 * max(1.0, abs(float(v_ref))) * 1e-3 + 1e-3,
            err_msg=f"grad wrt {name}",
        )


def test_logwts_lse_hand_backward_matches_autograd_for_all_15_scalars():
    """The lse backward equals autograd of torch.logsumexp over the same rows:
    det, bump and every scalar slot (v0 and dv included), broadcast cotangents."""
    nobs, nsamp, nsel = 4, 40, 90
    a, q, dl, lp = _segmented_queries(14, nobs, nsamp, nsel)
    pop, det = _torch_tables(torch.tensor(THETA0))
    det_c, bump, scal = det.cols.detach(), pop.mass_table.log_bump.detach(), pack_scalars(pop, det).detach()
    qry = _qry(a, q, dl, lp)
    w_sel = -float(nobs)

    leaves = [x.clone().requires_grad_(True) for x in (det_c, bump, scal)]
    lse_ev, lse_sel = logwts_lse(*leaves, qry, nobs, nsamp)
    (lse_ev.sum(-1) + w_sel * lse_sel).sum().backward()  # the likelihood's own use: g_ev is a broadcast view
    auto = [x.clone().requires_grad_(True) for x in (det_c, bump, scal)]
    out = _evaluate(*auto, qry)["out"]
    n_ev = nobs * nsamp
    ref = torch.logsumexp(out[:, :n_ev].reshape(1, nobs, nsamp), -1).sum(-1) + w_sel * torch.logsumexp(out[:, n_ev:], -1)
    ref.sum().backward()
    for name, h, x in zip(("det", "bump", "scal"), leaves, auto):
        assert torch.isfinite(h.grad).all(), name
        np.testing.assert_allclose(h.grad.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-4, err_msg=name)
    live = [k for k, name in enumerate(SLOTS) if name not in ("mbh_hi", "k_det", "k_bump")]
    assert (leaves[2].grad[0, live] != 0).all()


def test_logwts_lse_all_dead_segment_is_neginf_with_zero_cotangents():
    """An event whose every row has -inf weight: value -inf, and its cotangent
    (however large) reaches no table bin and no scalar; nothing is NaN."""
    nobs, nsamp, nsel, dead = 4, 24, 60, 2
    a, q, dl, lp = _segmented_queries(15, nobs, nsamp, nsel, dead_event=dead)
    pop, det = _torch_tables(torch.tensor(THETA0))
    tables = (det.cols.detach(), pop.mass_table.log_bump.detach(), pack_scalars(pop, det).detach())
    qry = _qry(a, q, dl, lp)
    g_ev = torch.ones(1, nobs)
    grads = []
    for weight in (1.0, 1e6):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = logwts_lse(*leaves, qry, nobs, nsamp)
        assert float(lse_ev.detach()[0, dead]) == -np.inf
        assert torch.isfinite(lse_ev[0, [0, 1, 3]]).all() and torch.isfinite(lse_sel).all()
        g = g_ev.clone()
        g[0, dead] = weight
        torch.autograd.backward([lse_ev, lse_sel], [g, torch.ones(1)])
        assert all(torch.isfinite(x.grad).all() for x in leaves)
        grads.append([x.grad for x in leaves])
    for lo, hi in zip(*grads):
        assert torch.equal(lo, hi)


def test_logwts_lse_rejects_segments_that_do_not_fit():
    a, q, dl, lp = _queries(16, 50)
    pop, det = _torch_tables(torch.tensor(THETA0))
    with pytest.raises(ValueError, match="do not fit"):
        cosmo_frame_logwts_lse(pop, det, _qry(a, q, dl, lp), 6, 10)


# ---- rough tables: the plain twins against the JAX package, entry for entry ----

ROUGH_K, ROUGH_G = 1024, 256


def _rough_inputs(seed, n):
    """Random tables, scalars and queries like those of the on-card tests
    (``tests/test_torch_cuda.py::_logwts_inputs``), one chain, as numpy.

    Neighbouring table entries differ by order one, so one ulp of a bracket
    position (6e-5 at position 1000) moves a weight by 1e-4.  The queries keep
    only distances whose float32 logarithm is the same in numpy-on-torch and
    in JAX: the table stores ``log dL``, and a last-bit difference between two
    libraries' ``log`` is not what these tests are about."""
    rng = np.random.default_rng(seed)
    k, gl = ROUGH_K, ROUGH_G
    cols = np.stack([np.sort(rng.uniform(0.01, 3.0, k)), rng.normal(size=k)], -1).astype(np.float32)
    bump = (rng.normal(size=gl) - 5.0).astype(np.float32)
    scal = np.zeros(15, np.float32)
    scal[:13] = [np.log(0.1), np.log(200.0) / (k - 1), 3.0, 0.2, 3.0 + 0.2 * (gl - 1), 2.9, 36.0,
                 -4.0, 1.0, -2.0, 4.7, 7.0, 3.0]
    scal[13:] = [k, gl]
    dl = np.exp(rng.uniform(np.log(0.11), np.log(19.0), 2 * n)).astype(np.float32)
    same = torch.log(torch.as_tensor(dl)).numpy() == np.asarray(jnp.log(jnp.asarray(dl)))
    assert same.sum() >= n
    dl = dl[same][:n]
    a = rng.uniform(5, 120, n).astype(np.float32)
    q = rng.uniform(0.1, 1.0, n).astype(np.float32)
    lp = rng.normal(size=n).astype(np.float32)
    return cols, bump, scal, (a, q, dl, lp)


def _jax_rough_rows(cols, bump, scal, a, q, dl, lp):
    """The JAX package's fused rows from the raw tables and the 13 live scalars."""
    s = dict(zip(SLOTS, scal))
    mass = DEFAULT_POPULATION.mass._replace(c=s["c"], mbhmax=s["mbhmax"], beta=s["beta"])
    red = DEFAULT_POPULATION.redshift._replace(lam=s["lam"], kappa=s["kappa"], zp=s["zp"])
    table = MassFunctionTable(params=mass, mbh_lo=s["mbh_lo"], dmbh=s["dmbh"], mbh_hi=s["mbh_hi"],
                              log_bump=bump, log_pl_norm=s["log_pl_norm"], log_norm=s["log_norm"])
    pop = PopulationIntensity(mass_table=table, params=PopulationParams(mass=mass, redshift=red))
    det = DetectorFrameTable(params=None, v0=s["v0"], dv=s["dv"], cols=cols)
    return _cosmo_frame_logwts_fused(pop, det, a, q, dl, lp)


def _torch_rough(cols, bump, scal, qs):
    return [torch.as_tensor(x)[None] for x in (cols, bump, scal)], _qry(*qs)


def test_plain_twin_matches_fused_on_rough_tables():
    """Values of ``logwts_plain`` and ``logwts_lse_plain``.  The twin takes the
    bracket positions, z and m1 with the JAX package's own operations (a true
    division, no reciprocal), so the rows agree to the smooth terms' rounding:
    the limit is the smooth-table tests' 2e-5, not the 1e-4 of a moved bracket."""
    nobs, nsamp, n = 9, 100, 3000
    cols, bump, scal, qs = _rough_inputs(21, n)
    ref = np.asarray(_jax_rough_rows(jnp.asarray(cols), jnp.asarray(bump), jnp.asarray(scal), *qs))
    tables, qry = _torch_rough(cols, bump, scal, qs)
    got = logwts_plain(*tables, qry)[0].numpy()
    dead = np.isneginf(ref)
    assert 0 < dead.sum() < n // 2
    np.testing.assert_array_equal(np.isneginf(got), dead)
    np.testing.assert_allclose(got[~dead], ref[~dead], rtol=2e-5, atol=2e-5)
    lse_ev, lse_sel = logwts_lse_plain(*tables, qry, nobs, nsamp)
    n_ev = nobs * nsamp
    np.testing.assert_allclose(lse_ev[0].numpy(), np.asarray(jlogsumexp(ref[:n_ev].reshape(nobs, nsamp), axis=1)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(lse_sel), float(jlogsumexp(ref[n_ev:])), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("epilogue", ["rows", "lse"])
def test_plain_twin_cotangents_match_fused_on_rough_tables(epilogue):
    """The hand-derived cotangents to every table entry and all 13 live
    scalars against JAX autodiff of the fused rows (and of logsumexp over
    them), on rough tables; the file's gradient tolerance, scaled by the
    largest reference entry as the on-card check scales it."""
    nobs, nsamp, n = 9, 100, 3000
    cols, bump, scal, qs = _rough_inputs(22, n)
    rng = np.random.default_rng(23)
    g_rows = rng.normal(size=n).astype(np.float32)
    g_ev, g_sel = rng.normal(size=nobs).astype(np.float32), np.float32(rng.normal())
    n_ev = nobs * nsamp

    def jloss(cols, bump, scal):
        out = _jax_rough_rows(cols, bump, scal, *qs)
        if epilogue == "rows":
            return jnp.vdot(g_rows, jnp.where(jnp.isneginf(out), 0.0, out))
        return jnp.vdot(g_ev, jlogsumexp(out[:n_ev].reshape(nobs, nsamp), axis=1)) + g_sel * jlogsumexp(out[n_ev:])

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(cols), jnp.asarray(bump), jnp.asarray(scal))
    tables, qry = _torch_rough(cols, bump, scal, qs)
    leaves = [x.clone().requires_grad_(True) for x in tables]
    if epilogue == "rows":
        (logwts_plain(*leaves, qry)[0].nan_to_num(neginf=0.0) * torch.as_tensor(g_rows)).sum().backward()
    else:
        lse_ev, lse_sel = logwts_lse_plain(*leaves, qry, nobs, nsamp)
        ((lse_ev[0] * torch.as_tensor(g_ev)).sum() + float(g_sel) * lse_sel[0]).backward()
    for name, leaf, r in zip(("det", "bump", "scal"), leaves, ref):
        r = np.asarray(r)
        assert np.isfinite(r).all(), name
        np.testing.assert_allclose(leaf.grad[0].numpy(), r, rtol=5e-4, atol=5e-4 * np.abs(r).max(), err_msg=name)


# ---- query tables per chain, (C, N, 4): the SBC fleet's layout ----


def _three_chain_tables():
    """Rough tables of three different chains (C = 3) and three different
    query sets of one length, as numpy."""
    parts = [_rough_inputs(30 + c, 600) for c in range(3)]
    tables = [torch.stack([torch.as_tensor(p[i]) for p in parts]) for i in range(3)]
    return tables, [_qry(*p[3]) for p in parts]


def _both_epilogues(tables, qry, nobs, nsamp, seed):
    """(rows, lse_ev, lse_sel, rows cotangents, lse cotangents) of the plain
    twin on ``qry``, from fixed random cotangents."""
    c, n = tables[0].shape[0], qry.shape[-2]
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32))
    g_ev = torch.as_tensor(rng.normal(size=(c, nobs)).astype(np.float32))
    g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32))
    leaves = [x.clone().requires_grad_(True) for x in tables]
    out = logwts(*leaves, qry)
    (out.nan_to_num(neginf=0.0) * g).sum().backward()
    leaves_l = [x.clone().requires_grad_(True) for x in tables]
    lse_ev, lse_sel = logwts_lse(*leaves_l, qry, nobs, nsamp)
    torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
    return out.detach(), lse_ev.detach(), lse_sel.detach(), [x.grad for x in leaves], [x.grad for x in leaves_l]


def test_per_chain_copies_of_one_table_give_the_shared_tables_results():
    """A (C, N, 4) table whose chains hold copies of one (N, 4) table gives
    the shared table's values, log-sum-exps and cotangents, bit for bit."""
    tables, qrys = _three_chain_tables()
    copied = qrys[0].expand(3, -1, -1).contiguous()
    shared = _both_epilogues(tables, qrys[0], 4, 100, seed=7)
    per_chain = _both_epilogues(tables, copied, 4, 100, seed=7)
    assert bool(torch.isneginf(shared[0]).any())
    for a, b in zip(shared[:3], per_chain[:3]):
        assert torch.equal(a, b)
    for a3, b3 in zip(shared[3:], per_chain[3:]):
        for a, b in zip(a3, b3):
            assert torch.equal(a, b)


@pytest.mark.parametrize("epilogue", ["rows", "lse"])
def test_per_chain_tables_equal_separate_single_chain_calls(epilogue):
    """Three chains reading three different tables: each chain's values and
    its table and scalar cotangents are those of a one-chain call on its own
    table (a row landing in another chain's accumulators would show here)."""
    tables, qrys = _three_chain_tables()
    nobs, nsamp = 4, 100
    together = _both_epilogues(tables, torch.stack(qrys), nobs, nsamp, seed=8)
    rng = np.random.default_rng(8)
    g = rng.normal(size=(3, 600)).astype(np.float32)
    g_ev, g_sel = rng.normal(size=(3, nobs)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    for c in range(3):
        one = [x[c : c + 1].clone().requires_grad_(True) for x in tables]
        if epilogue == "rows":
            out = logwts(*one, qrys[c])
            (out.nan_to_num(neginf=0.0) * torch.as_tensor(g[c : c + 1])).sum().backward()
            assert torch.equal(out.detach()[0], together[0][c])
            grads = together[3]
        else:
            lse_ev, lse_sel = logwts_lse(*one, qrys[c], nobs, nsamp)
            torch.autograd.backward([lse_ev, lse_sel], [torch.as_tensor(g_ev[c : c + 1]), torch.as_tensor(g_sel[c : c + 1])])
            assert torch.equal(lse_ev.detach()[0], together[1][c]) and torch.equal(lse_sel.detach()[0], together[2][c])
            grads = together[4]
        for leaf, got in zip(one, grads):
            torch.testing.assert_close(got[c], leaf.grad[0], rtol=1e-6, atol=1e-6 * float(leaf.grad.abs().max()))
    assert not torch.equal(together[0][0], together[0][1])
