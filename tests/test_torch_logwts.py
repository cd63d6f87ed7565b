"""Kernel B's plain twin against the JAX package's fused path.

``logwts`` on CPU tensors (the plain twin, with the hand-derived backward)
must reproduce ``inference.likelihoods._cosmo_frame_logwts_fused`` — value,
and gradient through the per-draw tables and scalars back to the 13 raw
population/cosmology parameters — as ``tests/test_pallas_logwts.py:95-130``
does for the Pallas kernel (rtol 2e-5 on values; rtol 5e-4 on gradients).
The hand-derived backward is also held against PyTorch autograd of the same
forward (rtol 1e-5: same float32 arithmetic, different summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference.likelihoods import _cosmo_frame_logwts_fused
from bumpcosmology_tpu.models.cosmology import build_cosmology as jbuild_cosmology
from bumpcosmology_tpu.models.cosmology import build_detector_table as jbuild_det
from bumpcosmology_tpu.models.cosmology import z_and_logjac_at_dl
from bumpcosmology_tpu.models.parameters import DEFAULT_POPULATION, CosmoParams, PopulationParams
from bumpcosmology_tpu.models.population import build_population as jbuild_population
from bumpcosmology_torch.models import parameters as tparam
from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table
from bumpcosmology_torch.models.population import build_population
from bumpcosmology_torch.ops.cuda_logwts import SLOTS, _evaluate, cosmo_frame_logwts, logwts, pack_scalars

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
    return torch.as_tensor(np.stack([a, q, dl, log_pdraw], axis=1))


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
