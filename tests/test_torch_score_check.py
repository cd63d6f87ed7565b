"""The score-identity check (``inference/score_check.py``, ``_stage_score_check``).

* ``score_identity_check`` on the JAX package's own toys
  (``tests/test_score_check.py:17-66``): the same term gradients fed to both
  harnesses give the same means, errors and z to rtol 1e-12, and the port
  passes the matched toy and flags the shifted one as the JAX tests require.
* ``joint_term_grads`` against the JAX package's on one catalog, at
  ``ScoreCheckConfig``'s grids (n_grid 128, n_z 256): |Δg|/(1+|g|) < 5e-3,
  ``chip_smoke.py`` phase 4's gradient limit.  The port takes the fused
  route (kernel B's ``lse`` epilogue), the JAX package its non-fused one, so
  the two interpolate the cosmology on different knots; against the JAX
  package's fused rows on the same detector table the port agrees to float32
  rounding (the second test, rtol 2e-4 at n_z 64).
* ``_score_check_sites0`` equal to the JAX package's, and ``_stage_score_check``
  at a tiny size: ``score_check.npz`` with the JAX stage's keys, its lines printed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jlogsumexp

from bumpcosmology_tpu.inference.likelihoods import _pop_cosmo_event_sel_logwts, dl_bounds_of
from bumpcosmology_tpu.inference.score_check import joint_term_grads as j_joint_term_grads
from bumpcosmology_tpu.inference.score_check import score_identity_check as j_score_identity_check
from bumpcosmology_tpu.pipeline.stages import _score_check_sites0 as j_sites0
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference.score_check import ScoreCheckResult, joint_term_grads, score_identity_check
from bumpcosmology_torch.pipeline.stages import _score_check_sites0


def _toy_term_grads(mu0, shift=0.0):
    """The JAX tests' toy: event term Σ log N(y; μ, 1), selection term
    Σ log N(y; μ − shift, 1), gradients by JAX."""

    def term_grads(data):
        y = jnp.asarray(data)
        mu = jnp.asarray([mu0])
        ev = lambda m: -0.5 * jnp.sum((y - m[0]) ** 2)  # noqa: E731
        sel = lambda m: -0.5 * jnp.sum((y - m[0] + shift) ** 2)  # noqa: E731
        return jax.grad(ev)(mu), jax.grad(sel)(mu)

    return term_grads


def _toy_simulate(rng, sites):
    return rng.normal(sites["mu"], 1.0, size=64)


@pytest.mark.parametrize("shift,seed", [(0.0, 5), (0.25, 6)])
def test_score_identity_check_matches_jax_on_the_toys(shift, seed):
    args = (_toy_simulate, {"mu": 1.3}, _toy_term_grads(1.3, shift), ("mu",))
    ref = j_score_identity_check(*args, n_catalogs=300, seed=seed)
    got = score_identity_check(*args, n_catalogs=300, seed=seed)
    assert isinstance(got, ScoreCheckResult) and got.sites == ref.sites and got.n_catalogs == 300
    for name in ("mean", "se", "z"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=1e-12, atol=0)
    assert got.table() == ref.table()
    if shift == 0.0:
        assert got.se[0, 0] == pytest.approx(8.0 / np.sqrt(300.0), rel=0.2)
        assert got.max_abs_z() < 4.0
    else:
        assert abs(got.z[0, 0]) < 4.0 and abs(got.z[1, 0]) > 10.0 and got.max_abs_z() > 10.0


def test_score_identity_check_takes_torch_term_gradients():
    """Term gradients returned as tensors (the port's) count as arrays do."""
    ref = score_identity_check(_toy_simulate, {"mu": 0.4}, _toy_term_grads(0.4), ("mu",), n_catalogs=20, seed=1)

    def torch_grads(data):
        g_ev, g_sel = _toy_term_grads(0.4)(data)
        return torch.as_tensor(np.asarray(g_ev)), torch.as_tensor(np.asarray(g_sel))

    got = score_identity_check(_toy_simulate, {"mu": 0.4}, torch_grads, ("mu",), n_catalogs=20, seed=1)
    np.testing.assert_array_equal(got.z, ref.z)


@pytest.mark.parametrize("model", ["pop_cosmo", "plpeak_cosmo", "brokenpl_cosmo"])
def test_score_check_sites0_match_jax(model):
    ref = j_sites0(model)
    got = _score_check_sites0(model)
    assert list(got) == list(ref)
    for k in ref:
        assert float(got[k]) == float(ref[k]), k


def _catalog():
    jd = j_synthetic_pop_cosmo_data(6, 64, 300, seed=3)
    sites0 = j_sites0("pop_cosmo")
    return jd, convert.pop_cosmo_data(jd, "cpu"), sites0, tuple(k for k in sites0 if k != "R_unit")


def _close(got, ref, limit):
    ref = np.asarray(ref, np.float64)
    d = np.abs(np.asarray(got, np.float64) - ref) / (1.0 + np.abs(ref))
    assert d.max() < limit, d


def test_joint_term_grads_match_jax_at_the_score_check_grids():
    jd, td, sites0, grad_sites = _catalog()
    ref = j_joint_term_grads(sites0, grad_sites, nobs=6, n_grid=128, n_z=256)(jd)
    got = joint_term_grads(sites0, grad_sites, nobs=6, n_grid=128, n_z=256, device="cpu")(td)
    for g, r in zip(got, ref):
        assert g.shape == (len(grad_sites),)
        _close(g, r, 5e-3)


def test_joint_term_grads_match_jax_fused_rows_on_one_table():
    """The same detector table (the catalog's dL range, n_z knots) in both
    packages: the JAX package's fused rows through XLA against kernel B's twin."""
    jd, td, sites0, grad_sites = _catalog()
    n_grid, n_z, nobs = 48, 64, 6
    bounds = dl_bounds_of(jd)

    def term(vals, which):
        s = {k: jnp.asarray(v, jnp.float32) for k, v in sites0.items()}
        s.update(zip(grad_sites, vals))
        _, _, lw, lsw = _pop_cosmo_event_sel_logwts(s, jd, n_grid, n_z, dl_bounds=bounds)
        ev = jnp.sum(jlogsumexp(lw, axis=1) - math.log(lw.shape[1]))
        sel = -float(nobs) * (jlogsumexp(lsw) - jd.selection.log_ndraw)
        return ev if which == 0 else sel

    vals = jnp.asarray([sites0[k] for k in grad_sites], jnp.float32)
    ref = [jax.grad(lambda v, w=w: term(v, w))(vals) for w in (0, 1)]
    got = joint_term_grads(sites0, grad_sites, nobs=nobs, n_grid=n_grid, n_z=n_z, device="cpu")(td)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=2e-4, atol=2e-4)


def test_stage_score_check_tiny(tmp_path, capsys):
    """``_stage_score_check`` at a tiny size: the artifact carries the JAX
    stage's layout (``stages.py:650-659``: attrs model, n_catalogs, z_bar,
    all_pass; datasets site, mean, se, z) and the stage prints its table and verdict."""
    from bumpcosmology_torch.pipeline.config import PathsConfig, PipelineConfig, ScoreCheckConfig
    from bumpcosmology_torch.pipeline.stages import _stage_score_check

    cfg = PipelineConfig(paths=PathsConfig(data_dir=str(tmp_path)), score=ScoreCheckConfig(
        n_catalogs=6, nobs=3, nsamp=8, nsel=24, campaign_ndraw=24_000, pe_bank_size=512, threshold=10.0,
        n_grid=48, n_z=64, seed=99))
    cfg.mock.snr_chunk = 8192
    _stage_score_check(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "[score_check] 6/6 catalogs" in out and "TOTAL     h" in out and "max TOTAL |z| =" in out
    with np.load(tmp_path / "score_check.npz") as d:
        assert set(d.files) == {"attrs/model", "attrs/n_catalogs", "attrs/z_bar", "attrs/all_pass", "site", "mean",
                                "se", "z"}
        assert str(d["attrs/model"]) == "pop_cosmo" and int(d["attrs/n_catalogs"]) == 6
        sites = [str(s) for s in d["site"]]
        assert sites == [k for k in _score_check_sites0("pop_cosmo") if k != "R_unit"]
        assert d["z"].shape == (3, len(sites)) and np.isfinite(d["z"]).all()
        assert bool(d["attrs/all_pass"]) == bool(np.abs(d["z"][2]).max() < float(d["attrs/z_bar"]))
