"""Port parity, mock campaign path: samplers, Planck18 weights, the fiducial
population weight, the injection campaign, observation noise and the
one-year catalog against the JAX package on the CPU.

Host draws are numpy float64 with the same seeds and call order in both
packages, so every drawn column must be identical.  What differs is float32
device arithmetic:
* the SNR columns (kernel C's twin against the JAX package's XLA integral):
  rtol 1e-5, the same exact zeros;
* ``default_pop_wt`` (float32 population intensity; the bump table's grid is
  ``lo + j d`` here and ``linspace`` there): rtol 5e-5;
* ``campaign_summary`` (sums of those weights): rtol 1e-4.
The one-year catalog's picks (the Poisson count, ``rng.choice`` with ``p``)
read float32-derived weights; at these seeds no pick flips, so the catalog is
held to the same rows and events, with its weight column at rtol 5e-5.  A
pick that flipped on rounding would call for the weights at rtol 1e-5 and the
catalog's per-column quantiles instead.
"""
import math

import numpy as np
import pytest

from bumpcosmology_tpu.data import weights as jw
from bumpcosmology_tpu.mock import catalog as jc
from bumpcosmology_tpu.mock import sampling as js
from bumpcosmology_torch import convert
from bumpcosmology_torch.data import weights as tw
from bumpcosmology_torch.mock import catalog as tc
from bumpcosmology_torch.mock import sampling as ts

F64 = 1e-14  # float64 round-off


def test_power_law_and_interpolated_pdfs_match_jax():
    rng = np.random.default_rng(0)
    c = rng.uniform(size=1000)
    m1 = np.exp(rng.uniform(np.log(5.0), np.log(500.0), 1000))
    for args in ((2.35, 5.0, 500.0), (2.0, m1 + 5.0, 2.0 * m1)):
        a, b = js.PowerLawPDF(*args), ts.PowerLawPDF(*args)
        x = b.icdf(c)
        np.testing.assert_allclose(x, a.icdf(c), rtol=F64)
        np.testing.assert_allclose(b(x), a(x), rtol=F64)
    xs = np.linspace(0.0, 3.0, 50)
    a, b = js.InterpolatedPDF(xs, np.cumsum(xs + 0.1)), ts.InterpolatedPDF(xs, np.cumsum(xs + 0.1))
    np.testing.assert_allclose(b(xs * 0.97), a(xs * 0.97), rtol=F64)
    np.testing.assert_allclose(b.icdf(c), a.icdf(c), rtol=F64)
    with pytest.raises(ValueError):
        ts.PowerLawPDF(1.0, 5.0, 500.0)


@pytest.mark.parametrize("zmax", [3.5, 1.0])
def test_madau_zpdf_matches_jax(zmax):
    a, b = js.MadauZPDF(zmax=zmax), ts.MadauZPDF(zmax=zmax)
    c = np.random.default_rng(1).uniform(size=2000)
    for name in ("zinterp", "pdfinterp", "cdfinterp"):
        np.testing.assert_allclose(getattr(b, name), getattr(a, name), rtol=F64, atol=0.0)
    z = b.icdf(c)
    np.testing.assert_allclose(z, a.icdf(c), rtol=F64)
    np.testing.assert_allclose(b(z), a(z), rtol=F64)


def test_planck18_helpers_match_jax():
    z = np.concatenate([[0.0], np.geomspace(1e-4, 20.0, 500)])
    for name in ("planck18_efunc_np", "planck18_dc_np", "planck18_dl_np", "planck18_dvc_dz_np"):
        np.testing.assert_allclose(getattr(tw, name)(z), getattr(jw, name)(z), rtol=F64, atol=0.0, err_msg=name)
    dl = np.geomspace(1e-3, 150.0, 400)
    np.testing.assert_allclose(tw.planck18_z_of_dl_np(dl), jw.planck18_z_of_dl_np(dl), rtol=F64)
    rng = np.random.default_rng(2)
    m1, q, zz = rng.uniform(5, 100, 300), rng.uniform(0.1, 1, 300), rng.uniform(0.01, 3, 300)
    for cw in (False, True):
        np.testing.assert_allclose(tw.li_prior_wt(m1, q, zz, cw), jw.li_prior_wt(m1, q, zz, cw), rtol=F64)
    np.testing.assert_allclose(tw.dm1sqz_dm1ddqdl(m1, q, zz), jw.dm1sqz_dm1ddqdl(m1, q, zz), rtol=F64)


def test_default_pop_wt_matches_jax():
    rng = np.random.default_rng(3)
    m1 = rng.uniform(3.0, 200.0, (40, 50))  # spans MBH_MIN, the bump and the tail
    q, z = rng.uniform(0.02, 1.0, m1.shape), rng.uniform(0.0, 3.5, m1.shape)
    ref = jw.default_pop_wt(m1, q, z)
    got = tw.default_pop_wt(m1, q, z, device="cpu")
    assert got.dtype == np.float64 and got.shape == m1.shape
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert (ref == 0).any() and (ref > 0).any()
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=0.0)


@pytest.fixture(scope="module")
def campaigns():
    """The JAX package's 20k-draw campaign (a DataFrame) and the port's (a dict)."""
    ref = jc.draw_injection_campaign(ndraw=20_000, seed=42, snr_chunk=4096)
    got = tc.draw_injection_campaign(ndraw=20_000, seed=42, snr_chunk=4096, device="cpu")
    return ref, got


def test_campaign_matches_jax(campaigns):
    ref, got = campaigns
    assert list(got) == list(ref.columns)
    for k in got:
        want = ref[k].to_numpy()
        if k.startswith("SNR"):
            np.testing.assert_array_equal(got[k] == 0, want == 0, err_msg=k)
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=0.0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert 0 < (got["SNR"] > 0).sum() < 20_000 and (got["SNR"] > 10).sum() > 10


def test_campaign_summary_matches_jax(campaigns):
    ref, got = campaigns
    want = jc.campaign_summary(ref)
    s = tc.campaign_summary(got, device="cpu")
    assert s["n_detected"] == want["n_detected"]
    for k in ("predicted_detections_per_year", "neff_default_pop", "expected_pop_draws"):
        np.testing.assert_allclose(s[k], want[k], rtol=1e-4, err_msg=k)


def test_observation_noise_and_catalog_match_jax(campaigns):
    ref, _ = campaigns
    obs_ref = jc.add_observation_noise(ref, seed=7)
    obs = tc.add_observation_noise(convert.columns(ref), seed=7)
    assert list(obs) == list(obs_ref.columns)
    for k in obs:
        np.testing.assert_array_equal(obs[k], obs_ref[k].to_numpy(), err_msg=k)

    cat_ref = jc.draw_one_year_catalog(len(ref), obs_ref, nsamp=32, seed=11)
    cat = tc.draw_one_year_catalog(len(ref), convert.columns(obs_ref), nsamp=32, seed=11, device="cpu")
    assert list(cat) == list(cat_ref.columns) and len(cat_ref) > 0
    for k in ("m1", "q", "z", "evt"):
        np.testing.assert_array_equal(cat[k], cat_ref[k].to_numpy(), err_msg=k)
    np.testing.assert_allclose(cat["wt"], cat_ref["wt"].to_numpy(), rtol=5e-5)
    assert (np.bincount(cat["evt"])[np.unique(cat["evt"])] == 32).all()


@pytest.mark.parametrize("source_frame", [False, True])
def test_mock_pe_samples_match_jax(source_frame):
    args = (math.log(30.0), 0.05, 0.97, 0.08, math.log(1.5), 0.1)
    ref = jc.draw_mock_pe_samples(*args, size=3000, output_source_frame=source_frame,
                                  rng=np.random.default_rng(5))
    got = tc.draw_mock_pe_samples(*args, size=3000, output_source_frame=source_frame,
                                  rng=np.random.default_rng(5))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=F64)


def test_empty_catalog_has_the_columns(campaigns):
    obs = tc.add_observation_noise(campaigns[1], seed=7)
    cat = tc.draw_one_year_catalog(20_000, obs, nsamp=8, rate=0.0, device="cpu")
    assert list(cat) == ["m1", "q", "z", "wt", "evt"] and all(len(v) == 0 for v in cat.values())
