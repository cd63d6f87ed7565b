"""The calibration suite's configuration, statistics, simulators, spec
builders, SBC loops and ``_stage_sbc``, against the JAX package.

* ``SBCConfig``/``ScoreCheckConfig``: the JAX package's fields and defaults;
  ``PipelineConfig.load`` and ``to_dict`` carry them as the JAX package's do.
* ``sbc_uniformity_pvalues`` and ``rate_reconstruction_ranks``: equal to
  rtol 1e-12 (``tests/test_calibration.py:245-290``'s trials included).
* ``write_sbc_artifact``: the ``.npz`` keys and values of the JAX package's
  HDF5 file, path for path.
* The three simulators on one 20,000-draw campaign (the JAX package's, handed
  to both): with one numpy seed, identical picks (the same PE-sample and
  injection coordinates, bit for bit), the injections' ``log pdraw`` and
  ``log Ndraw`` to rtol 1e-6; the PE samples' ``pdraw`` is the fiducial
  weight ``default_pop_wt`` evaluated in float32 by each package, held at
  that function's own limit, rtol 5e-5 (``test_torch_mock.py``; one float32
  ulp of a log intensity near -20 is 2e-6).  The θ-weights over the pool,
  which decide the picks, to rtol 1e-5 (a flipped pick reports them); the
  fresh simulator's SNR channel to 1e-5.
* ``selection_log_mu`` at the JAX package's prior draws: its μ to rtol 2e-5.
* The four spec builders: the JAX package's priors, and equal potentials.
* ``run_sbc`` and ``run_sbc_fleet`` on a conjugate Gaussian toy: ranks of
  the right shape, uniform; every simulation's start picked on its own
  catalog, the truth where no candidate is finite.
* ``_stage_sbc`` (``pop`` and ``pop_cosmo``) at a tiny size.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import calibration as jcal
from bumpcosmology_tpu.inference.likelihoods import _cosmo_frame_logwts as j_frame_logwts
from bumpcosmology_tpu.inference.likelihoods import cosmo_from_sites as j_cosmo_from_sites
from bumpcosmology_tpu.inference.likelihoods import population_from_sites as j_population_from_sites
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import make_potential as j_make_potential
from bumpcosmology_tpu.inference.model import prior_sample as jprior_sample
from bumpcosmology_tpu.mock import add_observation_noise as j_add_observation_noise
from bumpcosmology_tpu.mock import draw_injection_campaign as j_draw_injection_campaign
from bumpcosmology_tpu.models.cosmology import build_cosmology as j_build_cosmology
from bumpcosmology_tpu.models.population import build_population as j_build_population
from bumpcosmology_tpu.models.population import log_dndmdqdv as j_log_dndmdqdv
from bumpcosmology_tpu.pipeline import config as jconfig
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_tpu.testing import synthetic_pop_data as j_synthetic_pop_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import calibration as cal
from bumpcosmology_torch.inference.distributions import Normal
from bumpcosmology_torch.inference.model import ModelSpec, make_potential, value_and_grad
from bumpcosmology_torch.pipeline import config as tconfig

CPU = torch.device("cpu")


# ---- configuration ---------------------------------------------------------


@pytest.mark.parametrize("name", ["SBCConfig", "ScoreCheckConfig"])
def test_calibration_configs_match_jax(name):
    assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(getattr(jconfig, name)())


def test_pipeline_config_loads_the_calibration_sections_as_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"sbc": {"n_sims": 4, "model": "pop_cosmo"}, "score": {"n_catalogs": 7}}))
    overrides = ["sbc.nobs=5", "sbc.fresh_noise=false", "score.z_bar=3.5", "score.model=plpeak_cosmo"]
    got = tconfig.PipelineConfig.load(str(path), overrides)
    ref = jconfig.PipelineConfig.load(str(path), overrides)
    assert got.sbc.n_sims == 4 and got.sbc.nobs == 5 and got.sbc.fresh_noise is False
    assert got.score.n_catalogs == 7 and got.score.z_bar == 3.5 and got.score.model == "plpeak_cosmo"
    for section in ("sbc", "score"):
        assert got.to_dict()[section] == ref.to_dict()[section]
    with pytest.raises(KeyError, match="sbc.no_such_key"):
        tconfig.PipelineConfig.load(overrides=["sbc.no_such_key=1"])


# ---- statistics ------------------------------------------------------------


@pytest.mark.parametrize("n,n_bins,seed", [(20, 65, 0), (7, 17, 1), (200, 257, 2)])
def test_sbc_uniformity_pvalues_match_jax(n, n_bins, seed):
    rng = np.random.default_rng(seed)
    ranks = {"a": rng.integers(0, n_bins, n), "h": rng.integers(0, n_bins // 3, n), "__n_bins__": np.asarray(n_bins)}
    got, ref = cal.sbc_uniformity_pvalues(ranks), jcal.sbc_uniformity_pvalues(ranks)
    assert list(got) == list(ref) == ["a", "h"]
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=0)


def test_rate_reconstruction_ranks_match_jax():
    """The JAX test's trials (log-normal μ around 24, ``test_calibration.py:245-263``),
    and trials small enough to draw nobs = 0 (rank 1)."""
    from scipy.stats import kstest

    mu = np.exp(np.random.default_rng(7).normal(np.log(24.0), 0.5, size=2048))
    mu[:64] = 1e-3
    got = cal.rate_reconstruction_ranks(mu, r_true=2.3, rng=np.random.default_rng(7))
    ref = jcal.rate_reconstruction_ranks(mu, r_true=2.3, rng=np.random.default_rng(7))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert (got[:64] == 1.0).sum() > 50 and np.all((got >= 0.0) & (got <= 1.0))
    assert kstest(got[64:], "uniform").pvalue >= 0.01


def test_write_sbc_artifact_matches_the_hdf5_layout(tmp_path):
    """Every dataset path and attribute of the JAX package's ``sbc_ranks.h5``
    is a key of ``sbc_ranks.npz`` (attributes under ``attrs/``), with its value."""
    import h5py

    from bumpcosmology_torch.pipeline.stages import write_sbc_artifact
    from bumpcosmology_tpu.pipeline.stages import write_sbc_artifact as j_write_sbc_artifact

    ranks = {"lam": np.arange(8), "h": np.arange(8)[::-1], "__n_bins__": 64}
    pvals = {"lam": 0.002, "h": 0.73}
    rate = np.linspace(0.01, 0.99, 9)
    assert (j_write_sbc_artifact(tmp_path / "r.h5", "pop_cosmo", 8, ranks, pvals, rate, 0.4)
            == write_sbc_artifact(tmp_path / "r.npz", "pop_cosmo", 8, ranks, pvals, rate, 0.4) == ["lam"])
    ref = {}
    with h5py.File(tmp_path / "r.h5") as f:
        ref.update({f"attrs/{k}": v for k, v in f.attrs.items()})

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                ref[name] = obj[()]
            ref.update({f"{name}/attrs/{k}": v for k, v in obj.attrs.items()})

        f.visititems(visit)
    with np.load(tmp_path / "r.npz") as d:
        got = {k: d[k] for k in d.files}
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        if v.dtype.kind in "SO":
            v = v.astype(str)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---- simulators ------------------------------------------------------------


@pytest.fixture(scope="module")
def campaign():
    """One 20,000-draw campaign and its detections at SNR 10, from the JAX
    package, as DataFrames (for it) and column dicts (for the port)."""
    inj = j_draw_injection_campaign(ndraw=20_000, seed=35, snr_chunk=8192)
    obs = j_add_observation_noise(inj, seed=36, threshold=10.0)
    return inj, obs, convert.columns(inj), convert.columns(obs)


def _sites(proto, seed):
    return {k: np.asarray(v) for k, v in jconstrain(proto, jprior_sample(proto, jax.random.PRNGKey(seed))).items()}


def _same_catalog(got, ref, weights_note):
    """Identical picks: the coordinates bit for bit; the injections' ``log
    pdraw`` to 1e-6, the PE samples' fiducial ``pdraw`` to ``default_pop_wt``'s 5e-5."""
    for part in ("events", "selection"):
        g, r = getattr(got, part), getattr(ref, part)
        for k in ("a", "q", "c"):
            gk, rk = getattr(g, k).numpy(), np.asarray(getattr(r, k))
            bad = np.argwhere(gk != rk)
            assert not len(bad), f"{part}.{k} differs first at {bad[0].tolist()}: a pick flipped; {weights_note}"
    np.testing.assert_allclose(got.selection.log_pdraw.numpy(), np.asarray(ref.selection.log_pdraw), rtol=1e-6)
    np.testing.assert_allclose(float(got.selection.log_ndraw), float(ref.selection.log_ndraw), rtol=1e-6)
    pdraw_ratio = np.exp(got.events.log_pdraw.numpy().astype(np.float64) - np.asarray(ref.events.log_pdraw))
    np.testing.assert_allclose(pdraw_ratio, 1.0, rtol=0, atol=5e-5)


def _weights_note(got_logw, ref_logw):
    """The θ-weights over the pool, held to rtol 1e-5 (they decide the picks); their largest difference."""
    g, r = np.asarray(got_logw, np.float64), np.asarray(ref_logw, np.float64)
    assert np.array_equal(np.isfinite(g), np.isfinite(r))
    fin = np.isfinite(r)
    w_g, w_r = np.exp(g[fin] - r[fin].max()), np.exp(r[fin] - r[fin].max())
    np.testing.assert_allclose(w_g, w_r, rtol=1e-5, atol=1e-12)
    return f"pool weights differ by at most {np.max(np.abs(w_g - w_r) / np.maximum(w_r, 1e-300)):.2e} (relative)"


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def test_mock_pop_simulator_matches_jax(campaign):
    inj, obs, _, obs_t = campaign
    kw = dict(n_total_injections=len(inj), nobs=5, nsamp=16, nsel=64, pe_bank_size=512, seed=7)
    ref_sim = jcal.make_mock_pop_simulator(obs, **kw)
    got_sim = cal.make_mock_pop_simulator(obs_t, **kw, device=CPU)
    sites = _sites(jcal.make_pop_sbc_spec_builder()(None), 37)
    m1, q, z = (obs_t[k] for k in ("m1", "q", "z"))
    ref_w = j_log_dndmdqdv(j_build_population(j_population_from_sites(sites)), m1, q, z)
    from bumpcosmology_torch.inference.likelihoods import population_from_sites
    from bumpcosmology_torch.models.population import build_population, log_dndmdqdv

    pop = build_population(population_from_sites(cal._site_tensors(sites, CPU)))
    note = _weights_note(log_dndmdqdv(pop, _t(m1)[None], _t(q)[None], _t(z)[None])[0].detach(), ref_w)
    for seed in (1, 2):
        _same_catalog(got_sim(np.random.default_rng(seed), sites), ref_sim(np.random.default_rng(seed), sites), note)


def _cosmo_weights_note(sites, m1d, q, dl, log_pdraw):
    ref = j_frame_logwts(j_build_population(j_population_from_sites(sites)),
                         j_build_cosmology(j_cosmo_from_sites(sites)), m1d.astype(np.float32),
                         q.astype(np.float32), dl.astype(np.float32), log_pdraw.astype(np.float32))
    from bumpcosmology_torch.inference.likelihoods import population_from_sites
    from bumpcosmology_torch.models.population import build_population

    s = cal._site_tensors(sites, CPU)
    got = cal._frame_logwts(build_population(population_from_sites(s)), s, m1d, q, dl, log_pdraw, CPU)[0]
    return _weights_note(got.detach(), ref)


def test_mock_pop_cosmo_simulator_matches_jax(campaign):
    from bumpcosmology_torch.data.weights import dm1sqz_dm1ddqdl, planck18_dl_np

    inj, obs, _, obs_t = campaign
    kw = dict(n_total_injections=len(inj), nobs=4, nsamp=16, nsel=48, pe_bank_size=512, seed=27)
    ref_sim = jcal.make_mock_pop_cosmo_simulator(obs, **kw)
    got_sim = cal.make_mock_pop_cosmo_simulator(obs_t, **kw, device=CPU)
    sites = _sites(jcal.make_pop_cosmo_sbc_spec_builder()(None), 38)
    m1, q, z = (obs_t[k] for k in ("m1", "q", "z"))
    note = _cosmo_weights_note(sites, m1 * (1 + z), q, planck18_dl_np(z),
                               np.log(obs_t["pdraw_mqz"] * dm1sqz_dm1ddqdl(m1, q, z)))
    for seed in (3, 4):
        _same_catalog(got_sim(np.random.default_rng(seed), sites), ref_sim(np.random.default_rng(seed), sites), note)


def test_fresh_noise_simulator_matches_jax(campaign):
    """Fresh noise, fresh pools and banks with the observed-SNR channel: the
    same catalogs from one seed (the bank weights carry kernel C's amplitude
    through the SNR channel)."""
    inj, _, inj_t, _ = campaign
    kw = dict(nobs=4, nsamp=16, nsel=48, pe_bank_size=512, threshold=10.0, snr_channel=True, max_bank_doublings=2)
    ref_sim = jcal.make_mock_pop_cosmo_simulator_fresh(inj, **kw)
    got_sim = cal.make_mock_pop_cosmo_simulator_fresh(inj_t, **kw, device=CPU)
    sites = _sites(jcal.make_pop_cosmo_sbc_spec_builder()(None), 39)
    for seed in (5, 6):
        _same_catalog(got_sim(np.random.default_rng(seed), sites), ref_sim(np.random.default_rng(seed), sites),
                      "the fresh simulator's θ-weights are held by the shared-bank test")


def test_fresh_simulator_snr_channel_matches_jax(campaign):
    """The channel's predicted SNR A(m1_det, m2_det) Θ / dL on bank rows
    (kernel C's twin for A), to the campaign test's 1e-5."""
    from bumpcosmology_torch.mock.catalog import draw_mock_pe_samples
    from bumpcosmology_torch.mock.snr import amplitude_factor, draw_projection_factors
    from bumpcosmology_tpu.mock.snr import amplitude_factor as j_amplitude_factor
    from bumpcosmology_tpu.mock.snr import draw_projection_factors as j_draw_projection_factors

    m1d, q, dl, _ = draw_mock_pe_samples(np.log(25.0), 0.05, 0.7, 0.07, np.log(1.5), 0.2, size=(3, 600),
                                         rng=np.random.default_rng(40))
    got = amplitude_factor(m1d, m1d * q, device=CPU) * draw_projection_factors(np.random.default_rng(41), m1d.shape,
                                                                                device=CPU) / dl
    ref = j_amplitude_factor(m1d, m1d * q) * j_draw_projection_factors(np.random.default_rng(41), m1d.shape) / dl
    assert got.shape == (3, 600)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_selection_log_mu_matches_jax(campaign):
    inj, _, inj_t, _ = campaign
    key = jax.random.PRNGKey(9)
    ref = jcal.selection_mu_samples(inj, "bump", 6, key, threshold=10.0)
    proto = jcal.make_pop_cosmo_sbc_spec_builder()(None)
    thetas = jax.vmap(lambda k: jprior_sample(proto, k))(jax.random.split(key, 6))
    log_mu = cal.selection_log_mu(inj_t, "bump", convert.theta_batch(thetas, CPU), threshold=10.0, device=CPU)
    np.testing.assert_allclose(np.exp(log_mu - np.median(log_mu)) * (56.0 / 2.3), ref, rtol=2e-5)
    mu = cal.selection_mu_samples(inj_t, "bump", 7, generator=3, threshold=10.0, device=CPU)
    assert mu.shape == (7,) and np.median(2.3 * mu) == pytest.approx(56.0)


# ---- spec builders -----------------------------------------------------------


@pytest.mark.parametrize("name", ["make_pop_sbc_spec_builder", "make_pop_cosmo_sbc_spec_builder",
                                  "make_plpeak_cosmo_sbc_spec_builder", "make_brokenpl_cosmo_sbc_spec_builder"])
def test_spec_builders_match_jax(name):
    """The prototype's priors (the SBC mmin slice included) and the potential
    of a catalog, at n_grid 48 and n_z 64."""
    joint = name != "make_pop_sbc_spec_builder"
    grids = dict(n_grid=48, n_z=64) if joint else dict(n_grid=48)
    ref_b, got_b = getattr(jcal, name)(**grids), getattr(cal, name)(**grids, device=CPU)
    ref_p, got_p = ref_b(None), got_b(None)
    assert list(got_p.priors) == list(ref_p.priors)
    for k, d in ref_p.priors.items():
        assert type(got_p.priors[k]).__name__ == type(d).__name__ and tuple(got_p.priors[k]) == tuple(d), k
    jd = (j_synthetic_pop_cosmo_data if joint else j_synthetic_pop_data)(4, 16, 64, seed=8)
    td = convert.pop_cosmo_data(jd, CPU) if joint else convert.pop_data(jd, CPU)
    theta = jprior_sample(ref_p, jax.random.PRNGKey(10))
    u_ref, g_ref = jax.jit(jax.value_and_grad(j_make_potential(ref_b(jd))))(theta)
    u, g = value_and_grad(make_potential(got_b(td)), convert.theta_batch(theta, CPU))
    assert abs(float(u[0]) - float(u_ref)) / (1 + abs(float(u_ref))) < 2e-4
    g_ref = np.asarray(g_ref, np.float64)
    assert np.max(np.abs(g[0].numpy() - g_ref) / (1 + np.abs(g_ref))) < 5e-3


# ---- the SBC loops on a conjugate toy -----------------------------------------


def _toy_spec(data):
    """y ~ N(mu, 1) x 20 with mu ~ N(0, 2): a fit whose ranks are uniform."""
    loglike = (lambda s: torch.zeros_like(s["mu"])) if data is None else (
        lambda s: -0.5 * ((data - s["mu"]) ** 2).sum(-1))
    return ModelSpec(priors={"mu": Normal(0.0, 2.0)}, loglike=loglike, device=CPU)


def _toy_simulate(rng, sites):
    return torch.as_tensor(rng.normal(float(sites["mu"]), 1.0, size=20), dtype=torch.float32)


def _toy_make_loglike(datas):
    return lambda sites, d: -0.5 * ((d - sites["mu"][:, None]) ** 2).sum(-1)


def test_run_sbc_on_a_conjugate_toy():
    ranks = cal.run_sbc(_toy_spec, _toy_simulate, n_sims=3, generator=1, num_warmup=30, num_samples=16, thin=4,
                        verbose=False, device=CPU)
    assert set(ranks) == {"mu", "__n_bins__"} and int(ranks["__n_bins__"]) == 16 // 4 + 1
    assert ranks["mu"].shape == (3,) and np.all((ranks["mu"] >= 0) & (ranks["mu"] <= 4))


def test_run_sbc_fleet_ranks_are_uniform_on_a_conjugate_toy(capsys):
    from scipy.stats import kstest

    ranks = cal.run_sbc_fleet(_toy_spec(None), _toy_make_loglike, _toy_simulate, n_sims=60, generator=2,
                              num_warmup=60, num_samples=64, thin=4, seed=3, chunk_size=10, device=CPU)
    assert "[sbc] 60 simulations drawn" in capsys.readouterr().out
    n_bins = int(ranks["__n_bins__"])
    assert n_bins == 17 and ranks["mu"].shape == (60,) and np.all((ranks["mu"] >= 0) & (ranks["mu"] < n_bins))
    # ranks in [0, 16] with ties broken uniformly are U(0, 1) under calibration
    u = (ranks["mu"] + np.random.default_rng(4).uniform(size=60)) / n_bins
    assert kstest(u, "uniform").pvalue > 1e-3
    assert cal.sbc_uniformity_pvalues(ranks)["mu"] > 1e-3


def test_run_sbc_fleet_starts_each_fit_from_its_own_catalog(monkeypatch):
    """Simulation 0's potential is finite only where mu > 0, simulation 1's
    only where mu < 0, simulation 2's nowhere but at its truth: each start is
    the first of the 16 candidates finite on its own catalog, and simulation
    2 starts at its truth."""
    from bumpcosmology_torch.inference import fleet

    seen = {}

    def fake_fleet_fit(make_pot, datas, theta0, *args, num_samples=8, **kwargs):
        seen["theta0"] = theta0
        return fleet.FleetResult(theta0[:, None].expand(-1, num_samples, -1), torch.ones(3, num_samples),
                                 torch.ones(3))

    monkeypatch.setattr(fleet, "fleet_fit", fake_fleet_fit)

    def simulate(rng, sites):
        seen.setdefault("truths", []).append(float(sites["mu"]))
        return torch.tensor([float(len(seen["truths"]) - 1), float(sites["mu"])])

    def make_loglike(datas):
        def loglike(sites, d):
            kind, truth, mu = d[:, 0], d[:, 1], sites["mu"]
            ok = torch.where(kind == 0, mu > 0, torch.where(kind == 1, mu < 0, mu == truth))
            return torch.where(ok, torch.zeros_like(mu), torch.full_like(mu, -math.inf))
        return loglike

    cal.run_sbc_fleet(_toy_spec(None), make_loglike, simulate, n_sims=3, generator=5, num_samples=8,
                      verbose=False, device=CPU)
    theta0 = seen["theta0"][:, 0]
    assert float(theta0[0]) > 0 and float(theta0[1]) < 0 and float(theta0[2]) == seen["truths"][2]


# ---- the stage ---------------------------------------------------------------


def _tiny_sbc_config(tmp_path, model, **kw):
    cfg = tconfig.PipelineConfig(paths=tconfig.PathsConfig(data_dir=str(tmp_path)), sbc=tconfig.SBCConfig(
        model=model, n_sims=3, nobs=4, nsamp=16, nsel=64, num_warmup=20, num_samples=12, max_depth=3,
        pe_bank_size=512, threshold=10.0, **kw))
    cfg.fit.n_grid, cfg.fit.n_z, cfg.mock.snr_chunk = 48, 64, 8192
    return cfg


@pytest.mark.parametrize("model,ndraw", [("pop", 30_000), ("pop_cosmo", 400_000), ("plpeak_cosmo", 400_000),
                                         ("brokenpl_cosmo", 400_000)])
def test_stage_sbc_tiny(tmp_path, capsys, model, ndraw):
    """``_stage_sbc`` end to end at a tiny size (the joint models: the
    fresh-noise simulator's 2,048-row pool needs the larger campaign):
    ``sbc_ranks.npz`` with the JAX layout's keys, the family's sites
    (``COSMO_SBC_SPEC_BUILDERS`` without ``R_unit``), ranks in [0, n_bins),
    the rate check on every joint model, its lines printed."""
    from bumpcosmology_torch.pipeline.stages import _JOINT_FAMILY, _stage_sbc

    report = _stage_sbc(_tiny_sbc_config(tmp_path, model, campaign_ndraw=ndraw), device=CPU)
    out = capsys.readouterr().out
    assert "[sbc] 3 simulations drawn; launching fleet fit" in out and "[sbc] uniformity p-values:" in out
    with np.load(tmp_path / "sbc_ranks.npz") as d:
        art = {k: d[k] for k in d.files}
    family = _JOINT_FAMILY.get(model)
    proto = (cal.COSMO_SBC_SPEC_BUILDERS[family] if family else cal.make_pop_sbc_spec_builder)(device=CPU)(None)
    sites = [k for k in proto.priors if k != "R_unit"]
    expected = {"attrs/model", "attrs/n_sims", "attrs/all_pass", "ranks/n_bins", "pvalues/site", "pvalues/p",
                "pvalues/passed"} | {f"ranks/{k}" for k in sites} | {f"pvalues/attrs/{k}" for k in sites}
    assert report["pvalues"] == dict(zip((str(x) for x in art["pvalues/site"]), art["pvalues/p"].tolist()))
    assert report["sampling_transitions"] == 12 and report["sampling_evals"] >= 12
    if family:
        assert report["rate_p"] == float(art["rate_check/attrs/p"])
        expected |= {"rate_check/ranks", "rate_check/attrs/p", "rate_check/attrs/passed", "rate_check/attrs/method"}
        assert "[sbc] rate-reconstruction rank uniformity: p=" in out and "WARNING: rate" not in out
        assert art["rate_check/ranks"].shape == (512,) and np.isfinite(art["rate_check/ranks"]).all()
    assert set(art) == expected
    assert str(art["attrs/model"]) == model and int(art["attrs/n_sims"]) == 3 and int(art["ranks/n_bins"]) == 4
    for k in sites:
        assert art[f"ranks/{k}"].shape == (3,) and np.all((art[f"ranks/{k}"] >= 0) & (art[f"ranks/{k}"] < 4))
    assert sorted(str(s) for s in art["pvalues/site"]) == sorted(sites)


def test_stage_sbc_rejects_an_unknown_model(tmp_path):
    from bumpcosmology_torch.pipeline.stages import _stage_sbc

    with pytest.raises(ValueError, match="unknown sbc model"):
        _stage_sbc(_tiny_sbc_config(tmp_path, "nope", campaign_ndraw=2_000), device=CPU)
