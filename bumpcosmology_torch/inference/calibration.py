"""Simulation-based calibration (SBC) harness (L2); counterpart of the JAX
package's ``inference/calibration.py``.

Validates the whole inference stack (priors → simulator → likelihood → NUTS)
by the rank statistic of Talts et al. (2018): draw hyperparameters from the
prior, simulate a catalog, fit, and record the rank of the true value among
the (thinned) posterior draws; ranks must be uniform.

* **Simulators** (:func:`make_mock_pop_simulator`,
  :func:`make_mock_pop_cosmo_simulator`,
  :func:`make_mock_pop_cosmo_simulator_fresh`) take the port's campaign and
  observation tables (``{column: numpy array}``) and return the port's
  :class:`~bumpcosmology_torch.inference.likelihoods.PopData` /
  ``PopCosmoData`` on ``device``.  Their draws stay on the caller's
  ``numpy.random.Generator`` in the JAX package's order, so one seed gives
  the JAX package's catalogs; their θ-dependent weights (the intensity, the
  frame Jacobian, the fiducial weights and the SNR channel's amplitude) run
  on ``device``.  The PE banks are θ-independent (drawn from measurement
  likelihood × fiducial population with ``pdraw`` recorded); only the event
  selection depends on the prior draw.  Catalogs hold a fixed ``nobs``, so
  the rate site ``R_unit`` is left out of the ranks.
* **Fits**: :func:`run_sbc` one fit per simulation; :func:`run_sbc_fleet`
  all simulations as one fleet (:func:`~bumpcosmology_torch.inference.fleet.fleet_fit`),
  the catalogs stacked on a leading axis and chain ``s`` reading catalog
  ``s``.  The truths, the initial candidates and the momenta come from one
  ``torch.Generator`` where the JAX package splits keys, so the ranks do not
  match the JAX package's draw for draw; everything deterministic does.
* **Statistics** (:func:`sbc_uniformity_pvalues`,
  :func:`rate_reconstruction_ranks`) are numpy and scipy, as in the JAX
  package.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import (
    BROKENPL_COSMO_PRIORS,
    PLPEAK_COSMO_PRIORS,
    POP_COSMO_PRIORS,
    POP_PRIORS,
    PopData,
    _cosmo_frame_logwts,
    brokenpl_cosmo_loglike,
    brokenpl_from_sites,
    cosmo_from_sites,
    dl_bounds_of,
    make_pop_cosmo_data,
    make_pop_data,
    plpeak_cosmo_loglike,
    plpeak_from_sites,
    pop_cosmo_model_spec,
    pop_model_spec,
    population_from_sites,
    stack_fleet,
)
from bumpcosmology_torch.inference.model import ModelSpec, _log_prior_and_jac, constrain, prior_sample
from bumpcosmology_torch.models.brokenpl import build_brokenpl_population
from bumpcosmology_torch.models.cosmology import build_cosmology
from bumpcosmology_torch.models.plpeak import build_plpeak_population
from bumpcosmology_torch.models.population import build_population, log_dndmdqdv

__all__ = [
    "run_sbc",
    "run_sbc_fleet",
    "make_mock_pop_simulator",
    "make_mock_pop_cosmo_simulator",
    "make_mock_pop_cosmo_simulator_fresh",
    "make_pop_sbc_spec_builder",
    "make_pop_cosmo_sbc_spec_builder",
    "make_plpeak_cosmo_sbc_spec_builder",
    "make_brokenpl_cosmo_sbc_spec_builder",
    "COSMO_SBC_SPEC_BUILDERS",
    "sbc_uniformity_pvalues",
    "rate_reconstruction_ranks",
    "selection_log_mu",
    "selection_mu_samples",
]


def _col(table, name) -> np.ndarray:
    return np.asarray(table[name])


def _n_rows(table) -> int:
    return len(_col(table, "m1"))


def _generator(generator, dev) -> torch.Generator:
    """``generator`` itself, or a generator on ``dev`` seeded with it (an int, ``None`` as 0)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=dev).manual_seed(int(generator or 0))


def _zero_loglike(sites):
    return torch.zeros_like(next(iter(sites.values())))


def _site_tensors(sites, dev) -> Dict[str, torch.Tensor]:
    """One draw's sites (numpy scalars or 0-d arrays) as ``(1,)`` float32 tensors on ``dev``."""
    return {k: torch.tensor([float(v)], dtype=torch.float32, device=dev) for k, v in sites.items()}


def _family_builder(family: str) -> Callable:
    """``sites → intensity`` of a mass family at its default grid, as the JAX simulators build it."""
    if family == "bump":
        return lambda s: build_population(population_from_sites(s))
    if family == "plpeak":
        return lambda s: build_plpeak_population(plpeak_from_sites(s))
    if family == "brokenpl":
        return lambda s: build_brokenpl_population(brokenpl_from_sites(s))
    raise ValueError(f"unknown intensity family {family!r}")


def _frame_logwts(pop, sites_t, m1d, q, dl, log_pdraw, dev) -> torch.Tensor:
    """``(C, N)`` detector-frame weights of host rows on ``dev`` (the JAX
    package's non-fused ``_cosmo_frame_logwts`` on float32 rows)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)  # noqa: E731
    cosmo = build_cosmology(cosmo_from_sites(sites_t))
    return _cosmo_frame_logwts(pop, cosmo, (f32(m1d), f32(q), f32(dl), f32(log_pdraw)))


def rate_reconstruction_ranks(mu_samples: np.ndarray, r_true: float, rng: np.random.Generator) -> np.ndarray:
    """Frequentist rank-calibration of the rate reconstruction
    (``rate_reconstruction_ranks``, the JAX package's ``calibration.py:57-93``).

    ``R`` is never a fitted site: it is derived post hoc as ``R = nobs/mu +
    sqrt(nobs)/mu * R_unit``.  For each trial, ``nobs ~ Poisson(r_true *
    mu)`` and the reconstruction's CDF at the truth is
    ``Phi((r_true - nobs/mu) * mu / sqrt(nobs))``; under a calibrated
    reconstruction these ranks are U(0, 1).  ``nobs = 0`` trials get rank 1.
    """
    from scipy.special import ndtr

    mu = np.asarray(mu_samples, dtype=np.float64)
    nobs = rng.poisson(r_true * mu)
    with np.errstate(divide="ignore", invalid="ignore"):
        rank = ndtr((r_true - nobs / mu) * mu / np.sqrt(np.maximum(nobs, 1)))
    return np.where(nobs == 0, 1.0, rank)


def sbc_uniformity_pvalues(ranks: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per-site chi-square uniformity p-values over coarse rank bins."""
    import scipy.stats as ss

    n_bins_total = int(ranks["__n_bins__"])
    out = {}
    for site, r in ranks.items():
        if site == "__n_bins__":
            continue
        n = len(r)
        k = max(2, min(10, n // 5))  # coarse bins with >=5 expected each
        edges = np.linspace(0, n_bins_total, k + 1)
        counts, _ = np.histogram(r, bins=edges)
        chi2 = np.sum((counts - n / k) ** 2 / (n / k))
        out[site] = float(ss.chi2.sf(chi2, df=k - 1))
    return out


def _ranks(post: Dict[str, np.ndarray], sites_trues, thin: int, skip_sites) -> Dict[str, np.ndarray]:
    """Rank of each truth among the thinned draws ``post[site][s]`` of simulation ``s``."""
    ranks: Dict[str, list] = {}
    n_bins = None
    for s, truths in enumerate(sites_trues):
        for site, truth in truths.items():
            if site in skip_sites:
                continue
            draws = post[site][s][::thin]
            n_bins = len(draws)
            ranks.setdefault(site, []).append(int(np.sum(draws < truth)))
    out = {k: np.asarray(v) for k, v in ranks.items()}
    out["__n_bins__"] = np.asarray(n_bins + 1 if n_bins else 0)
    return out


def _draw_truth(proto: ModelSpec, gen: torch.Generator):
    theta = prior_sample(proto, gen)
    return theta, {k: v.cpu().numpy() for k, v in constrain(proto, theta).items()}


def run_sbc(
    make_spec: Callable[[object], ModelSpec],
    simulate: Callable,
    n_sims: int,
    generator=None,
    num_warmup: int = 200,
    num_samples: int = 256,
    num_chains: int = 1,
    thin: int = 4,
    skip_sites: Sequence[str] = ("R_unit",),
    seed: int = 0,
    verbose: bool = True,
    device=None,
) -> Dict[str, np.ndarray]:
    """SBC loop, one fit per simulation: per-site rank arrays of shape (n_sims,).

    ``make_spec(data)`` returns a ModelSpec whose priors generate the θ
    draws (``make_spec(None)`` the prior-only prototype); ``simulate(rng,
    sites)`` returns the data of one prior draw.  Truths and fits draw from
    ``generator`` (a ``torch.Generator``, or an int that seeds one on
    ``device``); the simulator from ``numpy.random.default_rng(seed)``.
    """
    from bumpcosmology_torch.inference.sampler import fit

    dev = resolve_device(device)
    gen = _generator(generator, dev)
    rng = np.random.default_rng(seed)
    proto = make_spec(None)
    trues, posts = [], {}
    for i in range(n_sims):
        _, sites_true = _draw_truth(proto, gen)
        res = fit(make_spec(simulate(rng, sites_true)), gen, num_warmup=num_warmup, num_samples=num_samples,
                  num_chains=num_chains, verbose=False, device=dev)
        trues.append(sites_true)
        for site in sites_true:
            posts.setdefault(site, []).append(res.posterior[site].reshape(-1))
        if verbose:
            print(f"[sbc] sim {i + 1}/{n_sims} done", flush=True)
    return _ranks(posts, trues, thin, skip_sites)


def run_sbc_fleet(
    proto_spec: ModelSpec,
    make_loglike: Callable,
    simulate: Callable,
    n_sims: int,
    generator=None,
    num_warmup: int = 300,
    num_samples: int = 256,
    thin: int = 4,
    skip_sites: Sequence[str] = ("R_unit",),
    seed: int = 0,
    verbose: bool = True,
    cfg=None,
    chunk_size: int = 25,
    device=None,
    stats: Optional[dict] = None,
    probe: int = 0,
    checkpoint_path: Optional[str] = None,
    warmup_only: bool = False,
) -> Optional[Dict[str, np.ndarray]]:
    """SBC with all simulations fit as one fleet.

    ``proto_spec``: a ModelSpec whose priors are the generating distribution
    (its loglike is unused).  ``make_loglike(datas) -> loglike(sites, data)``
    builds the likelihood of a fleet's data (capturing fleet-wide facts such
    as the dL table bounds); ``loglike`` takes sites of shape ``(S',)`` and
    the fleet of those S' catalogs.

    Each simulation's fit starts from the first of 16 prior candidates whose
    potential is finite on its own catalog (16 batched evaluations over the
    fleet), the truth where none is.  Draws come from ``generator`` (a
    ``torch.Generator`` or an int seed) on ``device``; the simulator from
    ``numpy.random.default_rng(seed)``.

    ``stats``, a dict, receives the host-clock seconds of the simulations
    (``simulate_s``), the initial candidates (``init_s``), the warmup and
    the sampling, the fleet's batched value+grads in each, its transitions
    and the divergent draws.  ``probe`` T > 0 (below 20, the first T steps
    of the warmup's opening buffer) draws the catalogs, runs T warmup
    transitions, fills ``stats`` and returns None.  ``checkpoint_path``
    splits the fleet fit at the end of its warmup (``fleet_fit``'s); with
    ``warmup_only`` the run stops there, writes it and returns None, and a
    later run with the same arguments samples from it (the same ranks as
    one run).
    """
    from bumpcosmology_torch.inference.fleet import fleet_fit
    from bumpcosmology_torch.inference.nuts import NutsConfig

    if not 0 <= probe < 20:
        raise ValueError(f"probe must lie in [0, 20) transitions (the opening buffer's), got {probe}")
    if warmup_only and checkpoint_path is None:
        raise ValueError("warmup_only needs a checkpoint_path to write the adapted state to")
    stats = {} if stats is None else stats
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    theta_trues, sites_trues, datas_list = [], [], []
    for _ in range(n_sims):
        theta_true, sites_true = _draw_truth(proto_spec, gen)
        theta_trues.append(theta_true)
        sites_trues.append(sites_true)
        datas_list.append(simulate(rng, sites_true))
    datas = stack_fleet(datas_list)
    theta_true_arr = torch.stack(theta_trues)
    t1 = time.perf_counter()
    if verbose:
        print(f"[sbc] {n_sims} simulations drawn; launching fleet fit", flush=True)

    loglike = make_loglike(datas)

    def make_pot(data):
        def pot(theta):
            return -(_log_prior_and_jac(proto_spec, theta) + loglike(constrain(proto_spec, theta), data))

        return pot

    # finite inits: prior candidates, each on its own simulation's catalog; the truth as fallback
    n_cand = 16
    cands = prior_sample(proto_spec, gen, shape=(n_sims, n_cand))  # (S, n_cand, dim)
    pot = make_pot(datas)
    with torch.no_grad():
        u = torch.stack([pot(cands[:, j]) for j in range(n_cand)], dim=1)
    finite = torch.isfinite(u)
    idx = torch.argmax(finite.int(), dim=1)
    picked = cands[torch.arange(n_sims, device=cands.device), idx]
    theta0 = torch.where(finite.any(dim=1)[:, None], picked, theta_true_arr)

    progress, evals = None, [0]
    if verbose:
        def progress(phase, done, total):
            if done % 100 == 0 or done == total:
                print(f"[sbc/fleet] {phase} {done}/{total} ({time.perf_counter() - t2:.0f} s, {evals[0]} batched "
                      "value+grads)", flush=True)

    def counted_make_pot(data):
        pot = make_pot(data)

        def counted(theta):
            evals[0] += 1
            return pot(theta)

        return counted

    t2 = time.perf_counter()
    if probe:
        num_warmup, num_samples, checkpoint_path = probe, 0, None
    elif warmup_only:
        num_samples = 0
    res = fleet_fit(counted_make_pot, datas, theta0, gen, num_warmup=num_warmup, num_samples=num_samples,
                    cfg=cfg or NutsConfig(), progress=progress, chunk_size=chunk_size, device=dev,
                    checkpoint_path=checkpoint_path)
    stats.update(simulate_s=t1 - t0, init_s=t2 - t1, warmup_s=res.warmup_s, sampling_s=res.sampling_s,
                 warmup_evals=res.warmup_evals, sampling_evals=res.sampling_evals,
                 warmup_transitions=num_warmup if res.warmup_evals else 0, sampling_transitions=num_samples,
                 divergences=res.divergences)
    if probe:
        stats["probe_ms_by_chains"] = _ms_by_active_chains(make_pot, datas, theta0)
    if probe or warmup_only:
        return None
    if not bool(torch.isfinite(res.thetas).all()):
        raise AssertionError("non-finite fleet draws")
    post = {k: v.cpu().numpy() for k, v in constrain(proto_spec, res.thetas).items()}
    return _ranks(post, sites_trues, thin, skip_sites)


def _ms_by_active_chains(make_pot, datas, theta0, reps: int = 3) -> Dict[int, float]:
    """Host-clock ms of one batched value+grad of the fleet's potential with
    all S chains active and with S/2, S/8 and 1 of them (NUTS evaluates the
    chains still integrating through ``on_chains``), each the mean of
    ``reps`` after one untimed call."""
    from bumpcosmology_torch.inference.fleet import FleetPotential
    from bumpcosmology_torch.inference.model import value_and_grad

    fleet = FleetPotential(make_pot, datas)
    s = theta0.shape[0]
    sync = torch.cuda.synchronize if theta0.device.type == "cuda" else (lambda: None)
    out = {}
    for k in sorted({s, max(s // 2, 1), max(s // 8, 1), 1}, reverse=True):
        idx = torch.arange(k, device=theta0.device)
        for i in range(reps + 1):
            if i == 1:
                sync()
                t0 = time.perf_counter()
            pot = fleet if k == s else fleet.on_chains(idx)
            value_and_grad(pot, theta0[:k])
        sync()
        out[k] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _detector_frame_rows(campaign, mask):
    """(m1_det, q, dL, log pdraw_det) of the campaign rows ``mask`` at Planck18, float64."""
    from bumpcosmology_torch.data.weights import dm1sqz_dm1ddqdl, planck18_dl_np

    m1, q, z = (_col(campaign, k)[mask] for k in ("m1", "q", "z"))
    pdraw = _col(campaign, "pdraw_mqz")[mask]
    return m1 * (1.0 + z), q, planck18_dl_np(z), np.log(pdraw * dm1sqz_dm1ddqdl(m1, q, z))


def selection_log_mu(campaign, family: str, theta: torch.Tensor, threshold: float = 20.0,
                     device=None) -> np.ndarray:
    """log μ(θ), float64 ``(n,)``, at the unconstrained joint-model draws
    ``theta`` ``(n, dim)``: the model's own selection estimator
    ``logsumexp(log dN − log pdraw) − log Ndraw`` over the campaign's
    detected pool (its noiseless SNR above ``threshold``, as the JAX
    package selects it), all draws in one batched evaluation on ``device``."""
    dev = resolve_device(device)
    det = _col(campaign, "SNR") > threshold
    rows = _detector_frame_rows(campaign, det)
    log_ndraw = math.log(float(_n_rows(campaign)))
    proto = COSMO_SBC_SPEC_BUILDERS[family](device=dev)(None)
    build_pop = _family_builder(family)
    with torch.no_grad():
        sites = constrain(proto, theta.to(dev))
        lw = _frame_logwts(build_pop(sites), sites, *rows, dev)
        return (torch.logsumexp(lw, dim=-1) - log_ndraw).cpu().numpy().astype(np.float64)


def selection_mu_samples(campaign, family: str, n_trials: int, generator=None, threshold: float = 20.0,
                         target_nobs: float = 56.0, r_true: float = 2.3, device=None) -> np.ndarray:
    """Per-prior-draw selection estimates μ(θ) for the rate check
    (``selection_mu_samples``, the JAX package's ``calibration.py:95-171``):
    :func:`selection_log_mu` at ``n_trials`` joint-prior draws, taken as one
    batch (the JAX package maps over them one by one), rescaled so that the
    median expected count ``r_true * mu`` is ``target_nobs``."""
    dev = resolve_device(device)
    proto = COSMO_SBC_SPEC_BUILDERS[family](device=dev)(None)
    thetas = prior_sample(proto, _generator(generator, dev), shape=(n_trials,))
    log_mus = selection_log_mu(campaign, family, thetas, threshold, device=dev)
    return np.exp(log_mus - np.median(log_mus)) * (target_nobs / r_true)


def make_mock_pop_simulator(
    detected_obs,
    n_total_injections: int,
    nobs: int = 16,
    nsamp: int = 64,
    nsel: int = 512,
    pe_bank_size: int = 2048,
    seed: int = 0,
    device=None,
):
    """A per-θ catalog simulator for the population-only model from one mock
    campaign's detected injections (``detected_obs``, the table
    :func:`~bumpcosmology_torch.mock.add_observation_noise` returns).

    A fiducial-population PE bank per injection is drawn once; each call
    draws ``nobs`` events ∝ pop_θ / pdraw (the intensity on ``device``) and
    takes their banks.  The selection set is θ-independent.
    """
    from bumpcosmology_torch.data.weights import default_pop_wt, planck18_dvc_dz_np
    from bumpcosmology_torch.mock.catalog import draw_mock_pe_samples

    dev = resolve_device(device)
    rng0 = np.random.default_rng(seed)
    n_obs = _n_rows(detected_obs)

    # θ-independent selection set (uniform thinning: Ndraw scales with it)
    if nsel > n_obs:
        print(
            f"[sbc] WARNING: requested nsel={nsel} exceeds the detected pool "
            f"({n_obs}); clamping — selection-MC noise will be higher than "
            "configured (grow the campaign to actually get nsel injections)"
        )
    nsel = min(nsel, n_obs)
    sel_idx = rng0.choice(n_obs, size=nsel, replace=False)
    inj_m1, inj_q, inj_z, inj_pdraw = (_col(detected_obs, k) for k in ("m1", "q", "z", "pdraw_mqz"))
    sel_arrays = (inj_m1[sel_idx], inj_q[sel_idx], inj_z[sel_idx], inj_pdraw[sel_idx],
                  float(n_total_injections) * (nsel / n_obs))

    # PE banks: samples from (measurement likelihood x fiducial pop), with
    # pdraw = fiducial pop weight — a valid proposal for any θ
    pe_cols = ("log_mc_obs", "sigma_log_mc", "q_obs", "sigma_q", "log_dl_obs", "sigma_log_dl")
    pe = [_col(detected_obs, k).astype(np.float64) for k in pe_cols]
    banks = []
    for i in range(n_obs):
        m, q, z, w = draw_mock_pe_samples(*(c[i] for c in pe), size=pe_bank_size, output_source_frame=True,
                                          rng=rng0)
        pw = default_pop_wt(m, q, z, device=dev)
        rw = pw / w
        total = np.sum(rw)
        if total <= 0:
            banks.append(None)
            continue
        pick = rng0.choice(pe_bank_size, size=nsamp, p=rw / total)
        banks.append((m[pick], q[pick], z[pick], pw[pick]))
    valid = np.array([b is not None for b in banks])
    inj_m1_t, inj_q_t, inj_z_t = (torch.as_tensor(x.astype(np.float32), device=dev)[None]
                                  for x in (inj_m1, inj_q, inj_z))

    def simulate(rng: np.random.Generator, sites) -> PopData:
        with torch.no_grad():
            pop = build_population(population_from_sites(_site_tensors(sites, dev)))
            log_dn = log_dndmdqdv(pop, inj_m1_t, inj_q_t, inj_z_t)[0].cpu().numpy().astype(np.float64)
        wt = np.where(valid, np.exp(log_dn) / inj_pdraw, 0.0)
        # comoving-volume measure; detection probability is membership in the pool
        wt = wt * planck18_dvc_dz_np(inj_z) / (1.0 + inj_z)
        total = wt.sum()
        if not np.isfinite(total) or total <= 0:
            wt = valid.astype(float)
            total = wt.sum()
        picks = rng.choice(n_obs, size=nobs, replace=True, p=wt / total)
        stacks = [np.stack([banks[i][j] for i in picks]) for j in range(4)]
        return make_pop_data(*stacks, *sel_arrays, device=dev)

    return simulate


def make_mock_pop_cosmo_simulator(
    detected_obs,
    n_total_injections: int,
    nobs: int = 16,
    nsamp: int = 64,
    nsel: int = 2048,
    pe_bank_size: int = 4096,
    seed: int = 0,
    device=None,
):
    """Detector-frame catalog simulator for the joint (pop + cosmology) model
    with one shared noise realization.

    Detector-frame observables (m1_det, q, dL) do not depend on cosmology, so
    the PE banks and the selection set are θ-independent; each prior draw
    re-weights which injections enter the catalog, through the intensity ×
    frame Jacobian at the injections' detector-frame coordinates on
    ``device``.  Banks are importance-resampled from the Gaussian law to the
    fiducial detector-frame weight, which is stored as ``pdraw``; a bank whose
    retarget weights have an effective size below ``2 nsamp`` is rejected.
    """
    from bumpcosmology_torch.data.weights import (
        default_pop_wt,
        dm1sqz_dm1ddqdl,
        planck18_dl_np,
        planck18_z_of_dl_np,
    )
    from bumpcosmology_torch.mock.catalog import draw_mock_pe_samples

    dev = resolve_device(device)
    rng0 = np.random.default_rng(seed)
    n_ev = _n_rows(detected_obs)

    # detector-frame injection coordinates + pdraw, frame-converted once under Planck18
    inj_z, inj_m1, inj_q = (_col(detected_obs, k) for k in ("z", "m1", "q"))
    inj_m1d = inj_m1 * (1.0 + inj_z)
    inj_dl = planck18_dl_np(inj_z)
    inj_pdraw_det = _col(detected_obs, "pdraw_mqz") * dm1sqz_dm1ddqdl(inj_m1, inj_q, inj_z)

    nsel = min(nsel, n_ev)
    sel_idx = rng0.choice(n_ev, size=nsel, replace=False)
    sel_arrays = (inj_m1d[sel_idx], inj_q[sel_idx], inj_dl[sel_idx], inj_pdraw_det[sel_idx],
                  float(n_total_injections) * (nsel / n_ev))

    # every bank in one vectorized pass; the fiducial weight in chunks on the device
    col = lambda k: _col(detected_obs, k)[:, None]  # noqa: E731
    m1d_b, q_b, dl_b, w_b = draw_mock_pe_samples(
        col("log_mc_obs"), col("sigma_log_mc"), col("q_obs"), col("sigma_q"), col("log_dl_obs"),
        col("sigma_log_dl"), size=(n_ev, pe_bank_size), output_source_frame=False, rng=rng0,
    )
    z_b = planck18_z_of_dl_np(dl_b)
    m1_b = m1d_b / (1.0 + z_b)
    p_fid_det = np.empty_like(m1_b)
    chunk = max(1, 4_000_000 // pe_bank_size)
    for lo in range(0, n_ev, chunk):
        sl = slice(lo, lo + chunk)
        p_fid_det[sl] = (default_pop_wt(m1_b[sl], q_b[sl], z_b[sl], device=dev)
                         * dm1sqz_dm1ddqdl(m1_b[sl], q_b[sl], z_b[sl]))
    rw_b = p_fid_det / w_b
    banks = []
    n_low = 0
    for e in range(n_ev):
        total = np.sum(rw_b[e])
        # bank Neff floor (the reference's ingestion rejection)
        neff = total * total / np.sum(rw_b[e] * rw_b[e]) if total > 0 else 0.0
        if not np.isfinite(total) or total <= 0 or neff < 2.0 * nsamp:
            banks.append(None)
            n_low += 1
            continue
        pick = rng0.choice(pe_bank_size, size=nsamp, p=rw_b[e] / total)
        banks.append((m1d_b[e, pick], q_b[e, pick], dl_b[e, pick], p_fid_det[e, pick]))
    if n_low:
        print(f"[sbc] {n_low}/{n_ev} pool injections rejected at the bank-Neff floor")
    valid = np.array([b is not None for b in banks])
    log_pdraw_det = np.log(inj_pdraw_det)

    def simulate(rng: np.random.Generator, sites):
        sites_t = _site_tensors(sites, dev)
        with torch.no_grad():
            pop = build_population(population_from_sites(sites_t))
            logwt = _frame_logwts(pop, sites_t, inj_m1d, inj_q, inj_dl, log_pdraw_det, dev)[0]
            logwt = logwt.cpu().numpy().astype(np.float64)
        logwt = np.where(valid & np.isfinite(logwt), logwt, -np.inf)
        wt = np.exp(logwt - np.max(logwt))
        total = wt.sum()
        if not np.isfinite(total) or total <= 0:
            wt = valid.astype(float)
            total = wt.sum()
        # iid events (with replacement), as the likelihood treats them
        picks = rng.choice(n_ev, size=nobs, replace=True, p=wt / total)
        stacks = [np.stack([banks[i][j] for i in picks]) for j in range(4)]
        return make_pop_cosmo_data(*stacks, *sel_arrays, device=dev)

    return simulate


def make_mock_pop_cosmo_simulator_fresh(
    campaign,
    nobs: int = 16,
    nsamp: int = 64,
    nsel: int = 4096,
    pe_bank_size: int = 4096,
    threshold: float = 20.0,
    obs_sigma: float = None,
    snr_channel: bool = True,
    max_bank_doublings: int = 4,
    family: str = "bump",
    device=None,
):
    """Joint-model simulator with per-simulation fresh noise (the exact SBC law;
    ``make_mock_pop_cosmo_simulator_fresh``, the JAX package's
    ``calibration.py:569-869``).

    Every simulation redraws the observed detection SNRs (so its own
    detected pool), the fixed-size selection subset (which is also the event
    pool, so the selection normalizer is exact for the per-simulation law),
    and the observed data and PE banks of its ``nobs`` events.  With
    ``snr_channel`` each bank sample also carries one fresh projection factor
    Θ and the bank weights the observed-SNR likelihood ``N(snr_obs; A·Θ/dL,
    √3)`` (``A`` from :func:`~bumpcosmology_torch.mock.snr.amplitude_factor`,
    kernel C on ``device``), conditioning the atoms on the full observed
    data.  A bank whose effective size is below ``2 nsamp`` is redrawn twice
    as large (up to ``max_bank_doublings`` times), then from a moment-matched
    proposal with the exact density-ratio correction (up to 8 times).

    ``campaign``: the injection table with its true SNR column; ``family``:
    the intensity family the prior draws parameterize (``"bump"``,
    ``"plpeak"`` or ``"brokenpl"``).
    """
    from bumpcosmology_torch.data.weights import (
        default_pop_wt,
        dm1sqz_dm1ddqdl,
        planck18_dl_np,
        planck18_z_of_dl_np,
    )
    from bumpcosmology_torch.mock.catalog import CHIRP_DIST_MIN, Z_HORIZON, Uncertainties, draw_mock_pe_samples
    from bumpcosmology_torch.mock.snr import amplitude_factor, draw_projection_factors

    dev = resolve_device(device)
    build_pop = _family_builder(family)
    snr = _col(campaign, "SNR")
    m1, q, z = (_col(campaign, k) for k in ("m1", "q", "z"))
    pdraw_src = _col(campaign, "pdraw_mqz")
    n_total = float(len(m1))

    m1d = m1 * (1.0 + z)
    dl = planck18_dl_np(z)
    pdraw_det = pdraw_src * dm1sqz_dm1ddqdl(m1, q, z)
    mc_det = m1d * q**0.6 / (1.0 + q) ** 0.2
    log_mc_det = np.log(mc_det)
    log_dl = np.log(dl)

    # only injections that can plausibly detect matter for the noise draw
    cand = np.flatnonzero(snr > threshold - 6.0 * math.sqrt(3.0))

    def simulate(rng: np.random.Generator, sites):
        # fresh detection realization
        snr_obs = snr[cand] + rng.normal(0.0, math.sqrt(3.0), size=len(cand))
        det = cand[snr_obs > threshold]
        snr_obs = snr_obs[snr_obs > threshold]
        if len(det) < nsel:
            raise ValueError(
                f"only {len(det)} detections at threshold {threshold}; "
                "increase the campaign or lower nsel"
            )
        # fixed-size selection subset == the event pool (exact normalizer)
        pick_sel = rng.choice(len(det), size=nsel, replace=False)
        pool = det[pick_sel]
        pool_snr_obs = snr_obs[pick_sel]
        ndraw_eff = n_total * (nsel / len(det))

        sites_t = _site_tensors(sites, dev)
        with torch.no_grad():
            logwt = _frame_logwts(build_pop(sites_t), sites_t, m1d[pool], q[pool], dl[pool],
                                  np.log(pdraw_det[pool]), dev)[0]
            logwt = logwt.cpu().numpy().astype(np.float64)
        logwt = np.where(np.isfinite(logwt), logwt, -np.inf)
        wt = np.exp(logwt - np.max(logwt))
        events = rng.choice(nsel, size=nobs, replace=True, p=wt / wt.sum())
        ev = pool[events]

        # fresh observed data + PE banks for just these events
        unc = Uncertainties.from_snr(pool_snr_obs[events])
        lmc_obs = rng.normal(log_mc_det[ev], unc.sigma_log_mc)
        q_obs = rng.normal(q[ev], unc.sigma_q)
        ldl_obs = rng.normal(log_dl[ev], unc.sigma_log_dl)
        snr_obs_ev = pool_snr_obs[events]

        def bank_logw(snr_obs_rows, m1d_b, q_b, dl_b, w_b):
            """Log retarget weights of bank draws: Gaussian-law draws → L·p_fid,
            times the observed-SNR likelihood with one fresh Θ a sample when
            ``snr_channel``; the campaign's precut (z < Z_HORIZON, the chirp-
            distance floor) zeroes the predicted SNR, as it zeroes the mock
            world's."""
            z_b = planck18_z_of_dl_np(dl_b)
            m1_b = m1d_b / (1.0 + z_b)
            p_fid = default_pop_wt(m1_b, q_b, z_b, device=dev) * dm1sqz_dm1ddqdl(m1_b, q_b, z_b)
            with np.errstate(divide="ignore"):
                logw = np.log(p_fid) - np.log(w_b)
            if snr_channel:
                theta = draw_projection_factors(rng, m1d_b.shape, device=dev)
                a_fac = amplitude_factor(m1d_b, m1d_b * q_b, device=dev)
                mc_det_b = m1d_b * q_b**0.6 / (1.0 + q_b) ** 0.2
                ok = (z_b < Z_HORIZON) & (mc_det_b ** (5.0 / 6.0) / dl_b > CHIRP_DIST_MIN)
                snr_pred = np.where(ok, a_fac * theta / dl_b, 0.0)
                logw = logw - 0.5 * ((snr_obs_rows[..., None] - snr_pred) ** 2) / 3.0
            return logw, p_fid

        m1d_b, q_b, dl_b, w_b = draw_mock_pe_samples(
            lmc_obs[:, None], unc.sigma_log_mc[:, None],
            q_obs[:, None], unc.sigma_q[:, None],
            ldl_obs[:, None], unc.sigma_log_dl[:, None],
            size=(nobs, pe_bank_size), rng=rng,
        )
        logw_all, p_fid_all = bank_logw(snr_obs_ev, m1d_b, q_b, dl_b, w_b)

        def bank_neff(lw):
            mx = np.max(lw)
            if not np.isfinite(mx):
                return None, 0.0
            w = np.exp(lw - mx)
            tot = w.sum()
            return w, tot * tot / np.sum(w * w)

        def gauss3_logpdf(nb, c_mc, s_mc, c_q, s_q, c_dl, s_dl):
            """Proposal log-density in (log Mc, q, log dL) without the per-event
            constants (the q truncation and -3/2 log 2π cancel in the weights)."""
            m1d_r, q_r, dl_r = nb[0], nb[1], nb[2]
            lmc_r = np.log(m1d_r * q_r**0.6 / (1.0 + q_r) ** 0.2)
            ldl_r = np.log(dl_r)
            return (
                -0.5 * ((lmc_r - c_mc) / s_mc) ** 2 - np.log(s_mc)
                - 0.5 * ((q_r - c_q) / s_q) ** 2 - np.log(s_q)
                - 0.5 * ((ldl_r - c_dl) / s_dl) ** 2 - np.log(s_dl)
            )

        floor = 2.0 * nsamp
        stacks = [np.empty((nobs, nsamp)) for _ in range(4)]
        for e in range(nobs):
            lw = logw_all[e]
            bank = (m1d_b[e], q_b[e], dl_b[e], p_fid_all[e])
            # stage 1: double the bank until its retarget Neff clears the floor
            size, attempts = pe_bank_size, 0
            w, neff = bank_neff(lw)
            while neff < floor and attempts < max_bank_doublings:
                attempts += 1
                size *= 2
                nb = draw_mock_pe_samples(
                    lmc_obs[e], unc.sigma_log_mc[e], q_obs[e], unc.sigma_q[e],
                    ldl_obs[e], unc.sigma_log_dl[e], size=(1, size), rng=rng,
                )
                lw2, pf2 = bank_logw(snr_obs_ev[e: e + 1], *nb)
                lw = lw2[0]
                bank = (nb[0][0], nb[1][0], nb[2][0], pf2[0])
                w, neff = bank_neff(lw)
            # stage 2: a moment-matched, widened proposal with the exact
            # density-ratio correction (the estimated law is unchanged)
            adapt = 0
            while neff < floor and adapt < 8:
                adapt += 1
                if w is not None and w.sum() > 0:
                    wn = w / w.sum()
                    lmc_cur = np.log(bank[0] * bank[1] ** 0.6 / (1.0 + bank[1]) ** 0.2)
                    ldl_cur = np.log(bank[2])
                    coords = (lmc_cur, bank[1], ldl_cur)
                    sig0 = (unc.sigma_log_mc[e], unc.sigma_q[e], unc.sigma_log_dl[e])
                    cs = []
                    for x_cur, s0 in zip(coords, sig0):
                        mu = float(np.sum(wn * x_cur))
                        sd = float(np.sqrt(max(np.sum(wn * (x_cur - mu) ** 2), 0.0)))
                        cs.append((mu, max(1.5 * sd, float(s0))))
                    (c_mc, s_mc), (c_q, s_q), (c_dl, s_dl) = cs
                else:  # no finite weight anywhere: widen around the observation
                    infl = 2.0 ** adapt
                    c_mc, s_mc = lmc_obs[e], unc.sigma_log_mc[e] * infl
                    c_q, s_q = q_obs[e], unc.sigma_q[e] * infl
                    c_dl, s_dl = ldl_obs[e], unc.sigma_log_dl[e] * infl
                size = min(size * 2, 1 << 21)
                nb = draw_mock_pe_samples(c_mc, s_mc, c_q, s_q, c_dl, s_dl, size=(1, size), rng=rng)
                lw2, pf2 = bank_logw(snr_obs_ev[e: e + 1], *nb)
                nb_flat = (nb[0][0], nb[1][0], nb[2][0], pf2[0])
                corr = gauss3_logpdf(
                    nb_flat, lmc_obs[e], unc.sigma_log_mc[e],
                    q_obs[e], unc.sigma_q[e], ldl_obs[e], unc.sigma_log_dl[e],
                ) - gauss3_logpdf(nb_flat, c_mc, s_mc, c_q, s_q, c_dl, s_dl)
                lw_new = lw2[0] + corr
                w_new, neff_new = bank_neff(lw_new)
                if neff_new > neff:
                    lw, bank, w, neff = lw_new, nb_flat, w_new, neff_new
            if w is None:
                print(f"[sbc] WARNING: event {e} bank has no finite weight; uniform fallback")
                w = np.isfinite(bank[3]).astype(float)
            elif neff < floor:
                print(
                    f"[sbc] WARNING: event {e} bank Neff {neff:.0f} < {floor:.0f} "
                    f"after {attempts} doublings + {adapt} adaptive proposals (size {size})"
                )
            pick = rng.choice(len(w), size=nsamp, p=w / w.sum())
            for j in range(4):
                stacks[j][e] = bank[j][pick]

        return make_pop_cosmo_data(*stacks, m1d[pool], q[pool], dl[pool], pdraw_det[pool], ndraw=ndraw_eff,
                                   device=dev)

    return simulate


def make_pop_sbc_spec_builder(n_grid: int = 128, device=None):
    """Spec builder for :func:`run_sbc` over the population-only model
    (``build(None)``: the prior-only prototype)."""
    dev = resolve_device(device)

    def build(data):
        if data is None:
            return ModelSpec(priors=dict(POP_PRIORS), loglike=_zero_loglike, device=dev)
        return pop_model_spec(data, n_grid=n_grid, device=dev)

    return build


def make_pop_cosmo_sbc_spec_builder(n_grid: int = 128, n_z: int = 256, device=None):
    """Spec builder for :func:`run_sbc` over the joint pop + cosmology model."""
    dev = resolve_device(device)

    def build(data):
        if data is None:
            return ModelSpec(priors=dict(POP_COSMO_PRIORS), loglike=_zero_loglike, device=dev)
        return pop_cosmo_model_spec(data, n_grid=n_grid, n_z=n_z, device=dev)

    return build


def _family_cosmo_builder(priors, loglike_fn, n_grid: int, n_z: int, device):
    dev = resolve_device(device)

    def build(data):
        if data is None:
            return ModelSpec(priors=dict(priors), loglike=_zero_loglike, device=dev)
        data = data.to(dev)
        bounds = dl_bounds_of(data, margin=0.1)
        return ModelSpec(priors=dict(priors), loglike=lambda s: loglike_fn(s, data, n_grid, n_z, bounds), device=dev)

    return build


def make_plpeak_cosmo_sbc_spec_builder(n_grid: int = 128, n_z: int = 256, device=None):
    """Spec builder for SBC over the joint POWER-LAW+PEAK model.

    ``mmin`` runs over [5, 10] instead of the fit's [2, 10]: the mock
    campaign draws primaries on m1 ≥ 5, and the PE-bank proposal inherits
    that support, so SBC certifies the mmin ∈ [5, 10] slice.
    """
    from bumpcosmology_torch.inference.distributions import Uniform

    return _family_cosmo_builder({**PLPEAK_COSMO_PRIORS, "mmin": Uniform(5.0, 10.0)}, plpeak_cosmo_loglike,
                                 n_grid, n_z, device)


def make_brokenpl_cosmo_sbc_spec_builder(n_grid: int = 128, n_z: int = 256, device=None):
    """Spec builder for SBC over the joint BROKEN POWER LAW model (the same
    ``mmin`` slice as :func:`make_plpeak_cosmo_sbc_spec_builder`)."""
    from bumpcosmology_torch.inference.distributions import Uniform

    return _family_cosmo_builder({**BROKENPL_COSMO_PRIORS, "mmin": Uniform(5.0, 10.0)}, brokenpl_cosmo_loglike,
                                 n_grid, n_z, device)


# mass family → the joint model's spec builder factory
COSMO_SBC_SPEC_BUILDERS = {"bump": make_pop_cosmo_sbc_spec_builder, "plpeak": make_plpeak_cosmo_sbc_spec_builder,
                           "brokenpl": make_brokenpl_cosmo_sbc_spec_builder}
