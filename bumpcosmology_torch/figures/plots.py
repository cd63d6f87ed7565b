"""The eight reference figures and five more (L5); counterpart of the JAX
package's ``figures/plots.py``.

One function per reference figure script (``dNdm_fitted.py``,
``cosmo_params_corner.py``, ``h_zoomin.py``, ``omh2_zoomin.py``,
``shape_corner.py``, ``m1-vs-m2.py``, ``dNdm_PISN_effects.py``,
``mock_observation_corner.py``), and the five figures of the diagnostics
stages, reading the port's ``.npz`` artifacts (keyed by the JAX package's
HDF5 paths).  Each function takes explicit input and output paths and
returns the output path.

Matplotlib, seaborn and pandas are imported by the functions that draw
(the card's host may lack them, and importing a port module must not need
them): the arrays of each figure are computed by a private helper first,
which tests and the card can call without a plotting library.  The bump
curves of :func:`dndm_pisn_effects` are built on ``device`` (kernel A on
the card).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from bumpcosmology_torch.models.population import COORDS
from bumpcosmology_torch.utils.io import read_table
from bumpcosmology_torch.utils.trace import load_trace

__all__ = [
    "FIGURES",
    "EXTRA_FIGURES",
    "render_all",
    "dndm_fitted",
    "cosmo_params_corner",
    "h_zoomin",
    "omh2_zoomin",
    "shape_corner",
    "m1_vs_m2",
    "dndm_pisn_effects",
    "mock_observation_corner",
    "sbc_ranks_hist",
    "event_influence",
    "model_compare_fig",
    "prior_sens_fig",
    "ppc_fig",
]

PLOTTING_LIBRARIES = ("matplotlib", "seaborn", "pandas")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(out):
    plt = _plt()
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    plt.tight_layout()
    plt.savefig(out)
    plt.close("all")
    return out


def _corner(columns: dict):
    import pandas as pd
    import seaborn as sns

    pg = sns.PairGrid(pd.DataFrame(columns), diag_sharey=False)
    pg.map_diag(sns.kdeplot)
    pg.map_lower(sns.kdeplot)
    pg.map_upper(sns.scatterplot, s=4, alpha=0.4)
    return pg


def _npz(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


# ------------------------------------------------------- the reference figures


def _dndm_bands(trace_path):
    """m·dN/dm at (q=1, z=0) over ``COORDS["m_grid"]`` of the trace and of
    the other families' traces beside it: ``(x, family, (med, q16, q84,
    q025, q975), [(family, (med, q16, q84)), ...])``."""
    tr = load_trace(trace_path)
    dn = tr.posterior["mdNdmdVdt_fixed_qz"].reshape(-1, 128)
    q16, q84 = np.quantile(dn, [0.16, 0.84], axis=0)
    q025, q975 = np.quantile(dn, [0.025, 0.975], axis=0)
    siblings = []
    for fam in ("plpeak", "brokenpl"):
        sibling = Path(trace_path).with_name(f"trace_{fam}.npz")
        if sibling.exists() and str(sibling) != str(trace_path):
            dn2 = load_trace(sibling).posterior["mdNdmdVdt_fixed_qz"].reshape(-1, 128)
            p16, p84 = np.quantile(dn2, [0.16, 0.84], axis=0)
            siblings.append((fam, (np.median(dn2, axis=0), p16, p84)))
    return (COORDS["m_grid"], str(tr.attrs.get("family", "bump")), (np.median(dn, axis=0), q16, q84, q025, q975),
            siblings)


def dndm_fitted(trace_path, out="figures/dNdm_fitted.pdf"):
    """Posterior-predictive band of m·dN/dm at (q=1, z=0) (``dNdm_fitted.py``),
    with the bands of the other families' fits of the same catalog
    (``trace_plpeak.npz`` / ``trace_brokenpl.npz`` beside ``trace_path``)."""
    import seaborn as sns

    plt = _plt()
    sns.set_palette("colorblind")
    x, family, (med, q16, q84, q025, q975), siblings = _dndm_bands(trace_path)
    plt.figure()
    (line,) = plt.plot(x[1:], med[1:], label=family)
    plt.fill_between(x[1:], q84[1:], q16[1:], color=line.get_color(), alpha=0.25)
    plt.fill_between(x[1:], q975[1:], q025[1:], color=line.get_color(), alpha=0.25)
    for (fam, (med2, p16, p84)), style in zip(siblings, ("--", ":")):
        (l2,) = plt.plot(x[1:], med2[1:], ls=style, label=fam)
        plt.fill_between(x[1:], p84[1:], p16[1:], color=l2.get_color(), alpha=0.18)
    if siblings:
        plt.legend(fontsize=8)
    plt.xlabel(r"$m_1 / M_\odot$")
    plt.ylabel(
        r"$\left. m_1 \mathrm{d}N/\mathrm{d}m_1 \mathrm{d}q \mathrm{d}V \mathrm{d}t"
        r" \right|_{q=1,z=0} / \mathrm{Gpc}^{-3}\,\mathrm{yr}^{-1}$"
    )
    plt.xscale("log")
    plt.yscale("log")
    return _finish(out)


def _corner_of(trace_path, labels: dict):
    tr = load_trace(trace_path)
    return _corner({lab: tr.posterior[k].reshape(-1) for k, lab in labels.items()})


def cosmo_params_corner(trace_path, out="figures/cosmo_params_corner.pdf"):
    """(h, Om, w, mpisn, mbhmax, sigma) corner from the joint fit."""
    _corner_of(trace_path, {"h": r"$h$", "Om": r"$\Omega_M$", "w": r"$w$", "mpisn": r"$m_\mathrm{PISN}$",
                            "mbhmax": r"$m_\mathrm{BH,max}$", "sigma": r"$\sigma$"})
    return _finish(out)


def _h_prior(x: np.ndarray) -> np.ndarray:
    """The truncated-normal prior density of h on [0.35, 1.4]."""
    import scipy.stats as ss

    d = ss.norm(loc=0.7, scale=0.2)
    return d.pdf(x) / (d.cdf(1.4) - d.cdf(0.35))


def h_zoomin(trace_path, out="figures/h_zoomin.pdf"):
    """Posterior against the truncated-normal prior for h (``h_zoomin.py``)."""
    import seaborn as sns

    plt = _plt()
    sns.set_palette("colorblind")
    tr = load_trace(trace_path)
    plt.figure()
    sns.kdeplot(tr.posterior["h"].reshape(-1), label="Posterior")
    x = np.linspace(0.35, 1.4, 1024)
    plt.plot(x, _h_prior(x), color="k", label="Prior")
    plt.xlim(0.35, 1.4)
    plt.xlabel(r"$h$")
    plt.legend()
    return _finish(out)


def _omh2_draws(trace_path, seed: int = 194658662):
    """(posterior, prior) draws of ω_M = Ω_M h²: the prior's by rejection,
    as the reference does (``omh2_zoomin.py:18-29``)."""
    rng = np.random.default_rng(seed)
    tr = load_trace(trace_path)
    post = (tr.posterior["Om"] * tr.posterior["h"] ** 2).reshape(-1)
    h = rng.normal(0.7, 0.2, size=40000)
    om = rng.normal(0.3, 0.15, size=40000)
    ok = (h >= 0.35) & (h <= 1.4) & (om >= 0) & (om <= 1)
    return post, (om[ok] * h[ok] ** 2)[:4000]


def omh2_zoomin(trace_path, out="figures/omh2_zoomin.pdf", seed=194658662):
    """Posterior against prior for ω_M = Ω_M h² (``omh2_zoomin.py``)."""
    import seaborn as sns

    plt = _plt()
    sns.set_palette("colorblind")
    post, prior = _omh2_draws(trace_path, seed)
    plt.figure()
    sns.kdeplot(post, label="Posterior")
    sns.kdeplot(prior, label="Prior", color="k")
    plt.xlim(0, 0.5)
    plt.xlabel(r"$\omega_M \equiv \Omega_M h^2$")
    plt.legend()
    return _finish(out)


def shape_corner(trace_path, out="figures/shape_corner.pdf"):
    """(mpisn, mbhmax, sigma) corner from the population fit."""
    _corner_of(trace_path, {"mpisn": r"$m_\mathrm{PISN}$", "mbhmax": r"$m_\mathrm{BH,max}$", "sigma": r"$\sigma$"})
    return _finish(out)


def _events(table: dict):
    """``[(evt, rows of that event), ...]`` in sorted event order (pandas' ``groupby``)."""
    labels, inverse = np.unique(table["evt"], return_inverse=True)
    return [(evt, {k: v[inverse == i] for k, v in table.items()}) for i, evt in enumerate(labels)]


def m1_vs_m2(pe_samples_path, out="figures/m1-vs-m2.pdf"):
    """Per-event m1-m2 KDE contours of the PE catalog (``m1-vs-m2.py``)."""
    import seaborn as sns

    plt = _plt()
    events = _events(read_table(pe_samples_path))
    plt.figure()
    with sns.color_palette("husl", n_colors=max(len(events), 1)):
        for _, s in events:
            sns.kdeplot(x=s["m1"], y=s["m1"] * s["q"], levels=[0.1, 0.5], alpha=0.25)
    plt.xlabel(r"$m_1 / M_\odot$")
    plt.ylabel(r"$m_2 / M_\odot$")
    plt.xscale("log")
    plt.yscale("log")
    plt.xlim(5)
    plt.ylim(5)
    return _finish(out)


_PISN_LABELS = ("Default", "Mass + 10%", r"$\sigma - 1$", r"$m_\mathrm{PISN} + 10\%$", r"$m_\mathrm{BH,max} + 10\%$")


def _pisn_curves(device=None):
    """``(m, {label: p(m)})``: the bump's mass density on 1,024 masses in [5,
    45] at the default parameters and four changes of them, normalised by
    the trapezoid rule.  The five bump tables are one kernel-A launch on the
    card (``device=None`` means CUDA; ``"cpu"`` takes its plain twin)."""
    import torch

    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.models.mass import pisn_bump_log_dndm_grid
    from bumpcosmology_torch.models.parameters import DEFAULT_MASS
    from bumpcosmology_torch.ops.interp import interp_unit_spaced

    dev = resolve_device(device)
    p = DEFAULT_MASS
    changes = ({}, dict(mpisn=p.mpisn * 1.1, mbhmax=p.mbhmax * 1.1), dict(sigma=p.sigma - 1),
               dict(mpisn=p.mpisn * 1.1), dict(mbhmax=p.mbhmax * 1.1))
    rows = [p._replace(**kw) for kw in changes]
    params = type(p)(*(torch.tensor([getattr(r, f) for r in rows], dtype=torch.float32, device=dev)
                       for f in p._fields))
    m = np.linspace(5.0, 45.0, 1024)
    lo, dm, log_dn = pisn_bump_log_dndm_grid(params)
    mt = torch.as_tensor(m, dtype=torch.float32, device=dev).expand(len(rows), -1)
    vals = np.exp(interp_unit_spaced(mt, lo, dm[:, None], log_dn).cpu().numpy())
    return m, {label: v / np.trapezoid(v, m) for label, v in zip(_PISN_LABELS, vals)}


def dndm_pisn_effects(out="figures/dNdm_PISN_effects.pdf", device=None):
    """Sensitivity of the PISN bump's shape to its parameters
    (``dNdm_PISN_effects.py``); the curves are built on ``device``
    (``None`` means CUDA: kernel A; ``"cpu"`` its plain twin)."""
    import seaborn as sns

    plt = _plt()
    m, curves = _pisn_curves(device)
    plt.figure()
    with sns.color_palette("husl", n_colors=5):
        for label, pdf in curves.items():
            plt.plot(m, pdf, label=label)
    plt.legend()
    plt.xlabel(r"$m / M_\odot$")
    plt.ylabel(r"$p(m)$")
    return _finish(out)


def _mock_event(observations_path, seed: int = 278954249):
    """One random event of the mock observations: its 1,000 mock PE samples
    ``(m1_det, q, dL)`` and its true values."""
    from bumpcosmology_torch.data.weights import planck18_dl_np
    from bumpcosmology_torch.mock.catalog import draw_mock_pe_samples

    rng = np.random.default_rng(seed)
    obs = read_table(observations_path, key="observations")
    i = int(rng.integers(len(obs["m1"])))
    row = {k: v[i] for k, v in obs.items()}
    m1d, q, dl, _ = draw_mock_pe_samples(
        row["log_mc_obs"], row["sigma_log_mc"], row["q_obs"], row["sigma_q"],
        row["log_dl_obs"], row["sigma_log_dl"], size=1000, rng=rng,
    )
    truths = [row["m1"] * (1 + row["z"]), row["q"], float(planck18_dl_np(row["z"]))]
    return (m1d, q, dl), truths


def mock_observation_corner(observations_path, out="figures/mock_observation_corner.pdf", seed=278954249):
    """Mock PE corner for one random event with truth lines (``mock_observation_corner.py``)."""
    import seaborn as sns

    sns.set_palette("colorblind")
    (m1d, q, dl), truths = _mock_event(observations_path, seed)
    pg = _corner({r"$m_{1,\mathrm{det}}$": m1d, r"$q$": q, r"$d_L/\mathrm{Gpc}$": dl})
    for j in range(3):
        for i in range(3):
            pg.axes[i, j].axvline(truths[j], color="k")
            if i != j:
                pg.axes[i, j].axhline(truths[i], color="k")
    return _finish(out)


# ---------------------------------------------- the diagnostics stages' figures


def _groups(d: dict) -> list:
    """The top-level groups of an artifact's keys, in sorted order (as HDF5 lists them)."""
    return sorted({k.split("/")[0] for k in d if "/" in k and not k.startswith("attrs/")})


def sbc_ranks_hist(ranks_path, out="figures/sbc_ranks.pdf"):
    """SBC rank histograms per site with a 99% uniform band (Talts et al. 2018)."""
    import scipy.stats as ss

    plt = _plt()
    d = _npz(ranks_path)
    model = str(d.get("attrs/model", "pop"))
    n_bins_total = int(d["ranks/n_bins"])
    ranks = {k[len("ranks/"):]: v for k, v in d.items() if k.startswith("ranks/") and k != "ranks/n_bins"}
    pvals = {k[len("pvalues/attrs/"):]: float(v) for k, v in d.items() if k.startswith("pvalues/attrs/")}

    sites = sorted(ranks)
    ncol = 4
    nrow = (len(sites) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.2 * nrow), squeeze=False)
    for ax in axes.flat[len(sites):]:
        ax.set_axis_off()
    n = 0
    for ax, site in zip(axes.flat, sites):
        r = ranks[site]
        n = len(r)
        k = max(2, min(10, n // 5))
        ax.hist(r, bins=np.linspace(0, n_bins_total, k + 1), color="C0", alpha=0.8)
        # pointwise 99% band for a uniform multinomial
        lo, hi = ss.binom.ppf([0.005, 0.995], n, 1.0 / k)
        ax.axhspan(lo, hi, color="k", alpha=0.12, lw=0)
        ax.axhline(n / k, color="k", lw=0.8, ls="--")
        p = pvals.get(site)
        ax.set_title(site if p is None else f"{site}  (p={p:.2f})", fontsize=9)
        ax.set_xlim(0, n_bins_total)
    fig.suptitle(f"SBC rank histograms — {model} model ({n} simulations)")
    return _finish(out)


def event_influence(influence_path, out="figures/event_influence.pdf", top_sites=12):
    """Per-event leave-one-out influence heatmap (sites x events, in
    full-posterior-sd units) from the ``loo`` stage's artifact."""
    plt = _plt()
    d = _npz(influence_path)
    model = str(d.get("attrs/model", "?"))
    events = [str(e) for e in d["event"]]
    z = {g: d[f"{g}/z"] for g in _groups(d) if f"{g}/z" in d}

    sites = sorted(z, key=lambda s: -np.max(np.abs(z[s])))[:top_sites]
    mat = np.stack([z[s] for s in sites])
    lim = max(1.0, float(np.max(np.abs(mat))))
    fig, ax = plt.subplots(figsize=(max(6.0, 0.28 * len(events) + 2.0), 0.4 * len(sites) + 1.6))
    im = ax.imshow(mat, aspect="auto", cmap="RdBu_r", vmin=-lim, vmax=lim)
    ax.set_yticks(range(len(sites)))
    ax.set_yticklabels(sites, fontsize=8)
    step = max(1, len(events) // 28)
    ax.set_xticks(range(0, len(events), step))
    ax.set_xticklabels([events[i] for i in range(0, len(events), step)], rotation=90, fontsize=6)
    ax.set_xlabel("event removed")
    fig.colorbar(im, ax=ax, label=r"$\Delta$ posterior mean / full sd")
    ax.set_title(f"Leave-one-out event influence — {model} model", fontsize=10)
    return _finish(out)


def model_compare_fig(compare_path, out="figures/model_compare.pdf"):
    """Per-event elpd difference (pop_cosmo − pop) and PSIS Pareto k̂ from the
    ``compare`` stage's artifact (k̂ > 0.7: unreliable importance ratios)."""
    plt = _plt()
    d = _npz(compare_path)
    events = [str(e) for e in d["event"]]
    elpd = {m: d[f"{m}/elpd_i"] for m in ("pop", "pop_cosmo")}
    khat = {m: d[f"{m}/khat"] for m in ("pop", "pop_cosmo")}
    best = str(d.get("attrs/best_model", "?"))
    bf_note = ""
    if all(f"{m}/attrs/log_z" in d for m in ("pop", "pop_cosmo")):
        d_logz = float(d["pop_cosmo/attrs/log_z"] - d["pop/attrs/log_z"])
        bf_note = f"; $\\log_{{10}}$BF(pop_cosmo/pop) = {d_logz / np.log(10.0):.1f}"

    n = len(events)
    x = np.arange(n)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(max(6.0, 0.28 * n + 2.0), 5.4), sharex=True,
                                   gridspec_kw={"height_ratios": [3, 2]})
    diff = elpd["pop_cosmo"] - elpd["pop"]
    ax1.bar(x, diff, color=np.where(diff >= 0, "C0", "C3"))
    ax1.axhline(0.0, color="k", lw=0.8)
    ax1.set_ylabel(r"$\Delta$elpd$_i$ (pop_cosmo $-$ pop)")
    ax1.set_title(f"Predictive comparison (PSIS-LOO) — preferred: {best}{bf_note}", fontsize=10)
    for m, c in (("pop", "C1"), ("pop_cosmo", "C0")):
        ax2.plot(x, khat[m], ".", color=c, label=m)
    ax2.axhline(0.7, color="r", ls="--", lw=0.8, label=r"$\hat k = 0.7$")
    ax2.set_ylabel(r"Pareto $\hat k$")
    step = max(1, n // 28)
    ax2.set_xticks(x[::step])
    ax2.set_xticklabels([events[i] for i in range(0, n, step)], rotation=90, fontsize=6)
    ax2.legend(fontsize=7, loc="upper left")
    return _finish(out)


def prior_sens_fig(sens_path, out="figures/prior_sensitivity.pdf"):
    """Heatmap of posterior-mean shifts (in posterior sds) under the prior
    perturbation battery, one panel per trace, from the ``prior_sens``
    stage's artifact; rows whose reweighting ESS fraction is below 0.05 are hatched."""
    plt = _plt()
    d = _npz(sens_path)
    models = _groups(d)
    data = {m: ([str(p) for p in d[f"{m}/perturbation"]], [str(s) for s in d[f"{m}/site"]],
                d[f"{m}/shift_sd"], d[f"{m}/ess_frac"]) for m in models}

    fig, axes = plt.subplots(len(models), 1, squeeze=False,
                             figsize=(7.5, 0.22 * sum(len(v[0]) for v in data.values()) + 1.6 * len(models)))
    for ax, m in zip(axes[:, 0], models):
        perts, sites, shift, ess = data[m]
        vmax = max(0.5, np.nanmax(np.abs(shift)))
        im = ax.imshow(shift, cmap="RdBu_r", vmin=-vmax, vmax=vmax, aspect="auto")
        for i, e in enumerate(ess):
            if e < 0.05:
                ax.axhspan(i - 0.5, i + 0.5, color="none", hatch="///", ec="0.6", lw=0)
        ax.set_yticks(range(len(perts)))
        ax.set_yticklabels(perts, fontsize=6)
        ax.set_xticks(range(len(sites)))
        ax.set_xticklabels(sites, fontsize=6, rotation=90)
        ax.set_title(f"{m}: posterior-mean shift [posterior sds]", fontsize=9)
        fig.colorbar(im, ax=ax, fraction=0.025)
    return _finish(out)


def ppc_fig(ppc_path, out="figures/ppc.pdf"):
    """Posterior-predictive CDF bands per observable and model, from the
    ``ppc`` stage's artifact: the predicted detected-population CDF (68% band
    over posterior draws) against the observed catalog's ECDF band, with the
    replication-calibrated KS p-value in each panel's title."""
    plt = _plt()
    d = _npz(ppc_path)
    models = _groups(d)
    panels = {}
    for m in models:
        for col in sorted({k.split("/")[1] for k in d if k.startswith(m + "/") and k.endswith("/grid")}):
            g = f"{m}/{col}/"
            panels[(m, col)] = (d[g + "grid"], d[g + "pred_cdf_q"], d[g + "obs_cdf_q"],
                                float(d[g + "attrs/p_value"]), str(d[g + "attrs/label"]))

    cols = sorted({c for (_, c) in panels})
    nrow, ncol = len(models), len(cols)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.1 * ncol, 2.6 * nrow), squeeze=False)
    for i, m in enumerate(models):
        for j, col in enumerate(cols):
            ax = axes[i][j]
            if (m, col) not in panels:
                ax.axis("off")
                continue
            grid, pq, oq, p, label = panels[(m, col)]
            ax.fill_between(grid, pq[0], pq[2], color="C0", alpha=0.3, label="predicted (68%)")
            ax.plot(grid, pq[1], color="C0", lw=1.0)
            ax.fill_between(grid, oq[0], oq[2], color="C3", alpha=0.25, label="observed (68%)")
            ax.plot(grid, oq[1], color="C3", lw=1.0, ls="--")
            ax.set_title(f"{m}: {label}  (p = {p:.2f})", fontsize=8)
            ax.set_ylim(0, 1)
            if j == 0:
                ax.set_ylabel("CDF (detected)")
            if i == 0 and j == 0:
                ax.legend(fontsize=6, loc="lower right")
    return _finish(out)


FIGURES = {
    "dNdm_fitted": (dndm_fitted, "trace.npz"),
    "cosmo_params_corner": (cosmo_params_corner, "trace_cosmo.npz"),
    "h_zoomin": (h_zoomin, "trace_cosmo.npz"),
    "omh2_zoomin": (omh2_zoomin, "trace_cosmo.npz"),
    "shape_corner": (shape_corner, "trace.npz"),
    "m1-vs-m2": (m1_vs_m2, "pe-samples.npz"),
    "dNdm_PISN_effects": (dndm_pisn_effects, None),
    "mock_observation_corner": (mock_observation_corner, "mock_observations.npz"),
}

# the diagnostics stages' figures: drawn when their artifact exists, never required
EXTRA_FIGURES = {
    "sbc_ranks": (sbc_ranks_hist, "sbc_ranks.npz"),
    "event_influence": (event_influence, "influence.npz"),
    "model_compare": (model_compare_fig, "model_compare.npz"),
    "ppc": (ppc_fig, "ppc.npz"),
    "prior_sensitivity": (prior_sens_fig, "prior_sensitivity.npz"),
}


def render_all(cfg, out_dir="figures", skip_missing: bool = True, fmt: str = "pdf", device=None):
    """Draw every figure whose input artifact exists under ``cfg.paths``
    (``render_all``, the JAX package's ``plots.py:461-489``); returns the
    written paths.  With ``skip_missing`` a missing artifact skips its figure;
    ``EXTRA_FIGURES`` are always optional.  ``device`` is where the bump
    curves are built (``None`` means CUDA)."""
    out_dir = Path(out_dir)
    made = []
    for name, (fn, artifact) in FIGURES.items():
        out = out_dir / f"{name}.{fmt}"
        if artifact is None:
            made.append(fn(out=out, device=device))
            continue
        src = Path(cfg.paths.path(artifact))
        if not src.exists():
            if skip_missing:
                print(f"[figures] skipping {name}: missing {src}")
                continue
            raise FileNotFoundError(f"figure {name} needs {src}")
        made.append(fn(src, out=out))
    for name, (fn, artifact) in EXTRA_FIGURES.items():
        src = Path(cfg.paths.path(artifact))
        if src.exists():
            made.append(fn(src, out=out_dir / f"{name}.{fmt}"))
    return made
