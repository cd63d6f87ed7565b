"""The float64 golden check (``bumpcosmology_torch.tools.posterior_check``).

The tool holds the port's float32 joint fit against the committed float64
golden trace ``benchmarks/golden_joint_f64.npz`` with the limits of the JAX
package's ``tests/test_f64_crosscheck.py::test_joint_f32_matches_f64_golden``
(r-hat < 1.05, |z| < 4 with the combined Monte-Carlo standard error, sd
ratio in (0.7, 1.4)).  Here its comparison is held on small synthetic
traces, and the golden file against the model's sites; the fit itself runs
on the card (``slow`` and ``cuda``: about half an hour of a host-bound
NUTS fit), by
``python -m pytest tests/test_torch_posterior.py -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from bumpcosmology_torch.inference.diagnostics import summary
from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS
from bumpcosmology_torch.tools import posterior_check as pc


def _trace(rng, means, sds, chains=2, draws=400):
    return {k: rng.normal(m, s, size=(chains, draws)) for k, m, s in zip(("x", "y", "w"), means, sds)}


def test_compare_passes_draws_of_the_same_posterior():
    rng = np.random.default_rng(0)
    golden = summary(_trace(rng, (0.0, 5.0, -1.0), (1.0, 0.1, 3.0), chains=4, draws=1000))
    rows, worst = pc.compare(summary(_trace(rng, (0.0, 5.0, -1.0), (1.0, 0.1, 3.0))), golden)
    assert worst["ok"] and all(r["ok"] for r in rows)
    assert [r["site"] for r in rows] == ["x", "y", "w"]
    assert worst["z"] < 4.0 and worst["rhat"] < 1.05 and 0.7 < worst["sd_ratio"] < 1.4


@pytest.mark.parametrize("case", ["shifted mean", "narrow", "wide", "unmixed chains"])
def test_compare_flags_each_limit(case):
    """A mean 6 standard errors off, an sd ratio of 0.6 or 1.6, two chains
    stuck apart: each fails its own limit, on its own site."""
    rng = np.random.default_rng(1)
    golden = summary(_trace(rng, (0.0, 5.0, -1.0), (1.0, 0.1, 3.0), chains=4, draws=1000))
    fit = _trace(rng, (0.0, 5.0, -1.0), (1.0, 0.1, 3.0))
    if case == "shifted mean":
        fit["y"] = fit["y"] + 6 * 0.1 * np.sqrt(1 / 800 + 1 / 4000)
    elif case == "narrow":
        fit["y"] = 5.0 + 0.6 * (fit["y"] - 5.0)
    elif case == "wide":
        fit["y"] = 5.0 + 1.6 * (fit["y"] - 5.0)
    else:
        fit["y"] = fit["y"] + np.array([[-0.1], [0.1]])
    rows, worst = pc.compare(summary(fit), golden)
    assert not worst["ok"]
    assert [r["site"] for r in rows if not r["ok"]] == ["y"]
    y = next(r for r in rows if r["site"] == "y")
    if case == "shifted mean":
        assert y["z"] > 4.0 and worst["z"] == y["z"]
    elif case in ("narrow", "wide"):
        assert not 0.7 < y["sd_ratio"] < 1.4 and worst["sd_ratio"] == y["sd_ratio"]
    else:
        assert y["rhat"] >= 1.05 and worst["rhat"] == y["rhat"]


def test_compare_refuses_other_sites():
    rng = np.random.default_rng(2)
    golden = summary(_trace(rng, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    fit = summary({"x": rng.normal(size=(2, 100))})
    with pytest.raises(ValueError, match="sites differ"):
        pc.compare(fit, golden)


def test_golden_trace_holds_every_site_of_the_joint_model():
    """The golden file's draws are the joint model's 15 sites, (4, 1000) each,
    finite, at the grids and catalog the tool rebuilds."""
    cfg, post = pc.load_golden()
    assert sorted(post) == sorted(POP_COSMO_PRIORS)
    assert all(v.shape == (4, 1000) and np.isfinite(v).all() for v in post.values())
    assert (cfg["n_grid"], cfg["n_z"], cfg["nobs"], cfg["nsamp"], cfg["nsel"]) == (256, 1024, 56, 128, 1024)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.slow
@pytest.mark.cuda
def test_float32_fit_on_the_card_matches_the_float64_golden(dev):
    """The tool at its defaults (2 chains, 500 warmup steps, 400 draws) on the card."""
    assert pc.main(["--device", "cuda"]) == 0
