"""Leave-one-out event influence (``inference/influence.py``).

* ``make_loo_datas`` equal to the JAX package's, leaf for leaf (both the
  population-only and the joint catalog): member i is the catalog without
  event i, the selection replicated.
* ``influence_summary`` on the same fleet draws and full trace equal to the
  JAX package's at rtol 1e-6 (the JAX test's, ``tests/test_influence.py:87``).
* ``loo_fit`` on a 4-event Gaussian toy (prior N(0, 10²) on μ, y_i ~ N(μ,
  0.5²)): each leave-one-out fit's draws have its analytic posterior's mean
  and variance within Monte-Carlo error (600 draws), as the fleet itself is
  held (``tests/test_torch_fleet.py``).  The start candidates and momenta
  come from a ``torch.Generator`` where the JAX package splits keys, so the
  draws are not compared with the JAX package's one by one.
"""
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import influence as jinf
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_tpu.testing import synthetic_pop_data as j_synthetic_pop_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import influence as inf
from bumpcosmology_torch.inference.distributions import Normal
from bumpcosmology_torch.inference.likelihoods import EventData, PopCosmoData, SelectionData
from bumpcosmology_torch.inference.model import ModelSpec
from bumpcosmology_torch.inference.nuts import NutsConfig


@pytest.mark.parametrize("model", ["pop", "pop_cosmo"])
def test_make_loo_datas_equals_jax(model):
    joint = model == "pop_cosmo"
    jd = (j_synthetic_pop_cosmo_data if joint else j_synthetic_pop_data)(4, 6, 10, seed=2)
    td = (convert.pop_cosmo_data if joint else convert.pop_data)(jd, "cpu")
    ref, got = jinf.make_loo_datas(jd), inf.make_loo_datas(td)
    assert got.events.a.shape == (4, 3, 6) and got.selection.a.shape == (4, 10)
    for part in ("events", "selection"):
        for r, g in zip(getattr(ref, part), getattr(got, part)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for i in range(4):
        np.testing.assert_array_equal(got.events.q[i].numpy(), np.delete(td.events.q.numpy(), i, axis=0))
    with pytest.raises(ValueError):
        inf.make_loo_datas(convert.pop_data(j_synthetic_pop_data(1, 6, 10, seed=2), "cpu"))


def test_influence_summary_equals_jax():
    rng = np.random.default_rng(5)
    post = {"a": rng.normal(2.0, 0.3, (5, 40)), "h": rng.normal(0.7, 0.05, (5, 40)),
            "hz": rng.normal(size=(5, 40, 3))}
    full = {"a": rng.normal(2.1, 0.3, (2, 100)), "h": rng.normal(0.7, 0.05, (2, 100)),
            "hz": rng.normal(size=(2, 100, 3)), "R": rng.normal(size=(2, 100))}
    got = inf.influence_summary(inf.LooResult(post, np.ones((5, 40)), np.ones(5)), full)
    ref = jinf.influence_summary(jinf.LooResult(post, np.ones((5, 40)), np.ones(5)), full)
    assert sorted(got) == sorted(ref) == ["a", "h"]
    for site in ref:
        for k in ("mean_loo", "delta_mean", "z"):
            np.testing.assert_allclose(got[site][k], ref[site][k], rtol=1e-6, atol=1e-8)


Y, SIGMA, TAU = np.array([0.3, -1.1, 2.0, 0.9]), 0.5, 10.0


def _toy():
    """Four events whose samples are their observed values y_i; the selection block is a placeholder."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    ev = EventData(t(Y[:, None]), t(np.ones((4, 1))), t(np.ones((4, 1))), t(np.zeros((4, 1))))
    sel = SelectionData(t([1.0]), t([1.0]), t([1.0]), t([0.0]), t(0.0))
    return PopCosmoData(ev, sel)


def _toy_loglike(sites, d):
    return (-0.5 * ((d.events.a[..., 0] - sites["mu"][:, None]) / SIGMA) ** 2).sum(-1)


def test_loo_fit_recovers_each_leave_one_out_posterior():
    spec = ModelSpec(priors={"mu": Normal(0.0, TAU)}, loglike=None, device=torch.device("cpu"))
    res = inf.loo_fit(spec, _toy_loglike, _toy(), 7, num_warmup=150, num_samples=600, cfg=NutsConfig(max_depth=5),
                      verbose=False, device="cpu")
    assert res.posterior["mu"].shape == (4, 600) and res.accept.shape == (4, 600) and res.eps.shape == (4,)
    prec = 1.0 / TAU**2 + 3.0 / SIGMA**2
    for i in range(4):
        mean = (Y.sum() - Y[i]) / SIGMA**2 / prec
        z = (res.posterior["mu"][i] - mean) * np.sqrt(prec)  # standard normal if the fit is right
        assert abs(z.mean()) < 0.25 and abs(z.var() - 1.0) < 0.3, (i, z.mean(), z.var())
    infl = inf.influence_summary(res, {"mu": res.posterior["mu"].reshape(1, -1)})
    assert infl["mu"]["z"].shape == (4,) and np.isfinite(infl["mu"]["z"]).all()
    assert int(np.argmax(infl["mu"]["z"])) == 1  # dropping the lowest event raises the mean most
