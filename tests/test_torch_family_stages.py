"""The fit stages of the port with the other mass families, against the JAX
package's stages, on the CPU.

``run_pop_fit(mass_family="brokenpl")`` and ``run_pop_cosmo_fit(
mass_family="plpeak")`` run for real on ``device="cpu"`` (2 chains, 20
warmup steps, 8 draws, ``max_depth`` 4, ``n_grid`` 48, ``n_z`` 64) on
source-frame tables read from the data directory.  The JAX stage runs on the
same tables with a ``fit`` that keeps its spec and deterministics and hands
back the port's result, so it writes the port's draws with its own writer.

* The trace is the family's file, with the attrs, coords and sample-stat
  keys of the JAX stage's trace, and its posterior equals the fit's result.
* Its constrained sites equal JAX's ``constrain`` of the draws, and its
  deterministic sites JAX's family deterministics on those sites: rtol 1e-4 /
  atol 1e-5 (``tests/test_torch_pop.py``'s limits).  The deterministics are
  given the trace's own sites, so that a one-ulp difference between the two
  packages' ``constrain`` does not meet a soft wall of 25 nats/Msun.
* The stage fits the family's spec: its sites are the registry's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bumpcosmology_tpu.inference import sampler as jsampler
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES
from bumpcosmology_torch.inference.model import unconstrain
from bumpcosmology_torch.pipeline import config, stages
from bumpcosmology_torch.testing import synthetic_source_tables
from bumpcosmology_torch.utils.io import write_table
from bumpcosmology_torch.utils.trace import load_trace

N_GRID, N_Z = 48, 64
CASES = [("brokenpl", "pop"), ("plpeak", "cosmo")]


def _fit_config(module, data_dir, family):
    return module.PipelineConfig(
        paths=module.PathsConfig(data_dir=str(data_dir)),
        fit=module.FitConfig(num_warmup=20, num_samples=8, num_chains=2, max_depth=4, n_grid=N_GRID, n_z=N_Z,
                             mass_family=family))


@pytest.fixture(scope="module", params=CASES, ids=[f"{f}-{m}" for f, m in CASES])
def stage(request, tmp_path_factory):
    from bumpcosmology_tpu.pipeline import config as jconfig
    from bumpcosmology_tpu.pipeline import stages as jstages
    from bumpcosmology_tpu.utils.trace import load_trace as jload_trace
    from bumpcosmology_torch.inference import sampler

    family, model = request.param
    tmp = tmp_path_factory.mktemp(f"{family}_{model}")
    pe, sel = synthetic_source_tables(seed=1)
    cfg = _fit_config(config, tmp / "port", family)
    write_table(cfg.paths.path("pe-samples.npz"), pe)
    write_table(cfg.paths.path("selection-samples.npz"), sel)
    port, jax_seen = {}, {}
    real_fit = sampler.fit

    def kept_fit(spec, seed, deterministics_fn=None, **kw):
        port.update(spec=spec, seed=seed)
        return real_fit(spec, seed, deterministics_fn=deterministics_fn, **kw)

    def stub_fit(spec, key, deterministics_fn=None, **kw):
        jax_seen.update(spec=spec, det_fn=deterministics_fn, kw=kw)
        return jsampler.FitResult(port["res"].posterior, port["res"].sample_stats, None, None, {})

    run, jrun = ((stages.run_pop_fit, jstages.run_pop_fit) if model == "pop"
                 else (stages.run_pop_cosmo_fit, jstages.run_pop_cosmo_fit))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampler, "fit", kept_fit)
        mp.setattr(jsampler, "fit", stub_fit)
        port["res"] = run(cfg, device="cpu")
        jrun(_fit_config(jconfig, tmp / "jax", family), pd.DataFrame(pe), pd.DataFrame(sel),
             trace_out=str(tmp / "ref.h5"))
    fam = MASS_FAMILIES[family]
    name = fam.trace_name if model == "pop" else fam.cosmo_trace_name
    return dict(family=family, model=model, port=port, jax=jax_seen, name=name, dir=tmp / "port",
                trace=load_trace(tmp / "port" / name), ref=jload_trace(str(tmp / "ref.h5")))


def test_stage_writes_the_family_trace(stage):
    res, trace, ref = stage["port"]["res"], stage["trace"], stage["ref"]
    family, model = stage["family"], stage["model"]
    assert stage["name"] == {"pop": f"trace_{family}.npz", "cosmo": f"trace_cosmo_{family}.npz"}[model]
    assert sorted(p.name for p in stage["dir"].iterdir()) == sorted(
        ["pe-samples.npz", "selection-samples.npz", stage["name"]])
    for k, v in res.posterior.items():
        np.testing.assert_array_equal(trace.posterior[k], v)
    assert all(np.isfinite(v).all() for v in trace.posterior.values())
    assert trace.posterior["R"].shape == (2, 8) and trace.posterior["neff"].shape == (2, 8, 8)
    attrs = {"model": "pop" if model == "pop" else "pop_cosmo", "family": family}
    assert trace.attrs == ref.attrs == attrs
    assert sorted(trace.coords) == sorted(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(trace.coords[k], ref.coords[k])
    assert sorted(trace.sample_stats) == sorted(ref.sample_stats)
    seen = {k: stage["jax"]["kw"][k] for k in ("num_warmup", "num_samples", "num_chains")}
    assert seen == {"num_warmup": 20, "num_samples": 8, "num_chains": 2}
    seed = config.FitConfig().seed if model == "pop" else config.FitConfig().cosmo_seed
    assert stage["port"]["seed"] == seed


def test_stage_fits_the_family_spec(stage):
    fam = MASS_FAMILIES[stage["family"]]
    priors = fam.pop_priors if stage["model"] == "pop" else fam.cosmo_priors
    assert list(stage["port"]["spec"].priors) == list(priors) == list(stage["jax"]["spec"].priors)
    assert "mbhmax" not in stage["trace"].posterior and ("hz" in stage["trace"].posterior) == (
        stage["model"] == "cosmo")


def test_trace_is_reproduced_by_jax(stage):
    """The sites through JAX's ``constrain`` of the draws, the deterministics
    through JAX's family deterministics of the trace's sites."""
    trace, js = stage["trace"], stage["jax"]["spec"]
    priors = list(js.priors)
    post = trace.posterior
    theta = unconstrain(stage["port"]["spec"], {k: torch.as_tensor(post[k]) for k in priors}).numpy()
    again = {k: np.asarray(v) for k, v in jconstrain(js, jnp.asarray(theta)).items()}
    sites = {k: jnp.asarray(post[k].reshape(-1)) for k in priors}
    dets = jax.jit(jax.vmap(stage["jax"]["det_fn"]))(sites)
    again.update({k: np.asarray(v).reshape((2, 8) + v.shape[1:]) for k, v in dets.items()})
    assert set(post) == set(again)
    for k, r in again.items():
        assert post[k].shape == r.shape, k
        np.testing.assert_allclose(post[k], r, rtol=1e-4, atol=1e-5, err_msg=k)
