"""A configuration names the port's mass family (``family``, a key of
``likelihoods.MASS_FAMILIES``; ``bump`` where absent), and the harness builds
that family's joint spec.  On the CPU, at the tiny size of ``tiny_bench``."""
import hashlib
import json

import pytest
import torch

from cardbench import harness
from conftest import CELL


def tiny_config(tiny_bench, **changes):
    manifest, bench = tiny_bench
    _, entry = harness.cell_of(manifest, CELL)
    config = harness.load_config(entry, bench)
    config.update(changes)
    return config, harness.load_traffic("nuts", bench), bench


@pytest.mark.parametrize("family", [None, "bump"])
def test_the_bump_is_built_as_before(tiny_bench, family):
    """Without ``family``, and with ``bump``, the spec is
    ``pop_cosmo_model_spec``'s, with the same arguments: the same priors in
    order, and the same log-likelihood bit for bit at seeded sites."""
    from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS, pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import constrain, prior_sample

    config, traffic, bench = tiny_config(tiny_bench)
    config.pop("family", None)
    if family is not None:
        config["family"] = family
    cell = harness.Cell(config, traffic, "cpu", bench)
    assert cell.family == "bump" and cell.shapes()["family"] == "bump"
    assert list(cell.spec.priors.items()) == list(POP_COSMO_PRIORS.items())
    before = pop_cosmo_model_spec(harness.program_data(cell.raw, "cpu"), n_grid=config["n_grid"],
                                  n_z=config["n_z"], device="cpu")
    sites = constrain(before, prior_sample(before, torch.Generator().manual_seed(19), (6,)))
    ll = cell.spec.loglike(sites)
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, before.loglike(sites))


def adapted_state(family, config, bench, path):
    """The port's own warmup of ``family``'s joint model on the cell's cut
    catalog, saved to ``path``: the configuration's ``warmup_state``."""
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.utils.checkpoint import save_warmup

    raw = harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog", bench)),
                              config["events"], config["pe_samples"], config["injections"])
    spec = MASS_FAMILIES[family].cosmo_spec(harness.program_data(raw, "cpu"), n_grid=config["n_grid"],
                                            n_z=config["n_z"], device="cpu")
    res = fit(spec, seed=7, num_warmup=30, num_samples=1, num_chains=config["chains"],
              cfg=NutsConfig(max_depth=4), verbose=False, device="cpu")
    save_warmup(path, res.warmup_state)
    return str(path), hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("family", ["plpeak", "brokenpl"])
def test_another_family_runs_through_the_harness(tiny_bench, tmp_path, family):
    """A ``plpeak`` or ``brokenpl`` configuration goes through ``measure``
    from a state that the port's warmup made: the window opens and closes,
    the recorded sites are the family's, and the whole step's work is the
    family's.  No reference of these families exists yet, so nothing is
    judged (``measure`` reads none; the configuration keeps the flagship's
    ``reference`` key only because ``Cell`` imports it)."""
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES

    config, traffic, bench = tiny_config(tiny_bench, family=family)
    state, digest = adapted_state(family, config, bench, tmp_path / f"{family}_warmup.npz")
    config.update(warmup_state=state, warmup_state_sha256=digest)
    cell = harness.Cell(config, traffic, "cpu", bench)
    names = list(MASS_FAMILIES[family].cosmo_priors)
    assert list(cell.spec.priors) == names and cell.warm.state.theta.shape == (config["chains"], len(names))

    window, recorder, tr = harness.measure(cell, seed=2**31 + 19, seconds=1.5, trace=True, sync=lambda: None)
    assert window.open_t is not None and window.close_t is not None
    assert window.count > 0 and len(recorder.thetas) == window.count
    items = recorder.items()
    assert items and all(list(rec.sites) == names and torch.isfinite(rec.ll).all() for rec in items)

    from cardbench import counts

    run = harness.Run(window, tr.read(), cell.shapes(), counts.H100_MAX_SM_CLOCK_HZ)
    assert run.shapes["family"] == family
    mfu = harness.load_reader("mfu.leapfrog", bench)(run)
    idx = window.outside_stretch()
    ops = sum(counts.leapfrog_ops(window.chains[i], config["n_grid"], cell.queries, family) for i in idx)
    assert mfu == pytest.approx(100.0 * ops / sum(window.intervals()[i] for i in idx) / counts.FP32_OPS_PER_S)
    assert harness.load_reader("a_bump_roofline", bench)(run) is None  # the family runs no kernel A


def test_an_unknown_family_raises_at_set_up_naming_the_known_ones(tiny_bench):
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES

    config, traffic, bench = tiny_config(tiny_bench, family="plpeek")
    with pytest.raises(ValueError, match="plpeek") as err:
        harness.Cell(config, traffic, "cpu", bench)
    assert all(name in str(err.value) for name in MASS_FAMILIES)

    manifest, _ = tiny_bench
    (bench / "configs" / "flagship_bump.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="plpeek"):
        harness.run_benchmark(manifest, CELL, 1, 1.0, False, "cpu", 0.0, bench_dir=bench, root=bench,
                              log=lambda msg: None)
