"""The SBC certificate tool (``bumpcosmology_torch/tools/sbc_certificate.py``)
against the JAX package's three 128-simulation certificates.

* The tool's configurations are the reference drivers' (their ``cfg.sbc.*``
  and ``cfg.fit.*`` assignments, read as text and applied to the JAX
  package's ``PipelineConfig``), field for field.
* The port's ``sbc_uniformity_pvalues`` reproduces each reference artifact's
  stored p-values and verdicts from its ranks, and the tool's embedded table
  equals them (needs h5py).
* Each card artifact committed under ``bumpcosmology_torch/certificates/``
  stores the p-values its ranks give, by the port's function and by the JAX
  package's, at 128 simulations over the family's sites.
* A CPU rehearsal of the tool at a tiny size writes its artifact and report.
"""
import ast
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bumpcosmology_torch.inference import calibration as cal
from bumpcosmology_torch.tools import sbc_certificate as cert

ROOT = Path(__file__).resolve().parents[1]
CERTIFICATES = ROOT / "bumpcosmology_torch" / "certificates"
ASSIGNMENT = re.compile(r"^cfg\.(sbc|fit)\.(\w+)\s*=\s*(.+?)\s*$", re.M)


def _driver_assignments(family):
    """{(section, name): value} of the reference driver's ``cfg.sbc.*`` and ``cfg.fit.*`` lines."""
    text = (ROOT / cert.FAMILIES[family][2]).read_text()
    return {(sec, name): ast.literal_eval(val) for sec, name, val in ASSIGNMENT.findall(text)}


@pytest.mark.parametrize("family", sorted(cert.FAMILIES))
def test_the_tools_configuration_is_the_reference_drivers(family, tmp_path):
    from bumpcosmology_tpu.pipeline.config import PipelineConfig as JaxPipelineConfig

    assigned = _driver_assignments(family)
    assert len(assigned) == 14  # model, seed and the twelve fields of CERTIFICATE
    ref = JaxPipelineConfig()
    for (sec, name), val in assigned.items():
        setattr(getattr(ref, sec), name, val)
    cfg = cert.certificate_config(family, out=tmp_path)
    for sec in ("sbc", "fit"):
        assert dataclasses.asdict(getattr(cfg, sec)) == dataclasses.asdict(getattr(ref, sec)), sec
    assert cfg.sbc.fresh_noise and cfg.sbc.max_depth == 8 and cfg.paths.data_dir == str(tmp_path)
    assert cert.certificate_config(family, seed=1).sbc.seed == 1


def _h5_artifact(path):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "r") as h:
        ranks = {k: np.asarray(h["ranks"][k]) for k in h["ranks"] if k != "n_bins"}
        ranks["__n_bins__"] = np.asarray(h["ranks/n_bins"])
        sites = [s.decode() if isinstance(s, bytes) else str(s) for s in h["pvalues/site"][()]]
        stored = dict(zip(sites, h["pvalues/p"][()].tolist()))
        passed = dict(zip(sites, h["pvalues/passed"][()].tolist()))
        rate_p = float(h["rate_check"].attrs["p"]) if "rate_check" in h else None
        all_pass = bool(h.attrs["all_pass"])
    return ranks, stored, passed, rate_p, all_pass


@pytest.mark.parametrize("family", sorted(cert.FAMILIES))
def test_reference_pvalues_are_reproduced_and_embedded(family):
    ranks, stored, passed, rate_p, all_pass = _h5_artifact(ROOT / cert.FAMILIES[family][3])
    got = cal.sbc_uniformity_pvalues(ranks)
    assert set(got) == set(stored)
    np.testing.assert_allclose([got[k] for k in stored], list(stored.values()), rtol=1e-12, atol=0)
    assert {k: v >= cert.P_MIN for k, v in got.items()} == passed and all_pass == all(passed.values())
    table, table_rate = cert.REFERENCE[family]
    assert set(table) == set(stored)
    np.testing.assert_allclose([table[k] for k in stored], list(stored.values()), rtol=1e-12, atol=0)
    assert table_rate == rate_p


@pytest.mark.parametrize("family", sorted(cert.FAMILIES))
def test_card_artifact_stores_what_its_ranks_give(family):
    from bumpcosmology_tpu.inference.calibration import sbc_uniformity_pvalues as jax_pvalues

    path = CERTIFICATES / f"sbc_ranks_{family}_128_h100.npz"
    if not path.exists():
        pytest.skip(f"no card artifact for {family} (the suite was not run on the card)")
    with np.load(path) as d:
        art = {k: d[k] for k in d.files}
    n_bins = int(art["ranks/n_bins"])
    ranks = {k[len("ranks/"):]: v for k, v in art.items() if k.startswith("ranks/") and k != "ranks/n_bins"}
    ranks["__n_bins__"] = np.asarray(n_bins)
    stored = dict(zip((str(s) for s in art["pvalues/site"]), art["pvalues/p"].tolist()))
    proto = cal.COSMO_SBC_SPEC_BUILDERS[family](device="cpu")(None)
    assert set(stored) == {k for k in proto.priors if k != "R_unit"} == set(cert.REFERENCE[family][0])
    assert str(art["attrs/model"]) == cert.FAMILIES[family][0] and int(art["attrs/n_sims"]) == 128
    assert n_bins == 512 // 8 + 1
    for site in stored:
        r = ranks[site]
        assert r.shape == (128,) and np.all((r >= 0) & (r < n_bins))
    got, ref = cal.sbc_uniformity_pvalues(ranks), jax_pvalues(ranks)
    for site, p in stored.items():
        assert got[site] == p and ref[site] == pytest.approx(p, rel=1e-12, abs=0)
    assert art["pvalues/passed"].tolist() == [stored[str(s)] >= cert.P_MIN for s in art["pvalues/site"]]
    assert "rate_check/attrs/p" in art and np.isfinite(float(art["rate_check/attrs/p"]))


def test_the_tool_rehearses_on_the_cpu(tmp_path, capsys):
    """The tool end to end on the CPU with overrides: 3 simulations of 4
    events, a 400,000-draw campaign at SNR 10, 10 warmup steps and 8 draws at
    depth 3: it prints the site table, the rate check and the verdict, and
    writes the stage's artifact and its report."""
    argv = ["--family", "bump", "--device", "cpu", "--out", str(tmp_path), "sbc.n_sims=3", "sbc.nobs=4",
            "sbc.nsamp=16", "sbc.nsel=64", "sbc.campaign_ndraw=400000", "sbc.num_warmup=10", "sbc.num_samples=8",
            "sbc.thin=2", "sbc.max_depth=3", "sbc.pe_bank_size=512", "sbc.threshold=10.0", "fit.n_grid=48",
            "fit.n_z=64", "mock.snr_chunk=8192"]
    rc = cert.main(argv)
    out = capsys.readouterr().out
    report = json.loads((tmp_path / "sbc_certificate.json").read_text())
    assert rc == (0 if report["passed"] else 1)
    assert report["seed"] == 766001 and report["n_sims"] == 3 and report["rate_p"] is not None
    assert "[certificate] rate check: p = " in out and "[certificate] verdict: " in out
    assert report["value_grads"] > 0 and report["ms_per_value_grad"] > 0
    with np.load(tmp_path / "sbc_ranks.npz") as d:
        assert dict(zip((str(s) for s in d["pvalues/site"]), d["pvalues/p"].tolist())) == report["pvalues"]
    assert set(report["pvalues"]) == set(cert.REFERENCE["bump"][0])


def test_the_tool_fails_a_joint_suite_whose_rate_check_did_not_run(tmp_path, monkeypatch):
    """The stage only warns when the rate check fails; the tool exits 1."""
    from bumpcosmology_torch.pipeline import stages

    def stage(cfg, device=None, probe=0, checkpoint_path=None, warmup_only=False):
        sites = cert.REFERENCE["bump"][0]
        return dict(campaign_s=1.0, simulate_s=1.0, init_s=0.0, warmup_s=1.0, sampling_s=1.0, warmup_evals=10,
                    sampling_evals=10, warmup_transitions=5, sampling_transitions=5, divergences=0,
                    rate_check_s=0.0, write_s=0.0, pvalues=dict.fromkeys(sites, 0.5), bad=[], rate_p=None,
                    artifact=tmp_path / "sbc_ranks.npz")

    monkeypatch.setattr(stages, "_stage_sbc", stage)
    assert cert.main(["--family", "bump", "--device", "cpu", "--out", str(tmp_path)]) == 1
    assert json.loads((tmp_path / "sbc_certificate.json").read_text())["rate_p"] is None
    with pytest.raises(SystemExit):
        cert.main(["--family", "bump", "--device", "cpu", "--warmup-only"])


def test_the_probe_projects_without_writing(tmp_path):
    overrides = ["sbc.n_sims=3", "sbc.nobs=4", "sbc.nsamp=16", "sbc.nsel=64", "sbc.campaign_ndraw=400000",
                 "sbc.max_depth=2", "sbc.pe_bank_size=512", "sbc.threshold=10.0", "fit.n_grid=48", "fit.n_z=64",
                 "mock.snr_chunk=8192"]
    r = cert.run_certificate("bump", out=tmp_path, probe=3, device="cpu", overrides=overrides)
    assert r["probe_transitions"] == 3 and r["projected_s"] > r["warmup_s"] > 0 and r["value_grads"] > 3
    assert not (tmp_path / "sbc_ranks.npz").exists()
    with pytest.raises(ValueError, match="probe"):
        cert.run_certificate("bump", out=tmp_path, probe=20, device="cpu", overrides=overrides)


def _toy_spec():
    """y ~ N(mu, 1) x 20 with mu ~ N(0, 2)."""
    from bumpcosmology_torch.inference.distributions import Normal
    from bumpcosmology_torch.inference.model import ModelSpec

    return ModelSpec(priors={"mu": Normal(0.0, 2.0)}, loglike=None, device=torch.device("cpu"))


def _toy_simulate(rng, sites):
    return torch.as_tensor(rng.normal(float(sites["mu"]), 1.0, size=20), dtype=torch.float32)


def _toy_make_loglike(datas):
    return lambda sites, d: -0.5 * ((d - sites["mu"][:, None]) ** 2).sum(-1)


def test_a_suite_split_at_the_end_of_its_warmup_gives_the_unsplit_ranks(tmp_path):
    """``run_sbc_fleet`` (the stage's fleet, which the tool's ``--checkpoint
    P --warmup-only`` and then ``--checkpoint P`` reach): the warmup-only run
    writes the adapted state and the generator's state and returns no ranks;
    the second run draws the same catalogs, resumes there and gives the
    unsplit run's ranks and statistics bit for bit, with no warmup of its own."""
    args = dict(n_sims=6, generator=2, num_warmup=40, num_samples=24, thin=4, seed=3, chunk_size=10,
                verbose=False, device="cpu")
    whole, warm, resumed = {}, {}, {}
    ranks = cal.run_sbc_fleet(_toy_spec(), _toy_make_loglike, _toy_simulate, stats=whole, **args)
    ckpt = tmp_path / "warm.npz"
    assert cal.run_sbc_fleet(_toy_spec(), _toy_make_loglike, _toy_simulate, stats=warm, checkpoint_path=ckpt,
                             warmup_only=True, **args) is None
    assert ckpt.exists() and warm["warmup_evals"] == whole["warmup_evals"] > 0 and warm["sampling_evals"] == 0
    again = cal.run_sbc_fleet(_toy_spec(), _toy_make_loglike, _toy_simulate, stats=resumed, checkpoint_path=ckpt,
                              **args)
    assert set(again) == set(ranks)
    for k in ranks:
        np.testing.assert_array_equal(again[k], ranks[k], err_msg=k)
    assert resumed["warmup_evals"] == 0 and resumed["warmup_transitions"] == 0
    assert resumed["sampling_evals"] == whole["sampling_evals"] and resumed["divergences"] == whole["divergences"]
    with pytest.raises(ValueError, match="checkpoint_path"):
        cal.run_sbc_fleet(_toy_spec(), _toy_make_loglike, _toy_simulate, warmup_only=True, **args)
