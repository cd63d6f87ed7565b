"""The port's mock-universe stages and run configuration against the JAX
package's, on the CPU.

* ``_load_psds`` on ``.npz``, ``.csv`` and whitespace text files: the same
  scaled PSD as the JAX package's at frequencies on and between the table's
  knots and beyond both ends, rtol 1e-5 (float32 log-log interpolation).
* The four mock stages (injections → observations → one-year catalog →
  fit inputs) at ``ndraw=20_000`` and ``nsamp`` 16, run by both packages into
  two data directories: every written table equal column for column.  Host
  draws are numpy float64 from the same seeds, so every column is equal
  except those that follow from a float32 device result, held at
  ``tests/test_torch_mock.py``'s limits: the SNR columns rtol 1e-5 with the
  same exact zeros, and so the columns the stages draw from them (the observed
  SNR, the measurement widths and point estimates, the catalog's PE samples),
  the catalog's weight rtol 5e-5.  Here each package's stages read their own
  tables, so the SNRs' rounding reaches those columns (about 1e-6 of a value);
  at these seeds no detection or pick flips on it.
* The stages print the JAX package's lines; a tabulated PSD reaches the campaign.
* ``PipelineConfig.load`` from a JSON file and ``section.key=value``
  overrides gives JAX's values in every section the port has (the sections'
  defaults: ``tests/test_torch_fit.py``).
"""
import json

import numpy as np
import pytest
import torch

from bumpcosmology_torch.pipeline import config, stages
from bumpcosmology_torch.utils.io import read_table

MOCK = dict(ndraw=20_000, nsamp=16, snr_chunk=4096)
FROM_SNR = {"SNR_H1", "SNR_L1", "SNR_V1", "SNR", "SNR_OBS", "sigma_log_mc", "log_mc_obs", "sigma_q", "q_obs",
            "sigma_log_dl", "log_dl_obs"}


def _rtol(table, col):
    """The column's limit, or None where it must be equal."""
    if col == "wt":
        return 5e-5
    if col in FROM_SNR or (table in ("mock_year_samples", "pe-samples") and col in ("m1", "q", "z")):
        return 1e-5
    return None


def _psd_table():
    f = np.geomspace(5.0, 4096.0, 300)
    return f, 1e-47 * (1.0 + (30.0 / f) ** 4 + (f / 300.0) ** 2)


@pytest.mark.parametrize("suffix", [".npz", ".csv", ".txt"])
def test_load_psds_matches_jax(tmp_path, suffix):
    from bumpcosmology_tpu.pipeline.stages import _load_psds as jload

    f, v = _psd_table()
    path = tmp_path / f"h1{suffix}"
    if suffix == ".npz":
        np.savez(path, f=f, psd=v)
    else:
        np.savetxt(path, np.stack([f, v], 1), delimiter="," if suffix == ".csv" else " ")
    got, ref = stages._load_psds({"H1": str(path)}), jload({"H1": str(path)})
    assert list(got) == list(ref) == ["H1"]
    fq = np.concatenate([f[::7], np.sqrt(f[1:] * f[:-1])[::5], [1.0, 9.9, 10.0, 5000.0]]).astype(np.float32)
    g = got["H1"](torch.as_tensor(fq)).numpy()
    r = np.asarray(ref["H1"](fq))
    assert np.array_equal(np.isinf(g), np.isinf(r)) and np.array_equal(np.isinf(g), fq < 10.0)  # f_low = 10 Hz
    np.testing.assert_allclose(g[np.isfinite(r)], r[np.isfinite(r)], rtol=1e-5)
    assert stages._load_psds(None) is None and stages._load_psds({}) is None


STAGES = ("_stage_mock_injections", "_stage_mock_observations", "_stage_mock_year_samples", "_stage_mock_fit_inputs")
TABLES = [("mock_injections", "true_parameters"), ("mock_observations", "observations"),
          ("mock_year_samples", "samples"), ("pe-samples", "samples"), ("selection-samples", "samples")]


@pytest.fixture(scope="module")
def mock_runs(tmp_path_factory):
    """Both packages' four mock stages, each into its own data directory, and what each printed."""
    import contextlib
    import io

    from bumpcosmology_tpu.pipeline import config as jconfig
    from bumpcosmology_tpu.pipeline import stages as jstages

    tmp = tmp_path_factory.mktemp("mock")
    out = {}
    for name, cmod, smod, kw in (("port", config, stages, {"device": "cpu"}), ("jax", jconfig, jstages, {})):
        cfg = cmod.PipelineConfig(paths=cmod.PathsConfig(data_dir=str(tmp / name)), mock=cmod.MockConfig(**MOCK))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            for stage in STAGES:
                getattr(smod, stage)(cfg, **kw)
        out[name] = (tmp / name, printed.getvalue())
    return out


@pytest.mark.parametrize("table,key", TABLES)
def test_mock_stages_write_what_the_jax_stages_write(mock_runs, table, key):
    from bumpcosmology_tpu.utils.io import read_table as jread

    got = read_table(mock_runs["port"][0] / f"{table}.npz", key=key)
    ref = jread(mock_runs["jax"][0] / f"{table}.h5", key=key)
    assert list(got) == list(ref.columns) and len(ref) > 0
    for k, v in got.items():
        want = ref[k].to_numpy()
        assert v.shape == want.shape, k
        rtol = _rtol(table, k)
        if rtol is None:
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_array_equal(v == 0, want == 0, err_msg=k)
            np.testing.assert_allclose(v, want, rtol=rtol, atol=0.0, err_msg=k)
    if table == "selection-samples":
        assert len(np.unique(got["ndraw"])) == 1 and 0 < got["ndraw"][0] <= MOCK["ndraw"]
    if table == "pe-samples":
        assert (np.bincount(got["evt"])[np.unique(got["evt"])] == MOCK["nsamp"]).all()


def test_mock_stages_print_the_jax_lines(mock_runs):
    got, ref = mock_runs["port"][1].splitlines(), mock_runs["jax"][1].splitlines()
    tagged = lambda lines: [x for x in lines if x.startswith(("[mock_injections]", "[mock_fit_inputs]"))]  # noqa: E731
    assert len(tagged(got)) == 2 and tagged(got) == tagged(ref)
    assert [x for x in got if x.startswith("[mock] catalog")] == [x for x in ref if x.startswith("[mock] catalog")]


def test_a_tabulated_psd_reaches_the_campaign(tmp_path):
    """With ``mock.psd_files`` the campaign's SNRs come from the files' PSDs:
    four times the design PSD for every detector halves every SNR."""
    from bumpcosmology_torch.mock.psd import PSD_SCALE, PSDS

    f = np.geomspace(10.0, 4096.0, 2000)
    files = {}
    for det, fn in PSDS.items():
        np.savez(tmp_path / f"{det}.npz", f=f, psd=4.0 * fn(torch.as_tensor(f)).numpy() * PSD_SCALE)
        files[det] = str(tmp_path / f"{det}.npz")
    snr = {}
    for label, psd_files in (("design", None), ("tabulated", files)):
        cfg = config.PipelineConfig(paths=config.PathsConfig(data_dir=str(tmp_path / label)),
                                    mock=config.MockConfig(ndraw=2000, psd_files=psd_files))
        stages._stage_mock_injections(cfg, device="cpu")
        snr[label] = read_table(cfg.paths.path("mock_injections.npz"), key="true_parameters")["SNR"]
    live = snr["design"] > 0
    assert live.sum() > 100 and np.array_equal(live, snr["tabulated"] > 0)
    np.testing.assert_allclose(snr["tabulated"][live], 0.5 * snr["design"][live], rtol=2e-3)


def test_pipeline_config_load_matches_jax(tmp_path):
    from bumpcosmology_tpu.pipeline import config as jconfig

    path = tmp_path / "run.json"
    path.write_text(json.dumps({"fit": {"num_chains": 16, "mass_family": "plpeak"},
                                "mock": {"ndraw": 200000, "psd_files": {"H1": "h1.txt"}},
                                "paths": {"data_dir": "elsewhere"}}))
    overrides = ["fit.num_warmup=30", "mock.detection_snr=12.5", "ingest.nsamp_sel=512", "fit.sampler=chees",
                 "fit.shared_mass=true"]
    got, ref = config.PipelineConfig.load(str(path), overrides), jconfig.PipelineConfig.load(str(path), overrides)
    d, r = got.to_dict(), ref.to_dict()
    assert list(d) == ["paths", "ingest", "fit", "mock", "sbc", "score", "loo", "compare", "ppc"]
    assert {k: r[k] for k in d} == d
    assert got.fit.num_chains == 16 and got.fit.num_warmup == 30 and got.mock.detection_snr == 12.5
    assert got.fit.shared_mass is True and got.mock.psd_files == {"H1": "h1.txt"}
    assert config.PipelineConfig.load().to_dict() == {k: v for k, v in jconfig.PipelineConfig.load().to_dict().items()
                                                      if k in d}
    for bad in (["fit.no_such_key=1"], ["mock.nope=2"]):
        with pytest.raises(KeyError, match="unknown config key"):
            config.PipelineConfig.load(None, bad)
    path.write_text(json.dumps({"ingest": {"no_such_key": 1}}))
    with pytest.raises(KeyError, match="unknown config key ingest.no_such_key"):
        config.PipelineConfig.load(str(path))
