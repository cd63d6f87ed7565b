"""Guards of the port's boundaries.

* Importing the port pulls in neither JAX nor the JAX package.
* No file of the port, and not ``chip_smoke.py``, names either package; no
  module of the port imports ``chip_smoke.py``.
* Entry points given ``device=None`` (meaning CUDA) raise on a host without
  CUDA instead of carrying on on the CPU: the data loaders, the model specs
  of every family, the samplers, ``fit`` and the fit stages, the mock
  campaign and the four mock stages, ingestion and its stages, the
  benchmark catalogs and the pipeline CLI.
* A kernel wrapper given a CUDA tensor raises on what the kernel does not take
  and never takes the plain twin.
* The ctypes signatures agree with the ``extern "C"`` declarations they bind.
"""
import functools
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "bumpcosmology_torch"


@functools.lru_cache(maxsize=None)
def _modules_after_importing_the_port():
    """``sys.modules`` of a fresh interpreter that imported every port module (one run per process)."""
    code = (
        "import sys, json, pkgutil, importlib, bumpcosmology_torch\n"
        "for m in pkgutil.walk_packages(bumpcosmology_torch.__path__, 'bumpcosmology_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return tuple(json.loads(r.stdout.splitlines()[-1]))


def test_import_leaves_jax_out():
    bad = [m for m in _modules_after_importing_the_port()
           if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib") or m.startswith("bumpcosmology_tpu")]
    assert not bad


def test_import_leaves_pandas_and_h5py_out():
    """The GPU host has neither package: the port's tables are dicts of arrays."""
    bad = [m for m in _modules_after_importing_the_port() if m.split(".")[0] in ("pandas", "h5py")]
    assert not bad


def _hits(files, pattern):
    return [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1) if re.search(pattern, line)]


@pytest.mark.parametrize("pattern", [r"bumpcosmology_tpu", r"\bjax\b"])
def test_no_port_file_names_the_jax_packages(pattern):
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert not _hits(files, pattern)


@pytest.mark.parametrize("name", ["inference/sampler.py", "inference/chees.py", "inference/diagnostics.py",
                                  "utils/trace.py", "utils/io.py", "pipeline/config.py", "pipeline/stages.py",
                                  "ops/logsumexp.py", "models/plpeak.py", "models/brokenpl.py",
                                  "inference/calibration.py", "inference/fleet.py", "inference/score_check.py",
                                  "inference/model_compare.py", "inference/evidence.py", "inference/modes.py",
                                  "inference/ppc.py", "inference/prior_sens.py", "inference/influence.py",
                                  "data/gwtc.py", "data/resample.py", "data/rehearsal.py", "data/fetch.py",
                                  "pipeline/dag.py", "pipeline/__main__.py", "benchdata.py"])
def test_the_guards_cover_the_fit_modules(name):
    """The grep guard scans the fit's modules, and the import guard imports them."""
    assert PORT / name in list(PORT.rglob("*.py"))
    module = "bumpcosmology_torch." + name[:-3].replace("/", ".")
    assert module in _modules_after_importing_the_port()


def test_chip_smoke_imports_neither_package():
    """chip_smoke.py cites the replaced Pallas kernels by path in its report,
    and imports neither package."""
    smoke = [ROOT / "chip_smoke.py"]
    assert not _hits(smoke, r"^\s*(import|from)\s+(jax|bumpcosmology_tpu)\b")
    assert not _hits(smoke, r"\bjax\b")


def test_no_port_module_imports_chip_smoke():
    """The script at the repository's root imports the port, never the reverse:
    what the on-card tools share with it lives in ``tools/oncard.py``."""
    assert not _hits(PORT.rglob("*.py"), r"^\s*(import|from)\s+chip_smoke\b|import_module\(\s*[\"']chip_smoke\b")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_load_pop_cosmo_data_raises_without_cuda(no_cuda):
    from bumpcosmology_torch.benchdata import load_pop_cosmo_data

    with pytest.raises(RuntimeError, match="CUDA"):
        load_pop_cosmo_data(ROOT / "benchmarks" / "flagship_catalog.npz")


def test_pop_cosmo_model_spec_raises_without_cuda(no_cuda):
    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec

    data = load_pop_cosmo_data(ROOT / "benchmarks" / "flagship_catalog.npz", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pop_cosmo_model_spec(data)


def test_run_sampling_raises_without_cuda(no_cuda):
    from bumpcosmology_torch.inference.nuts import run_sampling
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    warm = load_warmup(ROOT / "benchmarks" / "flagship_warmup16.npz", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sampling(lambda th: (th * th).sum(-1), warm, 1)


def _fit_entry_points():
    import numpy as np

    from bumpcosmology_torch.inference.chees import run_chees, run_chees_from_warmup
    from bumpcosmology_torch.inference.distributions import Normal
    from bumpcosmology_torch.inference import likelihoods
    from bumpcosmology_torch.inference.likelihoods import pop_model_spec
    from bumpcosmology_torch.inference.model import ModelSpec
    from bumpcosmology_torch.inference.nuts import run_nuts, run_warmup
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.pipeline.config import PipelineConfig
    from bumpcosmology_torch.pipeline.stages import run_pop_cosmo_fit, run_pop_fit
    from bumpcosmology_torch.testing import synthetic_pop_cosmo_data, synthetic_pop_data
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    spec = ModelSpec(priors={"x": Normal(0.0, 1.0)}, loglike=lambda s: 0.0 * s["x"])
    pot = lambda th: (th * th).sum(-1)  # noqa: E731
    one = np.ones(4)
    pe = {"m1": 30.0 * one, "q": 0.8 * one, "z": 0.5 * one, "wt": one, "evt": np.array([0, 0, 1, 1])}
    sel = {"m1": 30.0 * one, "q": 0.8 * one, "z": 0.5 * one, "pdraw": one, "ndraw": 10.0 * one}
    return {
        "fit": lambda: fit(spec, 0, num_warmup=2, num_samples=2, num_chains=2),
        "run_warmup": lambda: run_warmup(pot, torch.zeros(2, 3), 2),
        "run_nuts": lambda: run_nuts(pot, torch.zeros(2, 3), 2, 2),
        "run_pop_cosmo_fit": lambda: run_pop_cosmo_fit(PipelineConfig(), pe, sel),
        "run_pop_fit": lambda: run_pop_fit(PipelineConfig(), pe, sel),
        "pop_model_spec": lambda: pop_model_spec(synthetic_pop_data(2, 3, 4, device="cpu")),
        "synthetic_pop_data": lambda: synthetic_pop_data(2, 3, 4),
        "run_chees": lambda: run_chees(pot, torch.zeros(2, 3), 2, 2),
        "run_chees_from_warmup": lambda: run_chees_from_warmup(
            pot, load_warmup(ROOT / "benchmarks" / "flagship_warmup16.npz", device="cpu"), 2, 2),
        **{f"{family}_model_spec": (lambda family=family: getattr(likelihoods, f"{family}_model_spec")(
            synthetic_pop_data(2, 3, 4, device="cpu"))) for family in ("plpeak", "brokenpl")},
        **{f"{family}_cosmo_model_spec": (lambda family=family: getattr(likelihoods, f"{family}_cosmo_model_spec")(
            synthetic_pop_cosmo_data(2, 3, 4, device="cpu"))) for family in ("plpeak", "brokenpl")},
    }


@pytest.mark.parametrize("entry", ["fit", "run_warmup", "run_nuts", "run_pop_cosmo_fit", "run_pop_fit",
                                   "pop_model_spec", "synthetic_pop_data", "run_chees", "run_chees_from_warmup",
                                   "plpeak_model_spec", "brokenpl_model_spec", "plpeak_cosmo_model_spec",
                                   "brokenpl_cosmo_model_spec"])
def test_fit_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _fit_entry_points()[entry]()


def _mock_entry_points():
    import numpy as np

    from bumpcosmology_torch.data.weights import default_pop_wt
    from bumpcosmology_torch.mock.catalog import draw_injection_campaign
    from bumpcosmology_torch.mock.snr import amplitude_factor, network_snr_batched
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.config import PathsConfig, PipelineConfig

    one = np.ones(4)
    # a data directory that does not exist: a stage must raise before it reads or writes anything
    cfg = PipelineConfig(paths=PathsConfig(data_dir=str(ROOT / "no-such-directory")))
    return {
        **{name: (lambda name=name: getattr(stages, f"_stage_{name}")(cfg))
           for name in ("mock_injections", "mock_observations", "mock_year_samples", "mock_fit_inputs")},
        "draw_injection_campaign": lambda: draw_injection_campaign(ndraw=100, seed=1),
        "network_snr_batched": lambda: network_snr_batched(*(30.0 * one,) * 3, *(0.5 * one,) * 5),
        "amplitude_factor": lambda: amplitude_factor(30.0 * one, 20.0 * one),
        "default_pop_wt": lambda: default_pop_wt(30.0 * one, 0.8 * one, 0.5 * one),
    }


@pytest.mark.parametrize("entry", ["draw_injection_campaign", "network_snr_batched", "amplitude_factor",
                                   "default_pop_wt", "mock_injections", "mock_observations", "mock_year_samples",
                                   "mock_fit_inputs"])
def test_mock_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _mock_entry_points()[entry]()
    assert not (ROOT / "no-such-directory").exists()


def _ingestion_entry_points():
    from bumpcosmology_torch import benchdata
    from bumpcosmology_torch.data.rehearsal import write_rehearsal_catalog
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.__main__ import main
    from bumpcosmology_torch.pipeline.config import PathsConfig, PipelineConfig

    # a data directory that does not exist: an entry point must raise before it reads or writes anything;
    # the rehearsal fallback keeps the fetch stage offline
    missing = ROOT / "no-such-directory"
    cfg = PipelineConfig(paths=PathsConfig(data_dir=str(missing), pe_raw_dir=str(missing / "raw"),
                                           injection_file=str(missing / "inj.hdf5")))
    cfg.ingest.rehearsal_fallback = True
    return {
        **{name: (lambda name=name: getattr(stages, f"_stage_{name}")(cfg))
           for name in ("fetch", "draw_pe_samples", "draw_selection_samples")},
        "write_rehearsal_catalog": lambda: write_rehearsal_catalog(missing / "raw", missing / "inj.hdf5",
                                                                   campaign_ndraw=100),
        "mock_pop_data": lambda: benchdata.mock_pop_data(ndraw_campaign=100),
        "mock_pop_cosmo_data": lambda: benchdata.mock_pop_cosmo_data(ndraw_campaign=100),
        "flagship_pop_cosmo_data": lambda: benchdata.flagship_pop_cosmo_data(ROOT / "benchmarks" / "flagship_catalog.npz"),
        "cli": lambda: main(["sample_cosmo", "--rehearsal", "--data-dir", str(missing)]),
    }


@pytest.mark.parametrize("entry", ["fetch", "draw_pe_samples", "draw_selection_samples", "write_rehearsal_catalog",
                                   "mock_pop_data", "mock_pop_cosmo_data", "flagship_pop_cosmo_data", "cli"])
def test_ingestion_entry_points_raise_without_cuda(no_cuda, monkeypatch, entry):
    from bumpcosmology_torch.data import fetch

    def refuse(url, dest, timeout):
        raise AssertionError("a download was attempted")

    monkeypatch.setattr(fetch, "_download", refuse)
    with pytest.raises(RuntimeError, match="CUDA"):
        _ingestion_entry_points()[entry]()
    assert not (ROOT / "no-such-directory").exists()


def _calibration_entry_points():
    import numpy as np

    from bumpcosmology_torch.inference import calibration as cal
    from bumpcosmology_torch.inference.fleet import fleet_fit
    from bumpcosmology_torch.inference.score_check import joint_term_grads
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.config import PathsConfig, PipelineConfig

    cfg = PipelineConfig(paths=PathsConfig(data_dir=str(ROOT / "no-such-directory")))
    one = np.ones(4)
    table = {k: one for k in ("m1", "q", "z", "pdraw_mqz", "SNR", "log_mc_obs", "sigma_log_mc", "q_obs", "sigma_q",
                              "log_dl_obs", "sigma_log_dl")}
    return {
        "stage_sbc": lambda: stages._stage_sbc(cfg),
        "stage_score_check": lambda: stages._stage_score_check(cfg),
        "fleet_fit": lambda: fleet_fit(lambda d: (lambda th: (th * th).sum(-1)), torch.zeros(2), torch.zeros(2, 3)),
        "run_sbc": lambda: cal.run_sbc(lambda d: None, lambda rng, s: None, 1),
        "run_sbc_fleet": lambda: cal.run_sbc_fleet(None, None, None, 1),
        "make_mock_pop_simulator": lambda: cal.make_mock_pop_simulator(table, 10),
        "make_mock_pop_cosmo_simulator": lambda: cal.make_mock_pop_cosmo_simulator(table, 10),
        "make_mock_pop_cosmo_simulator_fresh": lambda: cal.make_mock_pop_cosmo_simulator_fresh(table),
        "selection_mu_samples": lambda: cal.selection_mu_samples(table, "bump", 4),
        "joint_term_grads": lambda: joint_term_grads({"h": 0.7}, ("h",), 2),
        **{name: (lambda name=name: getattr(cal, name)()) for name in (
            "make_pop_sbc_spec_builder", "make_pop_cosmo_sbc_spec_builder", "make_plpeak_cosmo_sbc_spec_builder",
            "make_brokenpl_cosmo_sbc_spec_builder")},
    }


@pytest.mark.parametrize("entry", ["stage_sbc", "stage_score_check", "fleet_fit", "run_sbc", "run_sbc_fleet",
                                   "make_mock_pop_simulator", "make_mock_pop_cosmo_simulator",
                                   "make_mock_pop_cosmo_simulator_fresh", "selection_mu_samples", "joint_term_grads",
                                   "make_pop_sbc_spec_builder", "make_pop_cosmo_sbc_spec_builder",
                                   "make_plpeak_cosmo_sbc_spec_builder", "make_brokenpl_cosmo_sbc_spec_builder"])
def test_calibration_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _calibration_entry_points()[entry]()
    assert not (ROOT / "no-such-directory").exists()


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a kernel wrapper sees of
    a tensor on the card, on a host that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)

    def contiguous(self):
        return _OnCuda(self._t.contiguous())


def _lse_args(c=2, k=8, g=6, nobs=3, nsamp=4, nsel=5):
    n = nobs * nsamp + nsel
    return [torch.zeros(c, k, 2), torch.zeros(c, g), torch.zeros(c, 15), torch.zeros(n, 4)], nobs, nsamp


@pytest.fixture
def plain_twin_calls(monkeypatch):
    from bumpcosmology_torch.ops import cuda_logwts

    calls = []

    def reached(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the plain twin was reached for a CUDA tensor")

    monkeypatch.setattr(cuda_logwts, "_evaluate", reached)
    return calls


@pytest.mark.parametrize("which", ["det", "bump", "scal", "qry"])
@pytest.mark.parametrize("fault", ["non_contiguous", "float64"])
def test_logwts_lse_raises_on_bad_cuda_argument(plain_twin_calls, which, fault):
    from bumpcosmology_torch.ops.cuda_logwts import logwts_lse

    args, nobs, nsamp = _lse_args()
    i = ["det", "bump", "scal", "qry"].index(which)
    if fault == "float64":
        args[i] = args[i].double()
    else:
        args[i] = torch.zeros(*args[i].shape[:-1], 2 * args[i].shape[-1])[..., ::2]
        assert not args[i].is_contiguous()
    with pytest.raises(ValueError, match=which):
        logwts_lse(*(_OnCuda(t) for t in args), nobs, nsamp)
    assert not plain_twin_calls


def test_logwts_lse_never_takes_the_plain_twin_for_a_cuda_tensor(plain_twin_calls):
    """Well-formed CUDA-typed arguments go on to the launch (which this host
    cannot make, so it raises); the plain twin is not a fallback."""
    from bumpcosmology_torch.ops.cuda_logwts import LAUNCHES, logwts_lse

    args, nobs, nsamp = _lse_args()
    before = dict(LAUNCHES)
    with pytest.raises(Exception) as err:
        logwts_lse(*(_OnCuda(t) for t in args), nobs, nsamp)
    assert not isinstance(err.value, ValueError), err.value
    assert not plain_twin_calls and LAUNCHES == before


@pytest.mark.parametrize("chains", [2, 3])
def test_logwts_lse_takes_a_query_table_per_chain_on_cuda(plain_twin_calls, chains):
    """A (C, N, 4) table with one table a chain goes on to the launch; one
    whose chain count is not the tables' raises ``ValueError`` naming it."""
    from bumpcosmology_torch.ops.cuda_logwts import LAUNCHES, logwts_lse

    args, nobs, nsamp = _lse_args(c=2)
    args[3] = args[3].expand(chains, -1, -1).contiguous()
    before = dict(LAUNCHES)
    with pytest.raises(Exception) as err:
        logwts_lse(*(_OnCuda(t) for t in args), nobs, nsamp)
    if chains == 2:
        assert not isinstance(err.value, ValueError), err.value
    else:
        assert isinstance(err.value, ValueError) and "qry" in str(err.value)
    assert not plain_twin_calls and LAUNCHES == before


def test_logwts_lse_rejects_other_devices():
    from bumpcosmology_torch.ops.cuda_logwts import logwts_lse

    args, nobs, nsamp = _lse_args()
    with pytest.raises(ValueError, match="unsupported device"):
        logwts_lse(*(t.to("meta") for t in args), nobs, nsamp)


@pytest.fixture
def bump_twin_calls(monkeypatch):
    from bumpcosmology_torch.ops import cuda_bump

    calls = []

    def reached(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the plain twin was reached for a CUDA tensor")

    monkeypatch.setattr(cuda_bump, "_bump_fwd_plain", reached)
    return calls


@pytest.mark.parametrize("fault", ["float64", "shape", "no_chain"])
def test_bump_log_dn_raises_on_bad_cuda_params(bump_twin_calls, fault):
    from bumpcosmology_torch.ops.cuda_bump import bump_log_dn

    params = {"float64": torch.ones(3, 5, dtype=torch.float64), "shape": torch.ones(3, 4),
              "no_chain": torch.ones(0, 5)}[fault]
    with pytest.raises(ValueError, match="params"):
        bump_log_dn(_OnCuda(params), 48)
    assert not bump_twin_calls


@pytest.mark.parametrize("n_grid", [1, 8193])
def test_bump_log_dn_raises_on_a_grid_the_kernel_cannot_take(bump_twin_calls, n_grid):
    from bumpcosmology_torch.ops.cuda_bump import bump_log_dn

    with pytest.raises(ValueError, match="n_grid"):
        bump_log_dn(_OnCuda(torch.ones(3, 5)), n_grid)
    assert not bump_twin_calls


def test_bump_log_dn_never_takes_the_plain_twin_for_a_cuda_tensor(bump_twin_calls):
    """Well-formed CUDA-typed ``params`` go on to the launch (which this host
    cannot make, so it raises); the plain twin is not a fallback."""
    from bumpcosmology_torch.ops.cuda_bump import LAUNCHES, bump_log_dn

    before = dict(LAUNCHES)
    with pytest.raises(Exception) as err:
        bump_log_dn(_OnCuda(torch.ones(3, 5)), 48)
    assert not isinstance(err.value, ValueError), err.value
    assert not bump_twin_calls and LAUNCHES == before


def test_bump_log_dn_rejects_other_devices():
    from bumpcosmology_torch.ops.cuda_bump import bump_log_dn

    with pytest.raises(ValueError, match="unsupported device"):
        bump_log_dn(torch.ones(3, 5, device="meta"), 48)


@pytest.fixture
def priors_twin_calls(monkeypatch):
    from bumpcosmology_torch.inference import model

    calls = []

    def reached(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the per-site priors were reached for a CUDA tensor")

    monkeypatch.setattr(model, "_log_prior_and_jac", reached)
    monkeypatch.setattr(model, "constrain", reached)
    return calls


def _priors_spec():
    from bumpcosmology_torch.inference.model import ModelSpec
    from bumpcosmology_torch.testing import PRIOR_SETS

    return ModelSpec(priors=dict(PRIOR_SETS["every_case"]), loglike=None)


@pytest.mark.parametrize("fault", ["float16", "int64", "sites"])
def test_priors_raise_on_a_bad_cuda_theta(priors_twin_calls, fault):
    from bumpcosmology_torch.inference.model import log_prior_and_sites
    from bumpcosmology_torch.ops.cuda_priors import LAUNCHES

    spec = _priors_spec()
    theta = {"float16": torch.zeros(3, spec.dim, dtype=torch.float16),
             "int64": torch.zeros(3, spec.dim, dtype=torch.int64), "sites": torch.zeros(3, spec.dim + 1)}[fault]
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="theta"):
        log_prior_and_sites(spec, _OnCuda(theta))
    assert not priors_twin_calls and LAUNCHES == before


def test_priors_never_take_the_per_site_code_for_a_cuda_tensor(priors_twin_calls):
    """A well-formed CUDA-typed theta goes on to the table's copy to the card
    and the launch (which this host cannot make, so it raises); the per-site
    code is not a fallback."""
    from bumpcosmology_torch.inference.model import log_prior_and_sites
    from bumpcosmology_torch.ops.cuda_priors import LAUNCHES

    spec = _priors_spec()
    before = dict(LAUNCHES)
    with pytest.raises(Exception) as err:
        log_prior_and_sites(spec, _OnCuda(torch.zeros(3, spec.dim)))
    assert not isinstance(err.value, ValueError), err.value
    assert not priors_twin_calls and LAUNCHES == before


def test_priors_reject_other_devices():
    from bumpcosmology_torch.inference.model import log_prior_and_sites

    spec = _priors_spec()
    with pytest.raises(ValueError, match="unsupported device"):
        log_prior_and_sites(spec, torch.zeros(3, spec.dim, device="meta"))


@pytest.fixture
def snr_plain_calls(monkeypatch):
    from bumpcosmology_torch.mock import cuda_snr

    calls = []

    def reached(*args, **kwargs):
        calls.append(args)
        raise AssertionError("a plain version was reached for a CUDA tensor")

    monkeypatch.setattr(cuda_snr, "snr_integral_plain", reached)
    monkeypatch.setattr(cuda_snr, "_snr_integral_segments_plain", reached)
    return calls


class _KernelReached(Exception):
    pass


@pytest.mark.parametrize("fault", ["float64", "shape", "well_formed"])
def test_snr_integral_never_takes_a_plain_version_for_a_cuda_tensor(snr_plain_calls, fault, monkeypatch):
    """Kernel C's wrapper raises on what the kernel does not take, and goes
    on to the C entry otherwise: here the card's allocations, the library and
    the stream are stubbed, and the stubbed entry records its call and raises.
    Neither plain rendering is a fallback, and a launch that raised is not counted."""
    from bumpcosmology_torch.mock import cuda_snr
    from bumpcosmology_torch.mock.cuda_snr import LAUNCHES, snr_integral

    entered = []

    class Library:
        def snr_integral(self, *args):
            entered.append(args)
            raise _KernelReached

    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    monkeypatch.setattr(cuda_snr, "_grid", lambda f_min, f_max, n_f, dev: cuda_snr.log_grid(f_min, f_max, n_f, "cpu"))
    monkeypatch.setattr(cuda_snr, "load_kernel", lambda name, signatures: Library())
    monkeypatch.setattr(cuda_snr, "cuda_stream", lambda t: None)
    rows = [torch.ones(5), torch.ones(5), torch.ones(5, dtype=torch.float64 if fault == "float64" else None)]
    inv_psd = torch.ones(511 if fault == "shape" else 512)
    before = dict(LAUNCHES)
    with pytest.raises(Exception) as err:
        snr_integral(*(_OnCuda(t) for t in rows), _OnCuda(inv_psd))
    if fault == "well_formed":
        assert isinstance(err.value, _KernelReached), err.value
        assert [args[7:9] for args in entered] == [(5, 512)]  # n, n_f
    else:
        assert isinstance(err.value, ValueError) and ("dl_gpc" if fault == "float64" else "inv_psd") in str(err.value)
        assert not entered
    assert not snr_plain_calls and LAUNCHES == before


def _extern_c_declarations(source: str):
    """{function: [ctypes type per argument]} of the ``extern "C" int f(...)``
    definitions of a CUDA source: a pointer is ``c_void_p``, an ``int`` is
    ``c_int``, a ``float`` is ``c_float``, a ``double`` is ``c_double``."""
    import ctypes

    scalars = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double}
    out = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        kinds = []
        for arg in (" ".join(a.split()) for a in args.split(",")):
            if "*" in arg:
                kinds.append(ctypes.c_void_p)
            else:
                kind = re.fullmatch(r"(\w+) \w+", arg)
                assert kind and kind.group(1) in scalars, f"{name}: argument {arg!r} is no pointer, int or float"
                kinds.append(scalars[kind.group(1)])
        out[name] = kinds
    return out


@pytest.mark.parametrize("source,module", [("bump", "ops.cuda_bump"), ("logwts", "ops.cuda_logwts"),
                                           ("floor", "ops.launch_floor"), ("snr", "mock.cuda_snr"),
                                           ("priors", "ops.cuda_priors"), ("families", "ops.cuda_families"),
                                           ("tables", "ops.cuda_tables")])
def test_ctypes_signatures_match_the_extern_c_declarations(source, module):
    """A mismatch cuts a pointer to 32 bits or shifts every argument after
    it, without any error; only the source can show it on a host without nvcc."""
    import ctypes
    import importlib

    declared = _extern_c_declarations((PORT / "csrc" / f"{source}.cu").read_text())
    bound = importlib.import_module(f"bumpcosmology_torch.{module}")._SIGNATURES
    assert set(bound) == set(declared)
    for name, (argtypes, restype) in bound.items():
        assert list(argtypes) == declared[name], name
        assert restype is ctypes.c_int


def test_bump_launch_geometry_matches_the_source():
    """``LAUNCH_GEOMETRY`` (what the on-card check times the launch floor in)
    and the wrapper's limits repeat constants of ``csrc/bump.cu``."""
    from bumpcosmology_torch.ops import cuda_bump

    text = (PORT / "csrc" / "bump.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert cuda_bump.LAUNCH_GEOMETRY == {"blocks": const["BLOCKS"], "fwd_threads": 32 * const["WARPS_FWD"],
                                         "bwd_threads": 32 * const["WARPS_BWD"]}
    assert cuda_bump._MAX_GRID == const["MAX_G"]
