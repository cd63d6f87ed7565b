"""Guards of the port's boundaries.

* Importing the port pulls in neither JAX nor the JAX package.
* No file of the port, and not ``chip_smoke.py``, names either package.
* Entry points given ``device=None`` (meaning CUDA) raise on a host without
  CUDA instead of carrying on on the CPU.
"""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "bumpcosmology_torch"


def _modules_after_importing_the_port():
    """``sys.modules`` of a fresh interpreter that imported every port module."""
    code = (
        "import sys, json, pkgutil, importlib, bumpcosmology_torch\n"
        "for m in pkgutil.walk_packages(bumpcosmology_torch.__path__, 'bumpcosmology_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.splitlines()[-1])


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


def test_chip_smoke_imports_neither_package():
    """chip_smoke.py cites the replaced Pallas kernels by path in its report,
    and imports neither package."""
    smoke = [ROOT / "chip_smoke.py"]
    assert not _hits(smoke, r"^\s*(import|from)\s+(jax|bumpcosmology_tpu)\b")
    assert not _hits(smoke, r"\bjax\b")


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


def _mock_entry_points():
    import numpy as np

    from bumpcosmology_torch.data.weights import default_pop_wt
    from bumpcosmology_torch.mock.catalog import draw_injection_campaign
    from bumpcosmology_torch.mock.snr import amplitude_factor, network_snr_batched

    one = np.ones(4)
    return {
        "draw_injection_campaign": lambda: draw_injection_campaign(ndraw=100, seed=1),
        "network_snr_batched": lambda: network_snr_batched(*(30.0 * one,) * 3, *(0.5 * one,) * 5),
        "amplitude_factor": lambda: amplitude_factor(30.0 * one, 20.0 * one),
        "default_pop_wt": lambda: default_pop_wt(30.0 * one, 0.8 * one, 0.5 * one),
    }


@pytest.mark.parametrize("entry", ["draw_injection_campaign", "network_snr_batched", "amplitude_factor",
                                   "default_pop_wt"])
def test_mock_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        _mock_entry_points()[entry]()


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a kernel wrapper sees of
    a tensor on the card, on a host that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


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


def test_logwts_lse_rejects_other_devices():
    from bumpcosmology_torch.ops.cuda_logwts import logwts_lse

    args, nobs, nsamp = _lse_args()
    with pytest.raises(ValueError, match="unsupported device"):
        logwts_lse(*(t.to("meta") for t in args), nobs, nsamp)
