"""The port's binding to the native C++ library (``bumpcosmology_torch/native.py``).

The native network SNR against the port's plain SNR (``mock/snr.py`` on the
CPU, kernel C's twin) at ``tests/test_native.py:38``'s rtol 5e-3 / atol 1e-3;
the alias sampler's distribution and determinism as ``tests/test_native.py:41-63``
tests them; and a build that fails raises with the compiler's output.  The
library builds with ``make -C native`` (the host has make and g++).
"""
import numpy as np
import pytest

from bumpcosmology_torch import native


def test_native_snr_matches_the_ports_snr():
    from bumpcosmology_torch.data.weights import planck18_dl_np
    from bumpcosmology_torch.mock.snr import network_snr_batched

    rng = np.random.default_rng(0)
    n = 200
    m1 = rng.uniform(10, 60, n)
    q = rng.uniform(0.4, 1.0, n)
    z = rng.uniform(0.05, 1.0, n)
    args = (m1 * (1 + z), m1 * q * (1 + z), planck18_dl_np(z), np.arccos(rng.uniform(-1, 1, n)),
            rng.uniform(0, 2 * np.pi, n), np.arcsin(rng.uniform(-1, 1, n)), rng.uniform(0, np.pi, n),
            rng.uniform(0, 2 * np.pi, n))
    got = native.network_snr_native(*args)
    want = network_snr_batched(*args, device="cpu")
    for det in ("H1", "L1", "V1", "net"):
        assert got[det].shape == (n,) and np.isfinite(got[det]).all()
        np.testing.assert_allclose(got[det], want[det], rtol=5e-3, atol=1e-3, err_msg=det)


def test_alias_sample_distribution():
    rng = np.random.default_rng(1)
    w = rng.uniform(0.1, 5.0, size=1000)
    k = 200_000
    idx = native.alias_sample(w, k, seed=42)
    assert idx.shape == (k,) and idx.dtype == np.int64
    assert idx.min() >= 0 and idx.max() < len(w)
    counts = np.bincount(idx, minlength=len(w))
    expected = w / w.sum() * k
    mask = expected > 50
    rel = np.abs(counts[mask] - expected[mask]) / np.sqrt(expected[mask])
    assert np.mean(rel) < 2.0
    assert np.max(rel) < 6.0


def test_alias_sample_deterministic():
    w = np.array([1.0, 2.0, 3.0])
    a = native.alias_sample(w, 100, seed=7)
    np.testing.assert_array_equal(a, native.alias_sample(w, 100, seed=7))
    assert not np.array_equal(a, native.alias_sample(w, 100, seed=8))
    assert native.available()


def test_a_failing_build_raises_with_its_output(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "bumpnative.cpp").write_text("this is not C++;\n")
    (tmp_path / "Makefile").write_text((native.NATIVE_DIR / "Makefile").read_text())
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)failed \(rc \d+\).*bumpnative\.cpp.*error"):
        native.network_snr_native(*([np.ones(2)] * 8))
    assert not native.available()
