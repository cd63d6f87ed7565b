"""The port's ingestion (``bumpcosmology_torch.data``: ``gwtc``, ``resample``)
against the JAX package's on the same inputs, in one run.

The HDF5 fixtures have the shapes of the JAX package's own data tests
(``tests/test_data.py``): PE tables under each analysis key, and an O3
injection file with its four FAR columns and Ndraw attributes.  Each case
hands both packages the same file and a numpy generator from one seed.

Tolerances.  The extractors are float64 numpy in both packages, so with the
PE prior as the target, or a target weight written in numpy and handed to
both, their outputs are equal (``assert_array_equal``).  With each
package's own ``default_pop_wt`` (a float32 population intensity on its
device, rtol 5e-5 between the packages: ``tests/test_torch_mock.py``) the
same rows are drawn and the weight columns agree at rtol 5e-5.  Every
rejection raises the same exception type with the same message.
"""
import h5py
import numpy as np
import pytest

from bumpcosmology_tpu import data as jd
from bumpcosmology_torch import data as td

F32_POP = 5e-5  # the two packages' float32 default_pop_wt (tests/test_torch_mock.py)


def _pe_fixture(path, group, n=4096, seed=0, low_mass=False, nan_rows=0):
    """A PE table of ``n`` rows under ``group`` (``tests/test_data.py:71-80``),
    with ``nan_rows`` of its redshifts set to NaN."""
    rng = np.random.default_rng(seed)
    m1 = rng.uniform(4.0, 12.0, n) if low_mass else rng.uniform(20.0, 50.0, n)
    q = rng.uniform(0.2, 0.6, n) if low_mass else rng.uniform(0.5, 1.0, n)
    z = rng.uniform(0.05, 0.8, n)
    z[:nan_rows] = np.nan
    arr = np.zeros(n, dtype=[("mass_1_source", "f8"), ("mass_ratio", "f8"), ("redshift", "f8")])
    arr["mass_1_source"], arr["mass_ratio"], arr["redshift"] = m1, q, z
    with h5py.File(path, "w") as f:
        f.create_dataset(group, data=arr)
    return path


def _injection_fixture(path, n=20000, seed=3, frac_detected=0.3, drop=(), nan_far=0):
    """An O3 injection file (``tests/test_data.py:110-133``) without the FAR
    columns named in ``drop``, and with the first ``nan_far`` hyperbank FARs NaN."""
    rng = np.random.default_rng(seed)
    m1 = np.exp(rng.uniform(np.log(5.0), np.log(100.0), n))
    m2 = m1 * rng.uniform(0.3, 1.0, n)
    z = rng.uniform(0.05, 1.5, n)
    far = np.where(rng.uniform(size=n) < frac_detected, 0.1, 100.0)
    far[:nan_far] = np.nan
    fars = {"far_pycbc_hyperbank": far, "far_pycbc_bbh": np.full(n, 100.0),
            "far_gstlal": np.where(rng.uniform(size=n) < 0.1, 0.5, 100.0), "far_mbta": np.full(n, 100.0)}
    with h5py.File(path, "w") as f:
        g = f.create_group("injections")
        g.create_dataset("mass1_source", data=m1)
        g.create_dataset("mass2_source", data=m2)
        g.create_dataset("redshift", data=z)
        g.create_dataset("mass1_source_mass2_source_sampling_pdf", data=1.0 / (m1 * m2))
        g.create_dataset("redshift_sampling_pdf", data=np.full(n, 1.0 / 1.45))
        for name, v in fars.items():
            if name not in drop:
                g.create_dataset(name, data=v)
        f.attrs["n_accepted"] = n
        f.attrs["n_rejected"] = 3 * n
        f.attrs["start_time_s"] = 0.0
        f.attrs["end_time_s"] = 3600.0 * 24.0 * 365.25
    return path


def _numpy_target(m1, q, z):
    """A population weight in float64 numpy, the same function for both packages."""
    return m1 ** -1.7 * q ** 1.1 * (1.0 + z) ** 1.9 * (q * m1 > 5.0)


def _both(fn_name, *args, seed=7, **kwargs):
    out = []
    for pkg in (jd, td):
        out.append(getattr(pkg, fn_name)(*args, rng=np.random.default_rng(seed), **kwargs))
    return out


def _assert_equal(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("group", ["PublicationSamples/posterior_samples", "C01:Mixed/posterior_samples",
                                   "C01:IMRPhenomXPHM/posterior_samples"])
@pytest.mark.parametrize("target", ["prior", "numpy"])
def test_extract_posterior_samples_equals_jax(tmp_path, group, target):
    """Both canonical analysis keys and a per-waveform ``C01:*`` key (the
    fallback of files without the canonical two)."""
    p = _pe_fixture(tmp_path / "pe.h5", group, seed=2)
    kw = {} if target == "prior" else {"desired_pop_wt": _numpy_target}
    ref, got = _both("extract_posterior_samples", p, 128, **kw)
    assert got[0].shape == (128,)
    _assert_equal(ref, got)


def test_extract_posterior_samples_with_the_population_weight(tmp_path):
    p = _pe_fixture(tmp_path / "pe.h5", "PublicationSamples/posterior_samples", seed=2)
    ref = jd.extract_posterior_samples(p, 128, desired_pop_wt=jd.default_pop_wt, rng=np.random.default_rng(1))
    got = td.extract_posterior_samples(p, 128, rng=np.random.default_rng(1),
                                       desired_pop_wt=lambda m1, q, z: td.default_pop_wt(m1, q, z, device="cpu"))
    _assert_equal(ref[:3], got[:3])
    np.testing.assert_allclose(got[3], ref[3], rtol=F32_POP, atol=0.0)


def test_extract_posterior_samples_drops_nan_rows_as_jax(tmp_path, capsys):
    p = _pe_fixture(tmp_path / "pe.h5", "C01:Mixed/posterior_samples", seed=4, nan_rows=37)
    ref, got = _both("extract_posterior_samples", p, 64, desired_pop_wt=_numpy_target)
    _assert_equal(ref, got)
    assert capsys.readouterr().out.count("dropping 37 non-finite posterior rows") == 2


@pytest.mark.parametrize("case,match", [
    ("low_m2", "median m2"),
    ("low_neff", "Neff"),
    ("unknown_layout", "could not read"),
    ("too_few_finite", "finite posterior rows"),
])
def test_extract_posterior_samples_rejects_as_jax(tmp_path, case, match):
    p = tmp_path / f"{case}.h5"
    nsamp = 128
    if case == "low_m2":
        _pe_fixture(p, "PublicationSamples/posterior_samples", low_mass=True)
    elif case == "low_neff":
        _pe_fixture(p, "PublicationSamples/posterior_samples", n=300)
        nsamp = 256
    elif case == "unknown_layout":
        with h5py.File(p, "w") as f:
            f.create_dataset("something_else", data=np.zeros(3))
    else:
        _pe_fixture(p, "PublicationSamples/posterior_samples", n=600, nan_rows=200)
    errors = []
    for pkg in (jd, td):
        with pytest.raises(ValueError, match=match) as err:
            pkg.extract_posterior_samples(p, nsamp, desired_pop_wt=_numpy_target, rng=np.random.default_rng(0))
        errors.append(err.value)
    assert type(errors[1]).__name__ == type(errors[0]).__name__
    assert isinstance(errors[1], td.RejectedEventError) == isinstance(errors[0], jd.RejectedEventError)
    assert str(errors[1]) == str(errors[0])


@pytest.mark.parametrize("case", ["all_searches", "missing_searches", "nan_far"])
@pytest.mark.parametrize("target", ["draw", "numpy"])
def test_extract_selection_samples_equals_jax(tmp_path, case, target):
    """The FAR cut over whichever searches the file has (a NaN FAR is not
    detected), Ndraw from the attributes, pdraw per year and renormalized."""
    drop = ("far_pycbc_bbh", "far_mbta") if case == "missing_searches" else ()
    p = _injection_fixture(tmp_path / "inj.h5", drop=drop, nan_far=500 if case == "nan_far" else 0)
    kw = {} if target == "draw" else {"desired_pop_wt": _numpy_target}
    ref, got = _both("extract_selection_samples", p, 512, far_threshold=1.0, **kw)
    _assert_equal(ref, got)
    assert got[4] == 512.0


def test_extract_selection_samples_with_the_population_weight(tmp_path):
    p = _injection_fixture(tmp_path / "inj.h5")
    ref = jd.extract_selection_samples(p, 512, desired_pop_wt=jd.default_pop_wt, rng=np.random.default_rng(4))
    got = td.extract_selection_samples(p, 512, rng=np.random.default_rng(4),
                                       desired_pop_wt=lambda m1, q, z: td.default_pop_wt(m1, q, z, device="cpu"))
    _assert_equal(ref[:3], got[:3])
    np.testing.assert_allclose(got[3], ref[3], rtol=F32_POP, atol=0.0)
    assert got[4] == ref[4]


def test_extract_selection_samples_without_far_columns_raises_as_jax(tmp_path):
    p = _injection_fixture(tmp_path / "inj.h5",
                           drop=("far_pycbc_hyperbank", "far_pycbc_bbh", "far_gstlal", "far_mbta"))
    messages = []
    for pkg in (jd, td):
        with pytest.raises(ValueError, match="no FAR columns") as err:
            pkg.extract_selection_samples(p, 16, rng=np.random.default_rng(0))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_resample_injections_equals_jax():
    rng = np.random.default_rng(7)
    n = 20000
    m1 = np.exp(rng.uniform(np.log(6.0), np.log(80.0), n))
    q = rng.uniform(0.5, 1.0, n)
    z = rng.uniform(0.05, 1.0, n)
    pdraw = rng.uniform(0.5, 2.0, n)
    ref, got = _both("resample_injections", m1, q, z, pdraw, 4.0 * n, _numpy_target, seed=8)
    _assert_equal(ref, got)
    w = _numpy_target(m1, q, z) / pdraw
    assert td.importance_neff(w) == jd.importance_neff(w)
