"""The port's rehearsal fixtures (``bumpcosmology_torch.data.rehearsal``)
against the JAX package's: both write a catalog from one seed, and the HDF5
files are compared dataset by dataset; then each package's ingestion reads
the other's files.

Tolerances.  Every draw is host numpy from one generator in both packages,
so the PE files' names, groups, dtypes and attributes and the injection
file's masses, redshifts, sampling pdfs and attributes are equal.  The
campaign's SNRs come from each package's float32 SNR integral (kernel C's
plain twin here; rtol 1e-5 between the packages, ``tests/test_torch_mock.py``),
so ``optimal_snr_net`` is held at rtol 1e-5; each FAR column, a map of the
SNR with the same jitter, at ``log10 FAR + 1.2 SNR`` equal to 1e-9; and the
PE samples, drawn with uncertainties that scale as 1 / the observed SNR, at
rtol 1e-5.
"""
import h5py
import numpy as np
import pytest

from bumpcosmology_tpu import data as jd
from bumpcosmology_tpu.data.rehearsal import write_rehearsal_catalog as jax_write
from bumpcosmology_torch import data as td
from bumpcosmology_torch.data.rehearsal import write_rehearsal_catalog as torch_write

FARS = ("far_pycbc_hyperbank", "far_pycbc_bbh", "far_gstlal", "far_mbta")
KW = dict(n_events=4, nsamp_store=512, campaign_ndraw=40_000, threshold=15.0, seed=11)


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal")
    out = {}
    for name, write, kw in (("jax", jax_write, {}), ("torch", torch_write, {"device": "cpu"})):
        pe, inj = root / name / "pe-samples-raw", root / name / "endo3.hdf5"
        out[name] = (write(pe, inj, **KW, **kw), pe, inj)
    return out


def _tree(path):
    """{dataset path: array} and {object path: attributes} of an HDF5 file."""
    data, attrs = {}, {}
    with h5py.File(path, "r") as f:
        attrs["/"] = dict(f.attrs)

        def visit(name, obj):
            attrs[name] = dict(obj.attrs)
            if isinstance(obj, h5py.Dataset):
                data[name] = obj[()]

        f.visititems(visit)
    return data, attrs


def test_the_same_pe_files(catalogs):
    (nj, pe_j, _), (nt, pe_t, _) = catalogs["jax"], catalogs["torch"]
    assert nt == nj == KW["n_events"]
    names = sorted(p.name for p in pe_j.glob("*.h5"))
    assert sorted(p.name for p in pe_t.glob("*.h5")) == names
    assert any("GWTC2p1" in n for n in names) and any("GWTC3p0" in n for n in names)
    for name in names:
        (dj, aj), (dt, at) = _tree(pe_j / name), _tree(pe_t / name)
        assert sorted(dt) == sorted(dj) and at == aj
        for key in dj:
            assert dt[key].dtype == dj[key].dtype and dt[key].shape == dj[key].shape
            for field in dj[key].dtype.names:
                np.testing.assert_allclose(dt[key][field], dj[key][field], rtol=1e-5, atol=0.0,
                                           err_msg=f"{name}:{key}:{field}")


def test_the_same_injection_file(catalogs):
    (dj, aj), (dt, at) = _tree(catalogs["jax"][2]), _tree(catalogs["torch"][2])
    assert sorted(dt) == sorted(dj) and at == aj
    snr_j, snr_t = dj["injections/optimal_snr_net"], dt["injections/optimal_snr_net"]
    np.testing.assert_allclose(snr_t, snr_j, rtol=1e-5, atol=0.0)
    for key in dj:
        name = key.split("/")[-1]
        if name in FARS:
            np.testing.assert_allclose(np.log10(dt[key]) + 1.2 * snr_t, np.log10(dj[key]) + 1.2 * snr_j,
                                       rtol=0.0, atol=1e-9, err_msg=key)
        elif name != "optimal_snr_net":
            np.testing.assert_array_equal(dt[key], dj[key], err_msg=key)


def _numpy_target(m1, q, z):
    return m1 ** -1.7 * q ** 1.1 * (1.0 + z) ** 1.9 * (q * m1 > 5.0)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_each_package_reads_the_others_files(catalogs, writer, reader):
    """The reader's extraction of the writer's files equals the writer's own."""
    _, pe, inj = catalogs[writer]
    pkgs = {"jax": jd, "torch": td}
    for f in sorted(pe.glob("*.h5")):
        own, other = (pkgs[p].extract_posterior_samples(f, 128, desired_pop_wt=_numpy_target,
                                                        rng=np.random.default_rng(3)) for p in (writer, reader))
        for a, b in zip(own, other):
            np.testing.assert_array_equal(b, a)
    own, other = (pkgs[p].extract_selection_samples(inj, 256, desired_pop_wt=_numpy_target,
                                                    rng=np.random.default_rng(4)) for p in (writer, reader))
    for a, b in zip(own, other):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
