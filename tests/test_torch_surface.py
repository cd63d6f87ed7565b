"""The port's public surface against the JAX package's, and the values of the
names added to complete it.

Surface: each JAX module's public top-level names (functions, classes and
assignments; in an ``__init__`` also what it imports), read by ``ast`` with
no import, must be bound at the top of the port's module of the same path.
What may be missing is listed below, with why: TPU-only names with no
counterpart and the documented exceptions.  No module is pending: the port
covers every module of the JAX package.  The lists must match what is
missing exactly.

Values, against the JAX functions on the same inputs (float32 in both):
the cosmology lookups and the ``vc`` column at rtol 2e-5 (the two packages'
cumulative trapezoids sum in different orders; an inverse lookup adds the
bracket's rounding), ``log_ndtr`` and ``ndtri`` at rtol 1e-5 / atol 1e-6,
``site_dims`` and the NetCDF export equal, the ``n_det`` keyword at the
potential's limits (|ΔU|/(1+|U|) < 2e-4), and ``mock_pop_cosmo_data`` with
the same rows: the selection's equal, the events' PE values at rtol 1e-5
(their measurement uncertainties scale as 1 / the float32 SNR, rtol 1e-5
between the packages) and their pdraw at rtol 5e-5 (the float32 population
weight; both in ``tests/test_torch_mock.py``).
"""
import ast
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "bumpcosmology_tpu", ROOT / "bumpcosmology_torch"

# names of the TPU build with no counterpart on the card: the MXU formulations of a table
# fetch and their switches, the Pallas kernel selectors, the Pallas kernels' own modules, and
# XLA's static cost analysis (the port compiles nothing with XLA; the nearest thing is the
# bound that tools/kernel_times.py and chip_smoke.py compute for each hand-written kernel)
TPU_ONLY = {
    ("ops/interp.py", "set_default_method"), ("ops/interp.py", "interp_unit_tiled"),
    ("ops/interp.py", "static_bracket_weights"), ("ops/interp.py", "fetch_static_bracket"),
    ("ops/__init__.py", "set_default_method"),
    ("inference/likelihoods.py", "set_logwts_impl"), ("inference/likelihoods.py", "set_bracket_fetch"),
    ("models/mass.py", "set_bump_kernel"),
    ("ops/pallas_bump.py", None), ("ops/pallas_logwts.py", None), ("mock/pallas_snr.py", None),
    ("utils/profiling.py", "xla_cost"),
}
# ops/__init__ does not re-export the functions ``interp`` and ``logsumexp``: ``ops.interp``
# and ``ops.logsumexp`` must stay the modules (tests/test_torch_ops.py imports ``ops.interp``)
DOCUMENTED = {("ops/__init__.py", "interp"), ("ops/__init__.py", "logsumexp")}
# modules of later slices, struck off as they land: none is left
PENDING = set()


def _names(path: pathlib.Path, imports: bool) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_public_names_match_the_jax_package():
    missing = set()
    for jax_file in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_file.relative_to(JAX_PKG).as_posix()
        port_file = PORT_PKG / rel
        if not port_file.exists():
            missing.add((rel, None))
            continue
        wanted = _names(jax_file, imports=jax_file.name == "__init__.py")
        missing.update((rel, name) for name in wanted - _names(port_file, imports=True))
    assert missing - (TPU_ONLY | DOCUMENTED | PENDING) == set()
    assert (TPU_ONLY | DOCUMENTED | PENDING) - missing == set(), "a listed name has landed: strike it off"


def test_the_package_reexports_resolve():
    from bumpcosmology_torch import data, inference, models, utils

    assert callable(inference.make_potential) and callable(utils.load_trace)
    assert set(models.COORDS) == {"m_grid", "q_grid", "z_grid"}
    assert data.RejectedEventError.__mro__[1] is ValueError


# ---------------------------------------------------------------- the values


@pytest.fixture(scope="module")
def tables():
    import jax.numpy as jnp

    from bumpcosmology_tpu.models import cosmology as jc
    from bumpcosmology_tpu.models.parameters import CosmoParams as JCosmo
    from bumpcosmology_torch.models import cosmology as tc
    from bumpcosmology_torch.models.parameters import CosmoParams

    params = np.array([[0.6766, 0.30966, -1.0], [0.72, 0.25, -0.8], [0.62, 0.4, -1.3]], np.float32)
    n = 256
    port = tc.build_cosmology(CosmoParams(*(torch.as_tensor(params[:, k]) for k in range(3))), n=n)
    ref = [jc.build_cosmology(JCosmo(*(jnp.float32(v) for v in row)), n=n) for row in params]
    return params, port, ref, jc, tc


def test_the_vc_column_and_the_hubble_distance(tables):
    params, port, ref, jc, tc = tables
    for c, jt in enumerate(ref):
        for col in ("dc", "dl", "ddl", "vc", "dvc"):
            np.testing.assert_allclose(getattr(port, col)[c].numpy(), np.asarray(getattr(jt, col)), rtol=2e-5,
                                       atol=0.0, err_msg=col)
        assert float(tc.hubble_distance(port.params)[c]) == pytest.approx(float(jc.hubble_distance(jt.params)),
                                                                          rel=1e-7)


@pytest.mark.parametrize("name", ["dc_at_z", "dl_at_z", "ddl_dz_at_z", "vc_at_z", "dvc_dz_at_z",
                                  "log_diff_comoving_volume_rate", "z_at_dc", "z_at_dl"])
def test_the_lookups(tables, name):
    import jax.numpy as jnp

    params, port, ref, jc, tc = tables
    rng = np.random.default_rng(5)
    z = rng.uniform(0.01, 5.0, (3, 200)).astype(np.float32)
    if name in ("z_at_dc", "z_at_dl"):  # inverse lookups: query the distance of each z
        col = "dc" if name == "z_at_dc" else "dl"
        x = np.stack([np.asarray(getattr(jc, col + "_at_z")(jt, jnp.asarray(z[c]))) for c, jt in enumerate(ref)])
    else:
        x = z
    got = getattr(tc, name)(port, torch.as_tensor(x)).numpy()
    want = np.stack([np.asarray(getattr(jc, name)(jt, jnp.asarray(x[c]))) for c, jt in enumerate(ref)])
    assert np.isfinite(got).all()
    if name == "log_diff_comoving_volume_rate":
        np.testing.assert_allclose(got, want, rtol=0.0, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=0.0)


def test_log_ndtr_and_ndtri():
    import jax.numpy as jnp
    from jax.scipy import special

    from bumpcosmology_torch.inference import distributions as td

    x = np.linspace(-30.0, 8.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(td.log_ndtr(torch.as_tensor(x)).numpy(), np.asarray(special.log_ndtr(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    u = np.concatenate([np.geomspace(1e-6, 0.5, 400), 1.0 - np.geomspace(1e-6, 0.5, 400)]).astype(np.float32)
    np.testing.assert_allclose(td.ndtri(torch.as_tensor(u)).numpy(), np.asarray(special.ndtri(jnp.asarray(u))),
                               rtol=1e-5, atol=1e-6)


def _trace(pkg):
    rng = np.random.default_rng(0)
    post = {"mpisn": rng.normal(size=(2, 5)), "neff": rng.uniform(size=(2, 5, 4)),
            "hz": rng.normal(size=(2, 5, 16)), "extra": rng.normal(size=(2, 5, 3))}
    return pkg.Trace(post, {"diverging": np.zeros((2, 5), bool), "tree_depth": np.ones((2, 5), np.int32)},
                     coords={"z_grid": np.linspace(0.0, 1.0, 16)}, attrs={"model": "pop"})


def test_site_dims_and_the_netcdf_export(tmp_path):
    import h5py

    from bumpcosmology_tpu.utils import trace as jt
    from bumpcosmology_torch.utils import trace as tt

    assert tt.site_dims(_trace(tt)) == jt.site_dims(_trace(jt)) == {
        "neff": ["event"], "hz": ["z_grid"], "extra": ["extra_dim0"]}
    jt.export_netcdf(tmp_path / "jax.nc", _trace(jt))
    tt.export_netcdf(tmp_path / "torch.nc", _trace(tt))
    seen = {}
    for name in ("jax", "torch"):
        items = {}
        with h5py.File(tmp_path / f"{name}.nc", "r") as f:
            def visit(key, obj):
                if isinstance(obj, h5py.Dataset):
                    items[key] = (obj[()], [[s.name for s in d.values()] for d in obj.dims],
                                  obj.attrs.get("CLASS"))
            f.visititems(visit)
        seen[name] = items
    assert sorted(seen["torch"]) == sorted(seen["jax"])
    for key, (arr, dims, cls) in seen["jax"].items():
        t_arr, t_dims, t_cls = seen["torch"][key]
        np.testing.assert_array_equal(t_arr, arr, err_msg=key)
        assert (t_dims, t_cls) == (dims, cls), key


def test_to_arviz_without_arviz(monkeypatch):
    from bumpcosmology_torch.utils import trace as tt

    monkeypatch.setitem(sys.modules, "arviz", None)
    with pytest.raises(ImportError, match="arviz is not installed"):
        tt.to_arviz(_trace(tt))


def test_n_det_is_accepted_and_builds_at_n_z():
    import jax

    from bumpcosmology_tpu.inference import likelihoods as jl
    from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data
    from bumpcosmology_torch import convert
    from bumpcosmology_torch.inference import likelihoods as tl
    from bumpcosmology_torch.inference.model import constrain, make_potential, prior_sample

    n_grid, n_z = 48, 64
    jdata = synthetic_pop_cosmo_data(nobs=6, nsamp=16, nsel=96, seed=3)
    data = convert.pop_cosmo_data(jdata, "cpu")
    theta = prior_sample(tl.pop_cosmo_model_spec(data, n_grid, n_z, device="cpu"),
                         torch.Generator().manual_seed(2), (3,))
    for spec_fn in (tl.pop_cosmo_model_spec, tl.plpeak_cosmo_model_spec, tl.brokenpl_cosmo_model_spec):
        base, with_n_det = (spec_fn(data, n_grid, n_z, device="cpu", **kw) for kw in ({}, {"n_det": 256}))
        th = prior_sample(base, torch.Generator().manual_seed(2), (3,))
        assert torch.equal(make_potential(base)(th), make_potential(with_n_det)(th))
    spec = tl.pop_cosmo_model_spec(data, n_grid, n_z, device="cpu")
    sites = constrain(spec, theta)
    bounds = tl.dl_bounds_of(data)
    got = tl.pop_cosmo_loglike(sites, data, n_grid, n_z, bounds, n_det=256)
    assert torch.equal(got, tl.pop_cosmo_loglike(sites, data, n_grid, n_z, bounds))
    for fam in ("plpeak", "brokenpl"):
        fn = getattr(tl, f"{fam}_cosmo_loglike")
        fam_spec = getattr(tl, f"{fam}_cosmo_model_spec")(data, n_grid, n_z, device="cpu")
        fam_sites = constrain(fam_spec, prior_sample(fam_spec, torch.Generator().manual_seed(4), (2,)))
        assert torch.equal(fn(fam_sites, data, n_grid, n_z, bounds, n_det=256),
                           fn(fam_sites, data, n_grid, n_z, bounds))
    jbounds = jl.dl_bounds_of(jdata)
    with jax.disable_jit():
        want = np.array([float(jl.pop_cosmo_loglike({k: v[c].numpy() for k, v in sites.items()}, jdata, n_grid,
                                                    n_z, jbounds, n_det=256)) for c in range(3)])
    assert np.all(np.abs(got.numpy() - want) / (1.0 + np.abs(want)) < 2e-4)


def test_mock_pop_cosmo_data_matches_jax():
    from bumpcosmology_tpu import benchdata as jb
    from bumpcosmology_torch import benchdata as tb

    kw = dict(nobs=3, nsamp=16, nsel=64, ndraw_campaign=40_000, threshold=15.0, seed=5)
    ref, got = jb.mock_pop_cosmo_data(**kw), tb.mock_pop_cosmo_data(**kw, device="cpu")
    for part in ("events", "selection"):
        for name in ("a", "q", "c", "log_pdraw"):
            r, g = np.asarray(getattr(getattr(ref, part), name)), getattr(getattr(got, part), name).numpy()
            assert g.shape == r.shape and g.dtype == r.dtype, (part, name)
            if part == "selection":  # the campaign's own draws, in float64 numpy in both packages
                np.testing.assert_array_equal(g, r, err_msg=f"{part}.{name}")
            elif name == "log_pdraw":  # the catalog's float32 population weight
                np.testing.assert_allclose(np.exp(g.astype(np.float64)), np.exp(r.astype(np.float64)), rtol=F32_POP)
            else:  # PE draws whose uncertainties scale as 1 / the float32 SNR (rtol 1e-5 between the packages)
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=0.0, err_msg=f"{part}.{name}")
    assert float(got.selection.log_ndraw) == float(ref.selection.log_ndraw)


F32_POP = 5e-5
