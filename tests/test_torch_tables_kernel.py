"""Kernel T (``csrc/tables.cu``, ``ops/cuda_tables.py``) on a host without a card.

* The joint log-likelihood of every family on the CPU, and its
  deterministics, build the cosmology and detector tables with the eager
  code, bit for bit: the kernel's wrapper is never reached there.
* The joint route's tables on the card take the detector table from the
  kernel and build no cosmology table.
* The wrapper raises ``ValueError`` on a tensor that is not on CUDA, not
  float32 or float64, not contiguous or not of the kernel's shape, and takes
  no other route for a well-formed CUDA tensor.
* The kernel's arithmetic (``csrc/tables_math.cuh``: a knot's entries, a
  node's brackets and columns, and the hand-derived chain rule of both),
  compiled for the host with the system's C++ compiler, against autograd of
  the eager twin.

The card's tests (``tests/test_torch_cuda.py``) hold the kernel itself.
"""
import ctypes
import math
import pathlib
import shutil
import subprocess

import pytest
import torch

from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference.model import ModelSpec, constrain, prior_sample
from bumpcosmology_torch.models import cosmology
from bumpcosmology_torch.models.cosmology import DEFAULT_ZMAX, build_cosmology, build_detector_table
from bumpcosmology_torch.models.parameters import CosmoParams
from bumpcosmology_torch.ops import cuda_tables
from bumpcosmology_torch.testing import synthetic_pop_cosmo_data

CSRC = pathlib.Path(__file__).resolve().parents[1] / "bumpcosmology_torch" / "csrc"
FAMILIES = ("bump", "plpeak", "brokenpl")


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a kernel wrapper sees of
    a tensor on the card, on a host that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _sites3(c=3, dtype=torch.float32):
    return {"h": torch.full((c,), 0.7, dtype=dtype), "Om": torch.full((c,), 0.3, dtype=dtype),
            "w": torch.full((c,), -1.0, dtype=dtype)}


def _launch(s, n=16, wrap=_OnCuda):
    return cuda_tables.detector_table(wrap(s["h"]), wrap(s["Om"]), wrap(s["w"]), n, 0.05, 12.0, DEFAULT_ZMAX)


@pytest.mark.parametrize("which", ["h", "Om", "w"])
@pytest.mark.parametrize("fault", ["non_contiguous", "float16", "shape", "other_dtype"])
def test_detector_table_raises_on_a_bad_cuda_argument(which, fault):
    s = _sites3()
    t = s[which]
    if fault == "non_contiguous":
        s[which] = torch.zeros(2 * t.shape[0])[::2]
        assert not s[which].is_contiguous()
    elif fault == "float16":
        s[which] = t.half()
    elif fault == "shape":  # a chain more, or a second axis
        s[which] = torch.zeros(t.shape[0] + 1) if which != "h" else t[:, None]
    else:  # float64 beside float32, or float32 beside a float64 h
        s = {k: (v.double() if (k == which) != (which == "h") else v) for k, v in s.items()}
    before = dict(cuda_tables.LAUNCHES)
    with pytest.raises(ValueError, match=which if fault != "other_dtype" or which != "h" else "Om"):
        _launch(s)
    assert cuda_tables.LAUNCHES == before


def test_detector_table_raises_on_cpu_tensors_and_a_short_table():
    s = _sites3()
    with pytest.raises(ValueError, match="CUDA"):
        _launch(s, wrap=lambda t: t)
    with pytest.raises(ValueError, match="two entries"):
        _launch(s, n=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_detector_table_goes_on_to_the_launch_for_well_formed_cuda_tensors(dtype):
    """Well-formed CUDA-typed sites of either type go on to the launch, which
    this host cannot make, so it raises, but not with a ``ValueError``;
    nothing is counted."""
    before = dict(cuda_tables.LAUNCHES)
    with pytest.raises(Exception) as err:
        _launch(_sites3(dtype=dtype))
    assert not isinstance(err.value, ValueError), err.value
    assert cuda_tables.LAUNCHES == before


def _data(dtype=torch.float32, seed=3, nobs=6, nsamp=32, nsel=200):
    data = synthetic_pop_cosmo_data(nobs, nsamp, nsel, seed=seed, device="cpu")
    return lk.PopCosmoData(*(type(x)(*(t.to(dtype) for t in x)) for x in (data.events, data.selection)))


def _family_sites(family, c, seed, dtype=torch.float32):
    spec = ModelSpec(priors=dict(lk.MASS_FAMILIES[family].cosmo_priors), loglike=None, device=torch.device("cpu"))
    theta = prior_sample(spec, torch.Generator().manual_seed(seed), shape=(c,)).to(dtype)
    return {k: v.detach().requires_grad_(True) for k, v in constrain(spec, theta).items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_the_cpu_route_builds_the_tables_with_the_eager_code_bit_for_bit(family, monkeypatch):
    """On the CPU the joint log-likelihood, its gradient and the
    deterministics of every family are those of the eager tables
    (``build_cosmology``, ``build_detector_table``) bit for bit, and kernel T's
    wrapper is not reached."""
    monkeypatch.setattr(lk, "kernel_detector_table", lambda *a, **k: pytest.fail("kernel T reached on the CPU"))
    fam = lk.MASS_FAMILIES[family]
    data = _data()
    bounds, qry = lk.dl_bounds_of(data), lk.query_table(data)
    nobs, nsamp = data.events.a.shape
    sites = _family_sites(family, 3, 5)
    got = lk.pop_cosmo_loglike(sites, data, 48, 96, bounds, qry, build=fam.build)
    family_obj = lk._family(fam.build)
    pop = family_obj(sites, 48)
    det = build_detector_table(build_cosmology(lk.cosmo_from_sites(sites), n=96), *bounds, n=96)
    lse_ev, lse_sel = family_obj.lse(pop, det, qry, nobs, nsamp, False)
    ref = lse_ev.sum(-1) - nobs * math.log(nsamp) - nobs * (lse_sel - data.selection.log_ndraw)
    assert torch.equal(got, ref)
    names = sorted(sites)
    g_got = torch.autograd.grad(got.sum(), [sites[k] for k in names], allow_unused=True)
    g_ref = torch.autograd.grad(ref.sum(), [sites[k] for k in names], allow_unused=True)
    for k, x, y in zip(names, g_got, g_ref):
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), k
    with torch.no_grad():
        det_out = lk.pop_cosmo_deterministics(sites, data, 48, 96, bounds, qry, build=fam.build)
        _, cosmo, log_w, log_sel_w = lk.pop_cosmo_event_sel_logwts(sites, data, 48, 96, bounds, qry,
                                                                   build=fam.build)
        table = build_cosmology(lk.cosmo_from_sites(sites), n=96)
    for a, b in zip(cosmo[3:], table[3:]):
        assert torch.equal(a, b)
    assert torch.equal(det_out["neff_sel"], lk.selection_neff_terms(log_sel_w, data.selection.log_ndraw)[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_the_kernel_route_takes_the_detector_table_from_kernel_t(family, monkeypatch):
    """On the kernels' route the tables' detector table is kernel T's, asked
    for once with the sites, the bounds and ``n_z``; no cosmology table is
    built; the intensity is the eager route's without its pivot."""
    calls = []

    def kernel_t(params, dl_lo, dl_hi, n):
        calls.append((params, dl_lo, dl_hi, n))
        return build_detector_table(build_cosmology(params, n=n), dl_lo, dl_hi, n=n)

    monkeypatch.setattr(lk, "kernel_detector_table", kernel_t)
    monkeypatch.setattr(lk, "build_cosmology", lambda *a, **k: pytest.fail("a cosmology table on the kernels' route"))
    fam = lk._family(lk.MASS_FAMILIES[family].build)
    data = _data()
    bounds = lk.dl_bounds_of(data)
    sites = _family_sites(family, 3, 5)
    pop, cosmo, det = fam.tables(sites, 48, 96, bounds, kernel=True)
    assert cosmo is None and len(calls) == 1
    params, dl_lo, dl_hi, n = calls[0]
    assert (dl_lo, dl_hi, n) == (*bounds, 96)
    assert all(x is sites[k] for x, k in zip(params, ("h", "Om", "w")))
    monkeypatch.undo()
    full, _, det_eager = fam.tables(sites, 48, 96, bounds)
    assert torch.equal(det.cols, det_eager.cols) and (det.v0, det.dv) == (det_eager.v0, det_eager.dv)
    if family != "bump":
        assert torch.equal(pop.log_norm, torch.zeros_like(full.log_norm))


def test_kernel_detector_table_keeps_the_eager_grid():
    """The table's grid (``v0``, ``dv``) and the numbers handed to the kernel
    are the eager table code's."""
    n, lo, hi = 96, 0.037, 13.5
    eager = build_detector_table(build_cosmology(CosmoParams(*_sites3().values()), n=n), lo, hi, n=n)
    u_end, du, v0, v1 = cuda_tables._grid(n, lo, hi, DEFAULT_ZMAX)
    assert (v0, (v1 - v0) / (n - 1)) == (eager.v0, eager.dv)
    assert (u_end, du) == (math.log1p(DEFAULT_ZMAX), build_cosmology(CosmoParams(*_sites3().values()), n=n).du)


def test_kernel_detector_table_hands_the_kernel_contiguous_sites(monkeypatch):
    """Sites cut as strided views from one tensor (a batch of sites, as the
    score check makes them) reach the kernel's wrapper contiguous, with the
    same values; contiguous sites reach it as they are."""
    seen = []

    def record(h, om, w, n, dl_lo, dl_hi, zmax):
        seen.append((h, om, w))
        return torch.zeros((h.shape[0], n, 2))

    monkeypatch.setattr(cuda_tables, "detector_table", record)
    table = torch.tensor([[0.7, 0.3, -1.0, 5.0], [0.6, 0.4, -0.9, 6.0]])
    strided = CosmoParams(table[:, 0], table[:, 1], table[:, 2])
    assert not strided.h.is_contiguous()
    det = cosmology.kernel_detector_table(strided, 0.05, 12.0, n=16)
    assert det.cols.shape == (2, 16, 2)
    assert all(x.is_contiguous() and torch.equal(x, y) for x, y in zip(seen[0], strided))
    flat = CosmoParams(*(x.contiguous() for x in strided))
    cosmology.kernel_detector_table(flat, 0.05, 12.0, n=16)
    assert all(x is y for x, y in zip(seen[1], flat))


# ---------------------------------------------------------------------------
# The kernel's arithmetic, compiled for the host
# ---------------------------------------------------------------------------

_HARNESS = r"""
#include <vector>
#include "tables_math.cuh"
using namespace tab;

// Every chain's detector table and its chain rule, as the kernel evaluates each knot and node, on the
// knots' grid u and the nodes' v (n each).  The sums are taken in double (the prefix sum, a knot's nodes,
// the suffix sum and the sites' sums), so that what is compared is each knot's and node's arithmetic,
// not the order of a long float sum.
template <typename T>
static void run(int C, int n, const T* h, const T* om, const T* w, const T* u, const T* v, double du,
                const T* g, T* out, T* d_sites) {
  const T inv_du = T(1) / (T)du;
  std::vector<Knot<T>> q(n);
  std::vector<T> I(n), dl(n), dvc(n), ddl(n);
  for (int c = 0; c < C; ++c) {
    const Chain<T> k = chain_init(h[c], om[c], w[c]);
    for (int i = 0; i < n; ++i) q[i] = knot(k, u[i]);
    double acc = 0.0;
    I[0] = T(0);
    for (int j = 0; j + 1 < n; ++j) {
      acc += (double)segment(q[j], q[j + 1]);
      I[j + 1] = (T)acc;
    }
    for (int i = 0; i < n; ++i) {
      const Entries<T> e = entries(k, q[i], I[i]);
      dl[i] = e.dl; dvc[i] = e.dvc; ddl[i] = e.ddl;
    }
    std::vector<double> gdl(n, 0.0), gdvc(n, 0.0), gddl(n, 0.0);
    for (int m = 0; m < n; ++m) {
      const T x = Fn<T>::exp(v[m]);
      const int lo = dl_bracket(dl.data(), n, x);
      Node<T> r;
      node_z(r, x, dl.data(), lo, q[lo].z, q[lo + 1].z, inv_du, n);
      node_jac(r, dvc[r.lo2], dvc[r.lo2 + 1], ddl[r.lo2], ddl[r.lo2 + 1]);
      T* o = out + ((size_t)c * n + m) * 2;
      o[0] = r.zk; o[1] = r.lj;
      const T* gm = g + ((size_t)c * n + m) * 2;
      const NodeGrad<T> d = node_grad(r, gm[0], gm[1], inv_du);
      gdl[lo] += d.dl0; gdl[lo + 1] += d.dl1;
      gdvc[r.lo2] += d.dvc0; gdvc[r.lo2 + 1] += d.dvc1;
      gddl[r.lo2] += d.ddl0; gddl[r.lo2 + 1] += d.ddl1;
    }
    std::vector<double> gi(n), gie(n), gseg(n);
    double sdh = 0.0;
    for (int i = 0; i < n; ++i) {
      const KnotGrad<T> r = knot_grad(k, q[i], I[i], (T)gdl[i], (T)gdvc[i], (T)gddl[i]);
      gi[i] = r.gi; gie[i] = r.gie; sdh += r.gdh;
    }
    double s = 0.0;
    for (int j = n - 2; j >= 0; --j) {
      s += gi[j + 1];
      gseg[j] = s;
    }
    double som = 0.0, somm = 0.0, se = 0.0;
    for (int i = 0; i < n; ++i) {
      double ge = gie[i];
      if (i < n - 1) ge += segment_grad(q[i], q[i + 1], (T)gseg[i]);
      if (i > 0) ge += segment_grad(q[i - 1], q[i], (T)gseg[i - 1]);
      const EGrad<T> r = efunc_grad(k, q[i], (T)ge);
      som += r.gom; somm += r.gomm; se += r.ge;
    }
    T o[3];
    site_grad(k, (T)sdh, (T)som, (T)somm, (T)se, o);
    for (int i = 0; i < 3; ++i) d_sites[(size_t)i * C + c] = o[i];
  }
}

#define EXPORT(T, name)                                                                                   \
  extern "C" void name(int C, int n, const T* h, const T* om, const T* w, const T* u, const T* v, double du, \
                       const T* g, T* out, T* d_sites) {                                                  \
    run<T>(C, n, h, om, w, u, v, du, g, out, d_sites);                                                    \
  }
EXPORT(float, tables_f32)
EXPORT(double, tables_f64)
"""


@pytest.fixture(scope="module")
def host_tables(tmp_path_factory):
    """The host build of ``csrc/tables_math.cuh`` behind ``tables_f32`` and ``tables_f64``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("tables_host")
    (d / "tables.cpp").write_text(_HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{CSRC}",
                    "-o", str(d / "libtables.so"), str(d / "tables.cpp")], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(d / "libtables.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("tables_f32", "tables_f64"):
        getattr(lib, name).argtypes = [i, i, p, p, p, p, p, f, p, p, p]
    return lib


def _host(lib, sites, n, dl_lo, dl_hi, g):
    """``(cols (C, n, 2), d_sites (3, C))`` of the host build at ``sites`` ``(h, Om, w)`` in their type."""
    dtype = sites[0].dtype
    c = sites[0].shape[0]
    u = torch.linspace(0.0, math.log1p(DEFAULT_ZMAX), n, dtype=dtype)
    v = torch.linspace(math.log(dl_lo), math.log(dl_hi), n, dtype=dtype)
    out, d = torch.zeros((c, n, 2), dtype=dtype), torch.zeros((3, c), dtype=dtype)
    args = [x.contiguous() for x in (*sites, u, v)]
    fn = lib.tables_f32 if dtype == torch.float32 else lib.tables_f64
    g = g.contiguous()
    fn(c, n, *(x.data_ptr() for x in args), math.log1p(DEFAULT_ZMAX) / (n - 1), g.data_ptr(), out.data_ptr(),
       d.data_ptr())
    return out, d


def _twin(sites, n, dl_lo, dl_hi, g):
    """The same by autograd of the eager table code."""
    leaves = [x.detach().clone().requires_grad_(True) for x in sites]
    cols = build_detector_table(build_cosmology(CosmoParams(*leaves), n=n), dl_lo, dl_hi, n=n).cols
    grads = torch.autograd.grad((cols * g).sum(), leaves)
    return cols.detach(), torch.stack(grads)


def _gap(a, b):
    """The largest |a - b| / (1 + |b|) over the entries, NaN where one is NaN and the other not."""
    a, b = a.double(), b.double()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return math.nan
    fin = ~torch.isnan(b)
    return float(((a[fin] - b[fin]).abs() / (1 + b[fin].abs())).max()) if bool(fin.any()) else 0.0


EDGES = {"h": (0.3501, 1.3999, 0.3501, 1.3999), "Om": (1e-4, 0.9999, 0.9999, 1e-4),
         "w": (-1.4999, -0.5001, -0.5001, -1.4999)}


def _cosmo_sites(kind, c, dtype):
    """(h, Om, w) ``(c,)`` each: prior draws, the priors' edges, or (``nan``) one NaN site a chain."""
    if kind == "edges":
        return tuple(torch.tensor(EDGES[k][:c], dtype=dtype) for k in ("h", "Om", "w"))
    spec = ModelSpec(priors={k: lk.POP_COSMO_PRIORS[k] for k in ("h", "Om", "w")}, loglike=None,
                     device=torch.device("cpu"))
    theta = prior_sample(spec, torch.Generator().manual_seed(7), shape=(c,)).double()
    s = [x.to(dtype) for x in constrain(spec, theta).values()]
    if kind == "nan":
        for i in range(min(c, 3)):
            s[i][i] = math.nan
    return tuple(s)


def _g(c, n, dtype, seed=11):
    return torch.randn((c, n, 2), generator=torch.Generator().manual_seed(seed), dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("kind", ["prior", "edges"])
@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("c", [1, 4])
def test_the_kernel_arithmetic_on_the_host_matches_autograd(host_tables, kind, n, c):
    """The detector table and the cotangents of ``h``, ``Om`` and ``w`` that
    the hand-derived chain rule gives for a random cotangent of the table,
    against autograd of the eager table code, at prior draws and at the edges
    of the priors: in float64 within 1e-10 of 1 + |autograd's|; in float32 as
    close to float64's autograd as the twin's own float32 autograd comes,
    within four times its gap."""
    dl_lo, dl_hi = lk.dl_bounds_of(_data())
    s64 = _cosmo_sites(kind, c, torch.float64)
    g64 = _g(c, n, torch.float64)
    host = _host(host_tables, s64, n, dl_lo, dl_hi, g64)
    auto = _twin(s64, n, dl_lo, dl_hi, g64)
    for a, b in zip(host, auto):
        assert _gap(a, b) < 1e-10
    s32 = tuple(x.float() for x in s64)
    g32 = g64.float()
    host32 = _host(host_tables, s32, n, dl_lo, dl_hi, g32)
    auto32 = _twin(s32, n, dl_lo, dl_hi, g32)
    truth = _twin(tuple(x.double() for x in s32), n, dl_lo, dl_hi, g32.double())
    for name, a, b, t in zip(("table", "sites"), host32, auto32, truth):
        assert _gap(a, t) <= 4 * _gap(b, t), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_kernel_arithmetic_on_the_host_at_nan_sites(host_tables, dtype):
    """A NaN site (h, Om or w in one chain each) gives the twin's table and
    cotangents: NaN where the twin's are, equal elsewhere to the limits of
    the test above."""
    dl_lo, dl_hi = lk.dl_bounds_of(_data())
    s = _cosmo_sites("nan", 4, dtype)
    g = _g(4, 64, dtype)
    host, auto = _host(host_tables, s, 64, dl_lo, dl_hi, g), _twin(s, 64, dl_lo, dl_hi, g)
    assert bool(torch.isnan(auto[0][:3, :, 1]).all()) and not bool(torch.isnan(auto[0][3]).any())
    for a, b in zip(host, auto):
        assert _gap(a, b) < (1e-10 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_kernel_arithmetic_on_the_host_at_the_log_jacobian_floor(host_tables, dtype):
    """A ``dl_lo`` whose node lands at z = 0, where dVc/dz is 0 and
    ``log_jac`` takes its floor of -1e4: the twin's table, and its
    cotangents (NaN, from log 0's derivative, as autograd gives them).  The
    nodes after it, whose redshifts are subnormal, are held to the twin's
    NaNs alone: there an ulp of the lookup's position (a product by 1 / du on
    the card, as PyTorch's CUDA division by a scalar rounds it, a division on
    the CPU) is a large part of the number."""
    dl_lo = 5e-324 if dtype == torch.float64 else 1e-46
    s = _cosmo_sites("prior", 4, dtype)
    g = _g(4, 64, dtype)
    host, auto = _host(host_tables, s, 64, dl_lo, 12.0, g), _twin(s, 64, dl_lo, 12.0, g)
    assert bool((auto[0][:, 0, 1] == -1e4).all()) and bool((host[0][:, 0, 1] == -1e4).all())
    normal = (auto[0][..., 0] == 0) | (auto[0][..., 0].abs() >= torch.finfo(dtype).tiny)
    assert not bool(normal.all())
    limit = 1e-10 if dtype == torch.float64 else 1e-5
    assert torch.equal(torch.isnan(host[0]), torch.isnan(auto[0])) and _gap(host[0][normal], auto[0][normal]) < limit
    assert _gap(host[1], auto[1]) < limit


def test_a_chain_does_not_depend_on_the_other_chains(host_tables):
    """A chain's table and cotangents, bit for bit, alone and among others."""
    s = _cosmo_sites("prior", 4, torch.float32)
    g = _g(4, 64, torch.float32)
    full = _host(host_tables, s, 64, 0.05, 12.0, g)
    for idx in ([2], [0, 3], [3, 1]):
        part = _host(host_tables, tuple(x[idx] for x in s), 64, 0.05, 12.0, g[idx])
        assert torch.equal(part[0], full[0][idx]) and torch.equal(part[1], full[1][:, idx])
