"""Kernel F (``csrc/families.cu``, ``ops/cuda_families.py``) on a host without a card.

* The joint log-likelihood of POWER-LAW+PEAK, BROKEN POWER LAW and POWER LAW +
  SPLINE on the CPU
  is the eager code, bit for bit, value and gradient: the kernel's wrapper is
  never reached there.
* The wrapper raises ``ValueError`` on a tensor that is not on CUDA, not
  float32 or float64, not contiguous or not of the kernel's shape, and takes
  no other route for a well-formed CUDA tensor.
* The kernel's arithmetic (``csrc/families_math.cuh``: a row's weight, the
  pivot and the hand-derived chain rule), compiled for the host with the
  system's C++ compiler, against autograd of the eager twin.

The card's tests (``tests/test_torch_cuda.py``) hold the kernel itself.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import pytest
import torch

from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference.model import ModelSpec, constrain, prior_sample
from bumpcosmology_torch.models import brokenpl, plpeak, pspline
from bumpcosmology_torch.models.cosmology import DetectorFrameTable, build_cosmology, build_detector_table
from bumpcosmology_torch.models.parameters import RedshiftParams
from bumpcosmology_torch.ops import cuda_families
from bumpcosmology_torch.testing import synthetic_pop_cosmo_data

CSRC = pathlib.Path(__file__).resolve().parents[1] / "bumpcosmology_torch" / "csrc"
FAMILIES = ("plpeak", "brokenpl", "pspline")


class _OnCuda:
    """A CPU tensor that reports a CUDA device: what a kernel wrapper sees of
    a tensor on the card, on a host that has none."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _args(c=2, k=8, n_m=6, nobs=3, nsamp=4, nsel=5, dtype=torch.float32):
    n = nobs * nsamp + nsel
    return dict(det=torch.zeros(c, k, 2, dtype=dtype), nq=torch.zeros(c, n_m, dtype=dtype),
                scal=torch.zeros(c, 11, dtype=dtype), qry=torch.zeros(n, 4, dtype=dtype)), nobs, nsamp


def _launch(args, nobs, nsamp, wrap=_OnCuda):
    det = DetectorFrameTable(params=None, v0=0.0, dv=0.1, cols=wrap(args["det"]))
    return cuda_families.family_lse("plpeak", det, wrap(args["nq"]), 0.5, wrap(args["scal"]), wrap(args["qry"]),
                                    nobs, nsamp)


@pytest.mark.parametrize("which", ["det", "nq", "scal", "qry"])
@pytest.mark.parametrize("fault", ["non_contiguous", "float16", "shape", "other_dtype"])
def test_family_lse_raises_on_a_bad_cuda_argument(which, fault):
    args, nobs, nsamp = _args()
    t = args[which]
    if fault == "non_contiguous":
        args[which] = torch.zeros(*t.shape[:-1], 2 * t.shape[-1])[..., ::2]
        assert not args[which].is_contiguous()
    elif fault == "float16":
        args[which] = t.half()
    elif fault == "shape":  # a chain more (the q-norm table's length is free), or a column more
        args[which] = torch.zeros(t.shape[0] + 1, *t.shape[1:]) if which == "nq" else \
            torch.zeros(*t.shape[:-1], t.shape[-1] + 1)
    else:  # float64 beside float32, or float32 beside a float64 det
        args = {k: (v.double() if (k == which) != (which == "det") else v) for k, v in args.items()}
    before = dict(cuda_families.LAUNCHES)
    with pytest.raises(ValueError, match=which if fault != "other_dtype" or which != "det" else "nq"):
        _launch(args, nobs, nsamp)
    assert cuda_families.LAUNCHES == before


def test_family_lse_raises_on_cpu_tensors_and_bad_segments():
    args, nobs, nsamp = _args()
    with pytest.raises(ValueError, match="CUDA"):
        _launch(args, nobs, nsamp, wrap=lambda t: t)
    with pytest.raises(ValueError, match="do not fit"):
        _launch(args, nobs, nsamp + 3)
    det = DetectorFrameTable(params=None, v0=0.0, dv=0.1, cols=_OnCuda(args["det"]))
    with pytest.raises(ValueError, match="family"):
        cuda_families.family_lse("bump", det, _OnCuda(args["nq"]), 0.5, _OnCuda(args["scal"]), _OnCuda(args["qry"]),
                                 nobs, nsamp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["shared", "per_chain"])
def test_family_lse_goes_on_to_the_launch_for_well_formed_cuda_tensors(dtype, layout):
    """Well-formed CUDA-typed arguments of either type and layout go on to
    the launch, which this host cannot make, so it raises, but not with a
    ``ValueError``; nothing is counted."""
    args, nobs, nsamp = _args(dtype=dtype)
    if layout == "per_chain":
        args["qry"] = args["qry"].expand(2, -1, -1).contiguous()
    before = dict(cuda_families.LAUNCHES)
    with pytest.raises(Exception) as err:
        _launch(args, nobs, nsamp)
    assert not isinstance(err.value, ValueError), err.value
    assert cuda_families.LAUNCHES == before


def test_slots_and_codes_match_the_kernel_header():
    text = (CSRC / "families_math.cuh").read_text()
    slots = re.search(r"enum Slot \{([^}]*)\}", text).group(1).replace(" ", "").split(",")
    assert slots[-1] == "NS" and len(slots) - 1 == cuda_families._NS
    assert all(len(s) == cuda_families._NS for s in cuda_families.SLOTS.values())
    codes = dict(re.findall(r"(\w+) = (\d+)", re.search(r"enum Family \{([^}]*)\}", text).group(1)))
    assert {k.lower(): int(v) for k, v in codes.items()} == cuda_families.FAMILIES
    # the shared slots are the same sites in every family
    assert cuda_families.SLOTS["plpeak"][:7] == cuda_families.SLOTS["brokenpl"][:7] == cuda_families.SLOTS["pspline"][:7]
    # the spline's knots, spacing and table are models/pspline.py's
    const = dict(re.findall(r"constexpr (?:int|double) (SPL_\w+) = ([^;]+);", text))
    assert int(const["SPL_KNOTS"]) == pspline.N_KNOTS and cuda_families.SPLINE_SHAPE == (pspline.N_KNOTS - 1, 4)
    assert float(const["SPL_X0"]) == pspline.X0 and float(const["SPL_H"]) == pspline.H


def _data(dtype, seed=3, nobs=6, nsamp=32, nsel=200):
    data = synthetic_pop_cosmo_data(nobs, nsamp, nsel, seed=seed, device="cpu")
    return lk.PopCosmoData(*(type(x)(*(t.to(dtype) for t in x)) for x in (data.events, data.selection)))


def _sites(family, c, seed, dtype):
    spec = ModelSpec(priors=dict(lk.MASS_FAMILIES[family].cosmo_priors), loglike=None, device=torch.device("cpu"))
    theta = prior_sample(spec, torch.Generator().manual_seed(seed), shape=(c,)).to(dtype)
    return {k: v.detach().requires_grad_(True) for k, v in constrain(spec, theta).items()}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layout", ["shared", "fleet"])
def test_the_cpu_route_is_the_eager_code_bit_for_bit(family, layout, monkeypatch):
    """On the CPU the families' segment log-sum-exps and their gradient are
    ``torch.logsumexp`` of ``_cosmo_frame_logwts_fused`` over the family's
    intensity, bit for bit, and the kernel's wrapper is not reached."""
    monkeypatch.setattr(lk, "family_lse", lambda *a, **k: pytest.fail("kernel F reached on the CPU"))
    build = lk.MASS_FAMILIES[family].build
    cats = [_data(torch.float32, seed=3 + s) for s in range(3)]
    data = lk.stack_fleet(cats) if layout == "fleet" else cats[0]
    bounds, qry = lk.dl_bounds_of(data), lk.query_table(data)
    nobs, nsamp = data.events.a.shape[-2:]
    sites = _sites(family, 3, 5, torch.float32)
    got = lk.pop_cosmo_segment_lse(sites, data, 48, 96, bounds, qry, build=build)
    pop = build(sites, 48)
    det = build_detector_table(build_cosmology(lk.cosmo_from_sites(sites), n=96), *bounds, n=96)
    log_w = lk._cosmo_frame_logwts_fused(pop, det, qry)
    ref = (torch.logsumexp(log_w[:, :nobs * nsamp].reshape(-1, nobs, nsamp), -1),
           torch.logsumexp(log_w[:, nobs * nsamp:], -1))
    names = sorted(sites)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    g_got = torch.autograd.grad(got[0].sum() + got[1].sum(), [sites[k] for k in names], allow_unused=True)
    g_ref = torch.autograd.grad(ref[0].sum() + ref[1].sum(), [sites[k] for k in names], allow_unused=True)
    for k, x, y in zip(names, g_got, g_ref):
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), k


@pytest.mark.parametrize("family", FAMILIES)
def test_the_kernel_route_builds_the_tables_without_the_pivot(family, monkeypatch):
    """F's route builds the family's q-norm table as the eager route does,
    and leaves the pivot (``log_norm``) at 0 for F to compute; its detector
    table is kernel T's (here the eager table code in its place); the family's
    ``build`` names its code in the kernel."""
    build = lk.MASS_FAMILIES[family].build
    assert build.name == family and family in cuda_families.FAMILIES
    data = _data(torch.float32)
    sites = _sites(family, 3, 5, torch.float32)
    bounds = lk.dl_bounds_of(data)
    full, _, det = build.tables(sites, 48, 96, bounds)
    monkeypatch.setattr(lk, "kernel_detector_table", lambda params, lo, hi, n: build_detector_table(
        build_cosmology(params, n=n), lo, hi, n=n))
    bare, _, det_bare = build.tables(sites, 48, 96, bounds, kernel=True)
    assert bare.dm == full.dm and torch.equal(bare.log_nq, full.log_nq) and torch.equal(det_bare.cols, det.cols)
    assert torch.equal(bare.log_norm, torch.zeros_like(full.log_norm))
    assert bool(torch.isfinite(full.log_norm).all()) and not torch.equal(full.log_norm, bare.log_norm)


# ---------------------------------------------------------------------------
# The kernel's arithmetic, compiled for the host
# ---------------------------------------------------------------------------

_HARNESS = r"""
#include "families_math.cuh"
using namespace fam;

// Every row of every chain, as the kernel evaluates it, and the chain rule of each with the cotangent
// g; the pivot's backward and the sites' cotangents from the rows' sums.  The sums are taken in double
// (the kernel's accumulators take few rows a thread and its table bins are exact), so that what is
// compared is each row's arithmetic, not the order of a long float sum.
template <typename T, int FAM>
static void run(const T* s, const T* det, int K, double v0, double dv, const T* nq, int n_m, double dmq,
                const T* spl, const T* qry, int N, int C, const T* g, T* out, double* d_det, double* d_nq,
                double* d_spl, T* d_s, T* log_norm) {
  for (int c = 0; c < C; ++c) {
    Chain<T> k;
    const T* nqc = nq + (size_t)c * n_m;
    chain_init<T, FAM>(k, s + (size_t)c * NS, nqc, n_m, (T)dmq, spl + (size_t)c * SPL_COEFS);
    log_norm[c] = k.log_norm;
    double tot[NACC] = {};
    double* dd = d_det + (size_t)c * K * 2;
    double* dn = d_nq + (size_t)c * n_m;
    double* dsp = d_spl + (size_t)c * SPL_COEFS;
    for (int n = 0; n < N; ++n) {
      const T* q = qry + (size_t)n * 4;
      Row<T, FAM> r;
      r.eval(k, q[0], q[1], q[2], q[3], det + (size_t)c * K * 2, K, (T)v0, (T)dv, nqc, n_m, (T)dmq);
      out[(size_t)c * N + n] = r.out;
      T acc[NACC] = {};
      RowAdd<T> a;
      r.grad(k, g[(size_t)c * N + n], nqc, n_m, (T)dmq, acc, a);
      for (int i = 0; i < NACC; ++i) tot[i] += acc[i];
      dd[2 * a.det_lo] += a.dz0; dd[2 * a.det_lo + 2] += a.dz1;
      dd[2 * a.det_lo + 1] += a.dj0; dd[2 * a.det_lo + 3] += a.dj1;
      dn[a.nq_lo] += a.n0; dn[a.nq_lo + 1] += a.n1;
      if (a.spl.lo >= 0) for (int j = 0; j < 4; ++j) dsp[4 * a.spl.lo + j] += a.spl.c[j];
    }
    T acc[NACC];
    for (int i = 0; i < NACC; ++i) acc[i] = (T)tot[i];
    int lo; T na, nb;
    SplAdd<T> sa;
    pivot_grad<T, FAM>(k, nqc, n_m, (T)dmq, acc, lo, na, nb, sa);
    dn[lo] += na; dn[lo + 1] += nb;
    if (sa.lo >= 0) for (int j = 0; j < 4; ++j) dsp[4 * sa.lo + j] += sa.c[j];
    finalize<T, FAM>(k, acc, d_s + (size_t)c * NS);
  }
}

#define EXPORT(T, name)                                                                                     \
  extern "C" void name(int fam, const T* s, const T* det, int K, double v0, double dv, const T* nq, int n_m, \
                       double dmq, const T* spl, const T* qry, int N, int C, const T* g, T* out, double* d_det, \
                       double* d_nq, double* d_spl, T* d_s, T* log_norm) {                                  \
    (fam == 0 ? run<T, PLPEAK> : fam == 1 ? run<T, BROKENPL> : run<T, PSPLINE>)(                             \
        s, det, K, v0, dv, nq, n_m, dmq, spl, qry, N, C, g, out, d_det, d_nq, d_spl, d_s, log_norm);          \
  }
EXPORT(float, rows_f32)
EXPORT(double, rows_f64)
"""


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """The host build of ``csrc/families_math.cuh`` behind ``rows_f32`` and ``rows_f64``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the kernel's arithmetic for the host")
    d = tmp_path_factory.mktemp("families_host")
    (d / "rows.cpp").write_text(_HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{CSRC}",
                    "-o", str(d / "librows.so"), str(d / "rows.cpp")], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(d / "librows.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("rows_f32", "rows_f64"):
        getattr(lib, name).argtypes = [i, p, p, i, f, f, p, i, f, p, p, i, i, p, p, p, p, p, p, p]
    return lib


EDGES = {  # cardbench/tests/test_cardbench_plpeak.py's sites on the model's edges
    "alpha": (2.5, 11.9, 1.0 - 1e-13, -3.9), "beta_q": (1.0, -3.9, 0.0, 11.9), "mmin": (8.0, 9.5, 2.1, 5.0),
    "mmax": (30.05, 99.9, 60.0, 45.0), "lam_peak": (0.3, 0.001, 0.5, 0.99), "mu_m": (45.0, 21.0, 35.0, 20.2),
    "sigma_m": (8.0, 9.9, 3.0, 1.01), "delta_m": (0.05, 9.95, 4.0, 0.001), "lam": (2.7, -1.2, 6.6, 0.0),
    "zp": (1.9, 0.05, 3.8, 1.0), "h": (0.7, 0.36, 1.39, 0.68), "Om": (0.3, 0.02, 0.95, 0.31),
    "w": (-1.0, -1.45, -0.55, -0.9), "dkappa": (3.0, 1.1, 6.8, 2.0),
    # POWER LAW + SPLINE's heights at +-3 and in between, alternating from knot to knot in the last chain
    **{f"f_{i}": (3.0, -3.0, 0.5 * (i % 5) - 1.0, 3.0 * (-1) ** i) for i in range(1, 19)},
}

_INTENSITY = {"plpeak": plpeak.PLPeakIntensity, "brokenpl": brokenpl.BrokenPLIntensity,
              "pspline": pspline.PSplineIntensity}
_MASS = {"plpeak": plpeak.PLPeakMassParams, "brokenpl": brokenpl.BrokenPLMassParams,
         "pspline": pspline.PSplineMassParams}
_POP = {"plpeak": plpeak.PLPeakPopulationParams, "brokenpl": brokenpl.BrokenPLPopulationParams,
        "pspline": pspline.PSplinePopulationParams}


def _host_and_autograd(lib, family, dtype, sites, n_grid=64, n_z=128, data=None):
    """({output: host build's}, {output: autograd's}) in ``dtype``: every row's
    weight, the pivot, and the cotangents of the detector table, the q-norm
    table, POWER LAW + SPLINE's coefficient table and each site for one
    random positive row cotangent."""
    c = sites["mmin"].shape[0]
    sites = {k: v.to(dtype) for k, v in sites.items()}
    data = _data(dtype) if data is None else lk.PopCosmoData(*(type(x)(*(t.to(dtype) for t in x))
                                                               for x in (data.events, data.selection)))
    bounds, qry = lk.dl_bounds_of(data), lk.query_table(data)
    with torch.no_grad():
        det = build_detector_table(build_cosmology(lk.cosmo_from_sites(sites), n=n_z), *bounds, n=n_z)
    slots = cuda_families.SLOTS[family]
    leaves = {k: (sites["lam"] + sites["dkappa"] if k == "kappa" else sites[k]).detach().clone().requires_grad_(True)
              for k in slots if k}
    red = RedshiftParams(leaves["lam"], leaves["kappa"], leaves["zp"])
    mass_t, extra = _MASS[family], {}
    if family == "pspline":  # the coefficient table is the kernel's input: a leaf here, made from the heights
        with torch.no_grad():
            coef = pspline.spline_coefficients(lk.pspline_from_sites(sites).mass.heights)
        extra = dict(coef=coef.clone().requires_grad_(True))
    fields = [k for k in mass_t._fields if k != "heights"]
    params = _POP[family](mass_t(*(leaves[k] for k in fields), **({"heights": None} if extra else {})), red)
    with torch.no_grad():
        dm, log_nq = plpeak._log_nq_grid(leaves["beta_q"], leaves["mmin"], leaves["delta_m"], n_grid, 128)
    nq = log_nq.clone().requires_grad_(True)
    cols = det.cols.clone().requires_grad_(True)
    pop = _INTENSITY[family](params=params, dm=dm, log_nq=nq, log_norm=torch.zeros_like(leaves["mmin"]), **extra)
    pop = pop._replace(log_norm=plpeak._pivot_log_norm(pop))
    out = lk._cosmo_frame_logwts_fused(pop, DetectorFrameTable(det.params, det.v0, det.dv, cols), qry)
    # a row cotangent of one sign, as the lse route's g_seg exp(w - lse_seg) within a segment
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(11), dtype=torch.float64).to(dtype)
    names = [k for k in slots if k]
    tables = [cols, nq] + list(extra.values())
    grads = torch.autograd.grad((out * g).sum(), [leaves[k] for k in names] + tables)
    auto = dict(out=out.detach(), log_norm=pop.log_norm.detach(), det=grads[len(names)], nq=grads[len(names) + 1],
                **{k: grads[i] for i, k in enumerate(names)})
    if extra:
        auto["spline"] = grads[-1]

    s = cuda_families.family_scalars(family, params.mass, red).detach().contiguous()
    n = qry.shape[0]
    spl = (extra["coef"].detach() if extra else torch.zeros((c, *cuda_families.SPLINE_SHAPE))).to(dtype).contiguous()
    h = dict(out=torch.zeros((c, n), dtype=dtype), det=torch.zeros_like(det.cols, dtype=torch.float64),
             nq=torch.zeros_like(log_nq, dtype=torch.float64), spline=torch.zeros_like(spl, dtype=torch.float64),
             s=torch.zeros_like(s), log_norm=torch.zeros(c, dtype=dtype))
    fn = lib.rows_f32 if dtype == torch.float32 else lib.rows_f64
    det_c, nq_c, qry_c = det.cols.contiguous(), log_nq.contiguous(), qry.contiguous()
    fn(cuda_families.FAMILIES[family], s.data_ptr(), det_c.data_ptr(), n_z, det.v0, det.dv, nq_c.data_ptr(), n_grid,
       dm, spl.data_ptr(), qry_c.data_ptr(), n, c, g.contiguous().data_ptr(), h["out"].data_ptr(), h["det"].data_ptr(),
       h["nq"].data_ptr(), h["spline"].data_ptr(), h["s"].data_ptr(), h["log_norm"].data_ptr())
    host = {k: h[k] for k in ("out", "log_norm", "det", "nq") + (("spline",) if extra else ())}
    host.update((k, h["s"][:, slots.index(k)]) for k in names)
    return host, auto


def _gap(a, b):
    return float(((a.double() - b.double()).abs() / (1 + b.double().abs())).max())


@pytest.mark.parametrize("sites", ["prior", "edges"])
@pytest.mark.parametrize("family", FAMILIES)
def test_the_kernel_arithmetic_on_the_host_matches_autograd(host_rows, family, sites):
    """Every row's weight, the pivot, and the cotangents of the detector
    table, the q-norm table, POWER LAW + SPLINE's coefficient table and each
    site that the hand-derived chain rule gives for a random row cotangent,
    against autograd of the eager twin: at prior draws and at the edges of
    the POWER-LAW+PEAK model (for the other families, the edges of the sites
    they share, and the spline's heights at +-3).  In float64 to
    1e-10 of 1 + |autograd's|; in float32 as close to float64's autograd as
    the twin's own float32 autograd comes, within four times its gap and
    1e-5 (the taper's width near its edge loses a few digits to
    cancellation in either)."""
    s = _sites(family, 4, 7, torch.float64)
    if sites == "edges":
        s.update({k: torch.tensor(v, dtype=torch.float64) for k, v in EDGES.items() if k in s})
    s = {k: v.detach() for k, v in s.items()}
    host64, auto64 = _host_and_autograd(host_rows, family, torch.float64, s)
    gaps = {k: _gap(host64[k], auto64[k]) for k in auto64}
    assert max(gaps.values()) < 1e-10, gaps
    s32 = {k: v.float().double() for k, v in s.items()}  # the float32 sites, the reference in float64 at them
    host32, auto32 = _host_and_autograd(host_rows, family, torch.float32, s32)
    _, truth = _host_and_autograd(host_rows, family, torch.float64, s32)
    for k in truth:
        assert _gap(host32[k], truth[k]) < 4 * _gap(auto32[k], truth[k]) + 1e-5, k
