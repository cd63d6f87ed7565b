"""Port parity, mock SNR path: kernel C's plain twin, the waveform, PSDs,
antenna patterns and the network SNR against the JAX package on the CPU.

Tolerances:
* kernel C's twin against ``snr_integral_pallas(interpret=True)``: rtol 1e-5,
  atol 1e-6, and the same exact zeros (rows with ``f_cut <= f_min``);
* against the XLA trapezoid of the JAX package's ``network_snr``: the same,
  except on rows whose only grid point below ``f_cut`` is ``f_0``.  There the
  XLA weight is ``(f_1 - f_0)/2`` of two rounded float32 knots near 10 Hz, a
  relative error up to about ulp(10)/0.105 = 9e-6 in the reference itself
  (the Pallas kernel differs from it by the same 1.1e-5), so those rows are
  held to rtol 2e-5;
* elementwise physics (amplitude, PSDs, antenna patterns): rtol 1e-5, with
  atol 1e-6 on the antenna patterns, which cross zero;
* SNRs, A and Theta: rtol 1e-5 (the square root halves the integral's error).

Kernel C's segment algebra (``cuda_snr._snr_integral_segments_plain``, what
``csrc/snr.cu`` computes) is held to the same JAX references at the same
tolerances, and to the twin at the card's limits (rtol 2e-5, atol 1e-6, the
same exact zeros), on random rows and on rows whose transition frequencies
sit on a stored knot of the grid or one ulp beside it.  Against the JAX
references such rows are taken only at knots where the JAX grids and the
port's grid agree bit for bit: a cut is a discontinuity, and the grids are
three float32 roundings of one formula.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.mock import detector as jdet
from bumpcosmology_tpu.mock import psd as jpsd
from bumpcosmology_tpu.mock import snr as jsnr
from bumpcosmology_tpu.mock import waveform as jwf
from bumpcosmology_tpu.mock.pallas_snr import snr_integral_pallas
from bumpcosmology_torch.mock import cuda_snr, detector, psd, snr, waveform
from bumpcosmology_torch.testing import snr_knot_rows

RTOL, ATOL = 1e-5, 1e-6


def _sources(n, seed):
    """Detector-frame masses over [5, 2500] Msun, heavy enough that some
    systems end below f_min (exact zeros), and dL over [0.01, 40] Gpc."""
    rng = np.random.default_rng(seed)
    m1 = np.exp(rng.uniform(np.log(5.0), np.log(2500.0), n)).astype(np.float32)
    m2 = (m1 * rng.uniform(0.05, 1.0, n)).astype(np.float32)
    dl = np.exp(rng.uniform(np.log(0.01), np.log(40.0), n)).astype(np.float32)
    return m1, m2, dl


def _angles(n, seed):
    rng = np.random.default_rng(seed)
    return (np.arccos(rng.uniform(-1, 1, n)), rng.uniform(0, 2 * np.pi, n), np.arcsin(rng.uniform(-1, 1, n)),
            rng.uniform(0, np.pi, n), rng.uniform(0, 2 * np.pi, n))


def _xla_integral(m1, m2, dl, f_grid, inv_s):
    """The JAX package's XLA integral (``mock/snr.py:99-106``)."""
    amp = jsnr.AMP_SCALE * jwf.phenom_a_amplitude(f_grid[None], jnp.asarray(m1)[:, None],
                                                  jnp.asarray(m2)[:, None], jnp.asarray(dl)[:, None])
    integrand = amp * amp * inv_s[None]
    df = jnp.diff(f_grid)
    return np.asarray(jnp.sum(0.5 * df[None] * (integrand[:, 1:] + integrand[:, :-1]), axis=1))


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_snr_integral_plain_matches_jax(reference):
    m1, m2, dl = _sources(300, seed=0)
    f_grid = jsnr.frequency_grid()
    inv_s = 1.0 / jpsd.PSDS["H1"](f_grid)
    f_min, f_max = float(f_grid[0]), float(f_grid[-1])
    if reference == "pallas_interpret":
        ref = np.asarray(snr_integral_pallas(jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(dl), inv_s,
                                             f_min=f_min, f_max=f_max, interpret=True))
    else:
        ref = _xla_integral(m1, m2, dl, f_grid, inv_s)
    t_grid = snr.frequency_grid(device="cpu")
    got = cuda_snr.snr_integral(*(torch.as_tensor(x) for x in (m1, m2, dl)), 1.0 / psd.PSDS["H1"](t_grid),
                                f_min=f_min, f_max=f_max).numpy()
    zeros = ref == 0
    assert 0 < zeros.sum() < len(ref), "the sample must hold exact zeros and non-zeros"
    np.testing.assert_array_equal(got == 0, zeros)
    n_live = (np.asarray(f_grid)[None] < cuda_snr.row_scalars(torch.as_tensor(m1), torch.as_tensor(m2))[3]
              .numpy()[:, None]).sum(1)
    one_point = (n_live == 1) if reference == "xla" else np.zeros(len(ref), bool)
    np.testing.assert_allclose(got[~one_point], ref[~one_point], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[one_point], ref[one_point], rtol=2e-5, atol=ATOL)


def _jax_reference(reference, m1, m2, dl):
    f_grid = jsnr.frequency_grid()
    inv_s = 1.0 / jpsd.PSDS["H1"](f_grid)
    if reference == "pallas_interpret":
        return np.asarray(snr_integral_pallas(jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(dl), inv_s,
                                              f_min=float(f_grid[0]), f_max=float(f_grid[-1]), interpret=True))
    return _xla_integral(m1, m2, dl, f_grid, inv_s)


def _segments(m1, m2, dl):
    """The segment algebra on the CPU grid, as ``snr_integral`` sets it up."""
    f_grid = jsnr.frequency_grid()
    t_grid = snr.frequency_grid(device="cpu")
    return cuda_snr._snr_integral_segments_plain(*(torch.as_tensor(x) for x in (m1, m2, dl)),
                                                 1.0 / psd.PSDS["H1"](t_grid), f_min=float(f_grid[0]),
                                                 f_max=float(f_grid[-1])).numpy()


def _agreeing_knots():
    """Knots where the port's grid, the Pallas kernel's in-kernel grid and the
    XLA path's ``frequency_grid`` are the same float32 number."""
    f_xla = np.asarray(jsnr.frequency_grid())
    n_f, f_min, f_max = len(f_xla), float(f_xla[0]), float(f_xla[-1])
    dlog = (math.log(f_max) - math.log(f_min)) / (n_f - 1)
    k = jnp.arange(n_f, dtype=jnp.float32)
    f_pallas = np.asarray(jax.jit(lambda k: jnp.exp(math.log(f_min) + dlog * k))(k))
    f_port = cuda_snr.log_grid(f_min, f_max, n_f, "cpu").numpy()
    return np.nonzero((f_port == f_pallas) & (f_port == f_xla))[0]


def _jax_f_cut(m1, m2):
    """f_cut as XLA rounds it: one ulp from the port's on about a third of
    rows (the operation order is the same; the compiler's rewrites are not)."""
    def f_cut(m1, m2):
        m_total = m1 + m2
        eta = m1 * m2 / (m_total * m_total)
        a, b, c = jwf._FCUT
        return (a * eta * eta + b * eta + c) / (math.pi * (m_total * jwf.MSUN_S))

    return np.asarray(jax.jit(f_cut)(jnp.asarray(m1), jnp.asarray(m2)))


def _edge_rows():
    """Light systems: f_merg, f_ring or f_cut above f_max (the ringdown cut at
    the grid's end, empty, or the whole grid inspiral), and heavy ones that end
    at or below f_min (exact zeros)."""
    m1 = np.array([1.2, 2.0, 3.0, 3.5, 4.0, 4.5, 5.0, 6.0, 2500.0, 3000.0], np.float32)
    m2 = np.array([1.0, 1.5, 2.0, 3.0, 3.5, 2.0, 4.0, 2.0, 2400.0, 2900.0], np.float32)
    return m1, m2, np.linspace(0.05, 5.0, len(m1)).astype(np.float32)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_snr_segments_plain_matches_jax(reference):
    """Kernel C's segment algebra against the JAX package, as the twin is held."""
    m1, m2, dl = _sources(300, seed=0)
    ref = _jax_reference(reference, m1, m2, dl)
    got = _segments(m1, m2, dl)
    zeros = ref == 0
    assert 0 < zeros.sum() < len(ref)
    np.testing.assert_array_equal(got == 0, zeros)
    f_grid = np.asarray(jsnr.frequency_grid())
    n_live = (f_grid[None] < cuda_snr.row_scalars(torch.as_tensor(m1), torch.as_tensor(m2))[3].numpy()[:, None]).sum(1)
    one_point = (n_live == 1) if reference == "xla" else np.zeros(len(ref), bool)
    np.testing.assert_allclose(got[~one_point], ref[~one_point], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[one_point], ref[one_point], rtol=2e-5, atol=ATOL)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_snr_segments_plain_matches_jax_on_knots(reference):
    """Rows whose f_merg, f_ring or f_cut is a stored knot or one ulp beside
    it, and the light and heavy edge rows, against the JAX package.  The
    amplitude is continuous at f_merg and f_ring, so a count off by one there
    moves the integral by rounding only; at f_cut it moves a whole term, so
    the rows kept are those whose f_cut XLA rounds as the port does."""
    knots = _agreeing_knots()
    assert len(knots) > 150
    t_grid = cuda_snr.log_grid(float(jsnr.frequency_grid()[0]), float(jsnr.frequency_grid()[-1]), 512, "cpu")
    m1, m2, dl = (t.numpy() for t in snr_knot_rows(t_grid, knots=knots[::3], ratios=(0.2, 1.0)))
    same_cut = _jax_f_cut(m1, m2) == cuda_snr.row_scalars(torch.as_tensor(m1), torch.as_tensor(m2))[3].numpy()
    assert same_cut.sum() > 0.5 * len(m1)
    m1, m2, dl = (np.concatenate(x) for x in zip((m1[same_cut], m2[same_cut], dl[same_cut]), _edge_rows()))
    ref = _jax_reference(reference, m1, m2, dl)
    got = _segments(m1, m2, dl)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=2e-5 if reference == "xla" else RTOL, atol=ATOL)


@pytest.mark.parametrize("rows", ["random", "knots", "edges"])
def test_snr_segments_plain_matches_twin(rows):
    """The segment algebra against the twin at the card's limits (rtol 2e-5,
    atol 1e-6, the same exact zeros), on every knot of the port's grid."""
    t_grid = cuda_snr.log_grid(10.0, 2048.0, 512, "cpu")
    if rows == "random":
        m1, m2, dl = (torch.as_tensor(x) for x in _sources(2000, seed=8))
    elif rows == "knots":
        m1, m2, dl = snr_knot_rows(t_grid, knots=np.arange(0, 512, 2), ratios=(0.1, 1.0))
    else:
        m1, m2, dl = (torch.as_tensor(x) for x in _edge_rows())
    inv_psd = 1.0 / psd.PSDS["H1"](t_grid)
    got = cuda_snr._snr_integral_segments_plain(m1, m2, dl, inv_psd)
    ref = cuda_snr.snr_integral_plain(m1, m2, dl, inv_psd)
    assert torch.equal(got == 0, ref == 0)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-6)


def test_snr_knot_rows_sit_on_the_knots():
    t_grid = cuda_snr.log_grid(10.0, 2048.0, 512, "cpu")
    m1, m2, _ = snr_knot_rows(t_grid, knots=np.arange(0, 512, 7))
    fm, fr, _, fc = cuda_snr.row_scalars(m1, m2)
    down, up = (torch.nextafter(t_grid, t_grid.new_tensor(s)) for s in (-math.inf, math.inf))
    for x in (fm, fr, fc):
        on = [int(torch.isin(x, g).sum()) for g in (down, t_grid, up)]
        assert min(on) > 40, on


def test_count_below_matches_searchsorted():
    """Thresholds on every stored knot and one ulp either side, beyond both
    ends of the grid, and non-finite ones: the kernel's guess-and-correct
    count is ``#{k : f_k < x}``."""
    t_grid = cuda_snr.log_grid(10.0, 2048.0, 512, "cpu")
    down, up = (torch.nextafter(t_grid, t_grid.new_tensor(s)) for s in (-math.inf, math.inf))
    x = torch.cat([down, t_grid, up, torch.tensor([0.0, 1.0, 9.0, 2048.5, 5000.0, math.inf])])
    np.testing.assert_array_equal(cuda_snr._count_below(t_grid, x).numpy(), torch.searchsorted(t_grid, x).numpy())
    assert int(cuda_snr._count_below(t_grid, torch.tensor([math.nan]))) == 0


def test_phenom_a_amplitude_matches_jax():
    m1, m2, dl = _sources(40, seed=1)
    f = np.geomspace(5.0, 4000.0, 300).astype(np.float32)
    ref = np.asarray(jwf.phenom_a_amplitude(jnp.asarray(f)[None], jnp.asarray(m1)[:, None],
                                            jnp.asarray(m2)[:, None], jnp.asarray(dl)[:, None]))
    got = waveform.phenom_a_amplitude(torch.as_tensor(f)[None], torch.as_tensor(m1)[:, None],
                                      torch.as_tensor(m2)[:, None], torch.as_tensor(dl)[:, None]).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(waveform.chirp_time_bound(10.0, torch.as_tensor(m1), torch.as_tensor(m2)).numpy(),
                               np.asarray(jwf.chirp_time_bound(10.0, jnp.asarray(m1), jnp.asarray(m2))), rtol=RTOL)


def _tabulated(module):
    f = np.geomspace(10.0, 4096.0, 2000)
    s_phys = np.asarray(jpsd.aligo_design_psd(jnp.asarray(f), f_low=0.0), dtype=np.float64) * jpsd.PSD_SCALE
    return module.tabulated_psd(f, s_phys)


@pytest.mark.parametrize("which", ["H1", "V1", "tabulated"])
def test_psds_match_jax(which):
    f = np.geomspace(5.0, 3000.0, 513).astype(np.float32)
    jfn, tfn = (_tabulated(jpsd), _tabulated(psd)) if which == "tabulated" else (jpsd.PSDS[which], psd.PSDS[which])
    ref = np.asarray(jfn(jnp.asarray(f)))
    got = tfn(torch.as_tensor(f)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() > 400
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL)


@pytest.mark.parametrize("det", ["H1", "L1", "V1"])
def test_antenna_pattern_matches_jax(det):
    _, ra, dec, psi, gmst = (x.astype(np.float32) for x in _angles(2000, seed=2))
    ref = jdet.antenna_pattern(jdet.DETECTORS[det], *(jnp.asarray(x) for x in (ra, dec, psi, gmst)))
    got = detector.antenna_pattern(detector.DETECTORS[det], *(torch.as_tensor(x) for x in (ra, dec, psi, gmst)))
    np.testing.assert_array_equal(detector.DETECTORS[det].response, jdet.DETECTORS[det].response)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def _campaign_rows(n, seed):
    m1, m2, dl = _sources(n, seed)
    return (m1, m2, dl, *_angles(n, seed + 1))


@pytest.mark.parametrize("case", ["chunk128", "chunk4096", "tabulated_h1"])
def test_network_snr_batched_matches_jax(case):
    args = _campaign_rows(1500, seed=3)
    chunk = 128 if case == "chunk128" else 4096
    jpsds, tpsds = ({"H1": _tabulated(jpsd)}, {"H1": _tabulated(psd)}) if case == "tabulated_h1" else (None, None)
    ref = jsnr.network_snr_batched(*args, chunk=chunk, psds=jpsds)
    got = snr.network_snr_batched(*args, chunk=chunk, psds=tpsds, device="cpu")
    assert set(got) == {"H1", "L1", "V1", "net"}
    for k in got:
        assert got[k].dtype == np.float32 and got[k].shape == (1500,)
        np.testing.assert_array_equal(got[k] == 0, ref[k] == 0)
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=0.0, err_msg=k)
    assert 0 < (ref["net"] == 0).sum() and ref["net"].max() > 10.0


def test_network_snr_does_not_depend_on_chunk():
    args = _campaign_rows(700, seed=4)
    a = snr.network_snr_batched(*args, chunk=128, device="cpu")
    b = snr.network_snr_batched(*args, chunk=4096, device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_amplitude_and_projection_factor_match_jax():
    m1, m2, _ = _sources(600, seed=5)
    np.testing.assert_allclose(snr.amplitude_factor(m1, m2, chunk=256, device="cpu"),
                               jsnr.amplitude_factor(m1, m2), rtol=RTOL, atol=0.0)
    angles = _angles(600, seed=6)
    np.testing.assert_allclose(snr.projection_factor(*angles, device="cpu"), jsnr.projection_factor(*angles),
                               rtol=RTOL)
    np.testing.assert_allclose(snr.draw_projection_factors(np.random.default_rng(7), 300, device="cpu"),
                               jsnr.draw_projection_factors(np.random.default_rng(7), 300), rtol=RTOL)
