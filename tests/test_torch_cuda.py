"""The CUDA kernels against their plain twins on the card.

These need an NVIDIA GPU with ``nvcc``; they are marked ``cuda`` and skip on
a host without one (the CPU tests hold the twins against the JAX package).
On the GPU host: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances as ``chip_smoke.py`` states them.
"""
import numpy as np
import pytest
import torch

from bumpcosmology_torch.mock import cuda_snr, psd, snr
from bumpcosmology_torch.ops import cuda_bump, cuda_logwts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("c,n_grid", [(8, 256), (1, 256), (3, 48), (5, 100), (2, 600), (2, 2100)])
def test_bump_kernel_matches_plain(dev, c, n_grid):
    """One chain, grids that are no multiple of a warp, and grids of several
    passes of 256 columns (the last with more than 32 rows a warp), beside the
    full shape; two backward launches on the same inputs agree bit for bit."""
    rng = np.random.default_rng(0)
    mpisn = 31.0 + rng.normal(size=c)
    p = np.stack([1.8 + 0.3 * rng.normal(size=c), -0.7 + 0.3 * rng.normal(size=c), mpisn,
                  mpisn + rng.uniform(2, 8, c), rng.uniform(1.5, 3.5, c)], 1).astype(np.float32)
    g = torch.as_tensor(rng.normal(size=(c, n_grid)).astype(np.float32), device=dev)
    outs = []
    for fn in (cuda_bump.bump_log_dn, cuda_bump.bump_log_dn_plain):
        t = torch.tensor(p, device=dev, requires_grad=True)
        out = fn(t, n_grid)
        (out * g).sum().backward()
        outs.append((out.detach(), t.grad))
    again = cuda_bump._bump_bwd_cuda(torch.tensor(p, device=dev), outs[0][0], g, n_grid)
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=5e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=2e-4, atol=1e-5)
    assert torch.equal(again, outs[0][1])


def _logwts_inputs(rng, dev, c, k, gl, n):
    """Random tables, scalars and query rows [m1_det, q, log dL, log pdraw] on the card."""
    z = np.sort(rng.uniform(0.01, 3.0, (c, k)), 1)
    det = torch.as_tensor(np.stack([z, rng.normal(size=(c, k))], -1).astype(np.float32), device=dev)
    bump = torch.as_tensor(rng.normal(size=(c, gl)).astype(np.float32) - 5.0, device=dev)
    scal = np.zeros((c, 15), np.float32)
    scal[:, :13] = [np.log(0.1), np.log(200.0) / (k - 1), 3.0, 0.2, 3.0 + 0.2 * (gl - 1), 2.9, 36.0,
                    -4.0, 1.0, -2.0, 4.7, 7.0, 3.0]
    scal[:, 13:] = [k, gl]
    scal = torch.as_tensor(scal, device=dev)
    qry = torch.as_tensor(np.stack([rng.uniform(5, 120, n), rng.uniform(0.1, 1.0, n),
                                    rng.uniform(np.log(0.11), np.log(19.0), n),
                                    rng.normal(size=n)], 1).astype(np.float32), device=dev)
    return (det, bump, scal), qry


def _assert_cotangents_close(got, ref):
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4 * float(b.abs().max()) + 1e-5)


def test_logwts_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    c, n = 4, 5000
    tables, qry = _logwts_inputs(rng, dev, c, 1024, 256, n)
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev)
    res = []
    for fn in (cuda_logwts.logwts, cuda_logwts.logwts_plain):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        out = fn(*leaves, qry)
        (out.nan_to_num(neginf=0.0) * g).sum().backward()
        res.append((out.detach(), *(x.grad for x in leaves)))
    torch.cuda.synchronize()
    assert bool(torch.isneginf(res[1][0]).any())
    torch.testing.assert_close(res[0][0], res[1][0], rtol=2e-5, atol=2e-5)
    _assert_cotangents_close(res[0][1:], res[1][1:])


def test_logwts_lse_kernel_matches_plain(dev):
    """The ``lse`` epilogue: ragged segments (7 events x 96 samples, 1,000
    injections: pieces of 96 and a last piece of 104 rows), one all-dead event,
    cotangents handed over as broadcast views."""
    rng = np.random.default_rng(3)
    c, nobs, nsamp, nsel = 4, 7, 96, 1000
    tables, qry = _logwts_inputs(rng, dev, c, 1024, 256, nobs * nsamp + nsel)
    qry[2 * nsamp : 3 * nsamp, 0] = 1.0  # event 2: m1 < 5 on every row
    g_ev = torch.as_tensor(rng.normal(size=(c, 1)).astype(np.float32), device=dev).expand(c, nobs)
    g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32), device=dev)
    res = []
    for fn in (cuda_logwts.logwts_lse, cuda_logwts.logwts_lse_plain):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = fn(*leaves, qry, nobs, nsamp)
        torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
        res.append((lse_ev.detach(), lse_sel.detach(), *(x.grad for x in leaves)))
    torch.cuda.synchronize()
    assert bool(torch.isneginf(res[0][0][:, 2]).all()) and bool(torch.isfinite(res[0][0][:, [0, 1, 3, 4, 5, 6]]).all())
    assert all(bool(torch.isfinite(x).all()) for x in res[0][2:])
    torch.testing.assert_close(res[0][0], res[1][0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(res[0][1], res[1][1], rtol=2e-5, atol=2e-5)
    _assert_cotangents_close(res[0][2:], res[1][2:])


def test_snr_kernel_matches_plain(dev):
    """Kernel C against its plain twin, exact zeros (f_cut below f_min) included."""
    rng = np.random.default_rng(2)
    n = 20000
    m1 = np.exp(rng.uniform(np.log(5.0), np.log(2500.0), n))
    args = [torch.as_tensor(x.astype(np.float32), device=dev)
            for x in (m1, m1 * rng.uniform(0.05, 1.0, n), np.exp(rng.uniform(np.log(0.01), np.log(40.0), n)))]
    f_grid = snr.frequency_grid(device=dev)
    inv_psd = 1.0 / psd.PSDS["H1"](f_grid)
    grid = dict(f_min=float(f_grid[0]), f_max=float(f_grid[-1]), n_f=f_grid.shape[0])
    got = cuda_snr.snr_integral(*args, inv_psd, **grid)
    ref = cuda_snr.snr_integral_plain(*args, inv_psd, **grid, chunk=4096)
    torch.cuda.synchronize()
    assert torch.equal(got == 0, ref == 0) and bool((ref == 0).any())
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-6)
