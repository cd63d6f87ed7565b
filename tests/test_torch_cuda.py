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
from bumpcosmology_torch.testing import snr_knot_rows

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


def test_logwts_per_chain_queries_match_plain_and_the_shared_table(dev):
    """A query table per chain, (C, N, 4): three chains whose rows differ
    (one all-dead event in chain 1 only) against the twin, both epilogues,
    both ways; the shared table copied per chain gives the shared table's
    forward values bit for bit."""
    rng = np.random.default_rng(5)
    c, nobs, nsamp, nsel = 3, 5, 64, 700
    n = nobs * nsamp + nsel
    tables, qry0 = _logwts_inputs(rng, dev, c, 1024, 256, n)
    qry = torch.stack([_logwts_inputs(rng, dev, 1, 1024, 256, n)[1] for _ in range(c)])
    qry[1, 2 * nsamp : 3 * nsamp, 0] = 1.0
    copied = qry0.expand(c, -1, -1).contiguous()
    assert torch.equal(cuda_logwts.logwts(*tables, qry0), cuda_logwts.logwts(*tables, copied))
    assert all(torch.equal(a, b) for a, b in zip(cuda_logwts.logwts_lse(*tables, qry0, nobs, nsamp),
                                                 cuda_logwts.logwts_lse(*tables, copied, nobs, nsamp)))
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev)
    g_ev = torch.as_tensor(rng.normal(size=(c, nobs)).astype(np.float32), device=dev)
    g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32), device=dev)
    res = []
    for rows_fn, lse_fn in ((cuda_logwts.logwts, cuda_logwts.logwts_lse),
                            (cuda_logwts.logwts_plain, cuda_logwts.logwts_lse_plain)):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        out = rows_fn(*leaves, qry)
        (out.nan_to_num(neginf=0.0) * g).sum().backward()
        leaves_l = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = lse_fn(*leaves_l, qry, nobs, nsamp)
        torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
        res.append((out.detach(), lse_ev.detach(), lse_sel.detach(), [x.grad for x in leaves],
                    [x.grad for x in leaves_l]))
    torch.cuda.synchronize()
    assert bool(torch.isneginf(res[0][1][1, 2])) and bool(torch.isfinite(res[0][1][[0, 2]]).all())
    for i in range(3):
        torch.testing.assert_close(res[0][i], res[1][i], rtol=2e-5, atol=2e-5)
    _assert_cotangents_close(res[0][3], res[1][3])
    _assert_cotangents_close(res[0][4], res[1][4])



@pytest.mark.parametrize("layout", ["shared", "per_chain"])
def test_logwts_backward_is_bit_identical_between_launches(dev, layout):
    """Two launches of kernel B's backward on the same inputs agree bit for
    bit, both epilogues, with the shared query table and with one a chain:
    the table cotangents are summed in fixed point, so the order in which
    the rows reach a bin does not show in the result."""
    rng = np.random.default_rng(11)
    c, nobs, nsamp, nsel = 8, 24, 256, 6000
    n = nobs * nsamp + nsel
    tables, qry = _logwts_inputs(rng, dev, c, 1024, 256, n)
    if layout == "per_chain":
        qry = torch.stack([qry[torch.as_tensor(rng.permutation(n), device=dev)] for _ in range(c)])
    out = cuda_logwts._logwts_fwd_cuda(*tables, qry)
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev) * torch.isfinite(out)
    lse_ev, lse_sel = cuda_logwts._logwts_lse_fwd_cuda(*tables, qry, nobs, nsamp)
    g_ev = torch.as_tensor(rng.normal(size=(c, nobs)).astype(np.float32), device=dev)
    g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32), device=dev)
    for fn in (lambda: cuda_logwts._logwts_bwd_cuda(*tables, qry, g),
               lambda: cuda_logwts._logwts_lse_bwd_cuda(*tables, qry, lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x).all()) for x in first)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_logwts_backward_names_the_largest_detector_table_that_fits(dev):
    """Both directions take every detector-table K the forward fits in shared
    memory, the backward on its second route beyond its own bins' limit;
    beyond the forward's limit both are refused with a ValueError naming the
    most K that fits, and at that K both run."""
    rng = np.random.default_rng(12)
    c, n = 2, 4096
    tables, qry = _logwts_inputs(rng, dev, c, 40000, 256, n)
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev)
    with pytest.raises(ValueError, match=r"K = 40000 rows \(fit.n_z\).*at most K = \d+ fit") as err:
        cuda_logwts._logwts_fwd_cuda(*tables, qry)
    most = int(str(err.value).split("at most K = ")[1].split()[0])
    assert 8192 < most < 40000
    with pytest.raises(ValueError, match=rf"K = 40000 rows \(fit.n_z\).*at most K = {most} fit"):
        cuda_logwts._logwts_bwd_cuda(*tables, qry, g)
    tables, qry = _logwts_inputs(rng, dev, c, most, 256, n)
    out = cuda_logwts._logwts_fwd_cuda(*tables, qry)
    before = cuda_logwts.LAUNCHES["logwts_bwd_global"]
    d = cuda_logwts._logwts_bwd_cuda(*tables, qry, torch.ones_like(out) * torch.isfinite(out))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in d)
    assert cuda_logwts.LAUNCHES["logwts_bwd_global"] == before + 1


@pytest.mark.parametrize("layout", ["shared", "per_chain"])
def test_logwts_backward_at_a_detector_table_beyond_shared_memory(dev, layout):
    """At K = 8,192 detector rows (beyond the 4,347 whose bins fit in shared
    memory) the backward takes the route with its bins in device memory: both
    epilogues, both ways, against the twin at B's limits, and two backward
    launches on the same inputs agree bit for bit."""
    rng = np.random.default_rng(13)
    c, nobs, nsamp, nsel = 4, 24, 256, 6000
    n = nobs * nsamp + nsel
    tables, qry = _logwts_inputs(rng, dev, c, 8192, 256, n)
    suffix = "_per_chain" if layout == "per_chain" else ""
    if layout == "per_chain":
        qry = torch.stack([qry[torch.as_tensor(rng.permutation(n), device=dev)] for _ in range(c)])
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev)
    g_ev = torch.as_tensor(rng.normal(size=(c, nobs)).astype(np.float32), device=dev)
    g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32), device=dev)
    before = dict(cuda_logwts.LAUNCHES)
    res = []
    for rows_fn, lse_fn in ((cuda_logwts.logwts, cuda_logwts.logwts_lse),
                            (cuda_logwts.logwts_plain, cuda_logwts.logwts_lse_plain)):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        out = rows_fn(*leaves, qry)
        (out.nan_to_num(neginf=0.0) * g).sum().backward()
        leaves_l = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = lse_fn(*leaves_l, qry, nobs, nsamp)
        torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
        res.append((out.detach(), lse_ev.detach(), lse_sel.detach(), [x.grad for x in leaves],
                    [x.grad for x in leaves_l]))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in cuda_logwts.LAUNCHES.items() if v != before[k]}
    assert launched == {f"logwts_fwd{suffix}": 1, f"logwts_bwd_global{suffix}": 1,
                        f"logwts_lse_fwd{suffix}": 1, f"logwts_lse_bwd_global{suffix}": 1}
    for i in range(3):
        torch.testing.assert_close(res[0][i], res[1][i], rtol=2e-5, atol=2e-5)
    _assert_cotangents_close(res[0][3], res[1][3])
    _assert_cotangents_close(res[0][4], res[1][4])
    g_live = g * torch.isfinite(res[0][0])
    for fn in (lambda: cuda_logwts._logwts_bwd_cuda(*tables, qry, g_live),
               lambda: cuda_logwts._logwts_lse_bwd_cuda(*tables, qry, res[0][1], res[0][2], g_ev, g_sel, nobs,
                                                        nsamp)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x).all()) for x in first)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("layout,c,nobs,nsamp,nsel", [("shared", 64, 56, 256, 24576), ("per_chain", 56, 55, 256, 24576)])
def test_logwts_at_the_model_comparison_shapes(dev, layout, c, nobs, nsamp, nsel):
    """Kernel B at the shapes of model comparison: the shared table at C = 64
    (the compare stage's batch) and a query table per chain at the LOO
    fleet's 56 x 38,656 rows; both epilogues, both ways, against the twin."""
    rng = np.random.default_rng(7)
    n = nobs * nsamp + nsel
    tables, qry = _logwts_inputs(rng, dev, c, 1024, 256, n)
    if layout == "per_chain":
        qry = torch.stack([qry[torch.as_tensor(rng.permutation(n), device=dev)] for _ in range(c)])
    g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev)
    g_ev = torch.as_tensor(rng.normal(size=(c, nobs)).astype(np.float32), device=dev)
    g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32), device=dev)
    res = []
    for rows_fn, lse_fn in ((cuda_logwts.logwts, cuda_logwts.logwts_lse),
                            (cuda_logwts.logwts_plain, cuda_logwts.logwts_lse_plain)):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        out = rows_fn(*leaves, qry)
        (out.nan_to_num(neginf=0.0) * g).sum().backward()
        leaves_l = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = lse_fn(*leaves_l, qry, nobs, nsamp)
        torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
        res.append((out.detach(), lse_ev.detach(), lse_sel.detach(), [x.grad for x in leaves],
                    [x.grad for x in leaves_l]))
    torch.cuda.synchronize()
    for i in range(3):
        torch.testing.assert_close(res[0][i], res[1][i], rtol=2e-5, atol=2e-5)
    _assert_cotangents_close(res[0][3], res[1][3])
    _assert_cotangents_close(res[0][4], res[1][4])


def test_pointwise_matrix_on_the_card_matches_the_cpu(dev):
    """The joint model's pointwise matrix (kernels A and B's lse forward, one
    launch each a batch, no backward) against the same on the CPU: phase 4's
    limit, |d|/(1+|ref|) < 2e-4; a tail batch of 6."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import constrain, prior_sample
    from bumpcosmology_torch.inference.model_compare import pointwise_matrix, pop_cosmo_pointwise_loglike
    from bumpcosmology_torch.testing import synthetic_pop_cosmo_data

    mats = {}
    for d in (dev, torch.device("cpu")):
        data = synthetic_pop_cosmo_data(12, 64, 2048, seed=3, device=d)
        bounds, qry = lk.dl_bounds_of(data, margin=0.1), lk.query_table(data)
        if d == dev:
            spec = lk.pop_cosmo_model_spec(data, 128, 256, device="cpu")
            theta = prior_sample(spec, torch.Generator().manual_seed(2), shape=(70,))
            post = {k: v.numpy()[None] for k, v in constrain(spec, theta).items()}
            before = dict(cuda_logwts.LAUNCHES), dict(cuda_bump.LAUNCHES)
        mats[d.type] = pointwise_matrix(lambda s: pop_cosmo_pointwise_loglike(s, data, 128, 256, bounds, qry=qry),
                                        post, list(lk.POP_COSMO_PRIORS), batch=32, device=d)
        if d == dev:
            launched = {k: v - before[0][k] for k, v in cuda_logwts.LAUNCHES.items() if v != before[0][k]}
            launched.update({k: v - before[1][k] for k, v in cuda_bump.LAUNCHES.items() if v != before[1][k]})
            assert launched == {"logwts_lse_fwd": 3, "bump_fwd": 3}
    ref = mats["cpu"]
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(mats["cuda"]), fin)
    assert fin.any()
    assert float((np.abs(mats["cuda"][fin] - ref[fin]) / (1.0 + np.abs(ref[fin]))).max()) < 2e-4

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


def _snr_rows(case, dev, f_grid):
    """(m1, m2, dl) on the card for one of the shapes kernel C could get wrong."""
    rng = np.random.default_rng(4)
    if case == "every_kind":  # knots, light (ringdown cut at f_max, empty, all inspiral), heavy (exact zeros)
        m1, m2, dl = (t.cpu().numpy() for t in snr_knot_rows(f_grid, knots=np.arange(0, 512, 5), ratios=(0.3,)))
        light = np.array([1.2, 2.0, 3.0, 3.5, 4.0, 4.5, 5.0, 6.0, 2500.0, 3000.0])
        m1 = np.concatenate([m1, light, np.exp(rng.uniform(np.log(5.0), np.log(2500.0), 3000))])
        m2 = np.concatenate([m2, 0.8 * light, m1[-3000:] * rng.uniform(0.05, 1.0, 3000)])
        dl = np.concatenate([dl, np.full(10, 0.5), np.exp(rng.uniform(np.log(0.01), np.log(40.0), 3000))])
        perm = rng.permutation(len(m1))  # mix the kinds inside every warp
        m1, m2, dl = m1[perm], m2[perm], dl[perm]
    else:
        n = {"n1": 1, "n257": 257, "tabulated_psd": 5000}[case]
        m1 = np.exp(rng.uniform(np.log(5.0), np.log(300.0), n))
        m2 = m1 * rng.uniform(0.05, 1.0, n)
        dl = np.exp(rng.uniform(np.log(0.01), np.log(40.0), n))
    return [torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (m1, m2, dl)]


@pytest.mark.parametrize("case", ["n1", "n257", "every_kind", "tabulated_psd"])
def test_snr_kernel_cases_match_plain(dev, case):
    """One row, a row past a whole block, a block holding every kind of row
    (transitions on a stored knot or one ulp beside it, ringdowns cut at f_max
    or empty, all-inspiral rows, exact zeros), and a tabulated PSD (another
    inv_psd on the same grid): the kernel against its twin at phase 6's limits."""
    f_grid = snr.frequency_grid(device=dev)
    grid = dict(f_min=float(f_grid[0]), f_max=float(f_grid[-1]), n_f=f_grid.shape[0])
    args = _snr_rows(case, dev, cuda_snr.log_grid(**grid, device=dev))
    if case == "tabulated_psd":
        f = np.geomspace(10.0, 4096.0, 2000)
        s_phys = psd.aligo_design_psd(torch.as_tensor(f)).numpy().astype(np.float64) * psd.PSD_SCALE
        s_phys *= 1.0 + 0.3 * np.sin(f / 37.0)  # another shape than the design curve's
        inv_psd = 1.0 / psd.tabulated_psd(f, s_phys)(f_grid)
    else:
        inv_psd = 1.0 / psd.PSDS["H1"](f_grid)
    got = cuda_snr.snr_integral(*args, inv_psd, **grid)
    ref = cuda_snr.snr_integral_plain(*args, inv_psd, **grid, chunk=4096)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.equal(got == 0, ref == 0)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("family", ["plpeak", "brokenpl", "pspline"])
@pytest.mark.parametrize("layout", ["shared", "fleet"])
def test_family_joint_value_and_grad_repeats_on_the_card(dev, family, layout):
    """The families' joint potential (the fused detector-table route in plain
    PyTorch, no kernel): two value+grads on the card give the same bits, with
    one catalog shared by the chains and with a catalog a chain (a fleet, a
    query table per chain, as the SBC fleet reads it); both against the same
    on the CPU within phase 4's limits, |dU|/(1+|U|) < 2e-4 and
    |dgrad|/(1+|grad|) < 5e-3."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import make_potential, prior_sample, value_and_grad
    from bumpcosmology_torch.testing import synthetic_pop_cosmo_data

    build, priors = lk.MASS_FAMILIES[family].build, lk.MASS_FAMILIES[family].cosmo_priors
    n = 8
    cand = prior_sample(lk.ModelSpec(priors=dict(priors), loglike=None, device=torch.device("cpu")),
                        torch.Generator().manual_seed(5), shape=(n,))
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        cats = [synthetic_pop_cosmo_data(12, 64, 2048, seed=3 + s, device=d) for s in range(n)]
        data = lk.stack_fleet(cats) if layout == "fleet" else cats[0]
        bounds = lk.dl_bounds_of(data, margin=0.1)
        pot = make_potential(lk.ModelSpec(priors=dict(priors), device=d, loglike=lambda sites: lk.pop_cosmo_loglike(
            sites, data, 128, 256, bounds, build=build)))
        theta = cand.to(d)
        res[where] = value_and_grad(pot, theta)
        if where == "card":
            u2, g2 = value_and_grad(pot, theta)
            torch.cuda.synchronize()
            assert torch.equal(res[where][0].view(torch.int32), u2.view(torch.int32))
            assert torch.equal(res[where][1].view(torch.int32), g2.view(torch.int32))
    (u, g), (u_ref, g_ref) = ((x.cpu() for x in res[k]) for k in ("card", "cpu"))
    assert bool(torch.isfinite(u_ref).all() and torch.isfinite(g_ref).all())
    assert float(((u - u_ref).abs() / (1 + u_ref.abs())).max()) < 2e-4
    assert float(((g - g_ref).abs() / (1 + g_ref.abs())).max()) < 5e-3


def test_host_syncs_counts_every_synchronising_call_of_a_transition(dev):
    """Over one NUTS transition of the flagship (4 chains of the committed
    adapted state, depth 6, every chain first and then the subsets still
    integrating), ``nuts.host_syncs`` rises by as many as the synchronising
    calls that CUDA's sync debug mode reports."""
    import warnings
    from pathlib import Path

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference import nuts
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad
    from bumpcosmology_torch.utils import load_warmup, profiling

    bench = Path(__file__).resolve().parents[1] / "benchmarks"
    spec = pop_cosmo_model_spec(load_pop_cosmo_data(bench / "flagship_catalog.npz", device=dev), 256, 1024,
                                device=dev)
    warm = load_warmup(bench / "flagship_warmup16.npz", device=dev)
    potential, c = make_potential(spec), 4
    theta = warm.state.theta[:c]
    state = nuts.ChainState(theta, *value_and_grad(potential, theta))
    gen = torch.Generator(device=dev).manual_seed(11)
    step = lambda s: nuts.nuts_transition(potential, s, warm.eps[:c], warm.cov[:c], warm.chol_cov[:c], gen, 6)  # noqa: E731
    state, _ = step(state)  # the kernels' and the allocator's first use
    torch.cuda.synchronize()
    for _ in range(2):
        before = profiling.counters()["nuts.host_syncs"]
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state, stats = step(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        reported = sum("synchroniz" in str(w.message) for w in caught)
        counted = profiling.counters()["nuts.host_syncs"] - before
        assert int(stats.n_leapfrog.max()) > 1 and reported == counted



def test_host_syncs_counts_every_synchronising_call_of_a_plpeak_transition(dev):
    """The same count on the POWER-LAW+PEAK joint fit (the cell
    ``flagship_plpeak.nuts``: its cut catalog and committed adapted state,
    4 chains, depth 6): over a transition ``nuts.host_syncs`` rises by as
    many as the synchronising calls that CUDA's sync debug mode reports,
    kernel F launches once forward and once backward a value+grad, and a
    value+grad of the family's potential alone (the q-norm grid, the
    cosmology and detector tables and kernel F) reports none."""
    import json
    import warnings
    from pathlib import Path

    from bumpcosmology_torch.inference import nuts
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad
    from bumpcosmology_torch.utils import load_warmup, profiling
    from cardbench import harness

    config = json.loads((harness.BENCH_DIR / "configs" / "flagship_plpeak.json").read_text())
    raw = harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog")), config["events"],
                              config["pe_samples"], config["injections"])
    spec = MASS_FAMILIES["plpeak"].cosmo_spec(harness.program_data(raw, dev), n_grid=config["n_grid"],
                                              n_z=config["n_z"], device=dev)
    warm = load_warmup(harness.data_path(config, "warmup_state"), device=dev)
    potential, c = make_potential(spec), config["chains"]
    theta = warm.state.theta[:c]
    state = nuts.ChainState(theta, *value_and_grad(potential, theta))
    gen = torch.Generator(device=dev).manual_seed(13)
    step = lambda s: nuts.nuts_transition(potential, s, warm.eps[:c], warm.cov[:c], warm.chol_cov[:c], gen, 6)  # noqa: E731
    state, _ = step(state)
    torch.cuda.synchronize()

    def reported(fn):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return out, sum("synchroniz" in str(w.message) for w in caught)

    for _ in range(2):
        before = profiling.counters()
        (state, stats), n = reported(lambda: step(state))
        after = profiling.counters()
        delta = {k: after[k] - before[k] for k in after}
        assert int(stats.n_leapfrog.max()) > 1 and n == delta["nuts.host_syncs"]
        # kernel F once forward and once backward a value+grad, on the shared query table's shared-memory route
        assert delta["model.value_and_grads"] > 1
        assert delta["cuda_families.families_fwd"] == delta["cuda_families.families_bwd"] == \
            delta["model.value_and_grads"]
        assert sum(v for k, v in delta.items() if k.startswith("cuda_families.")) == 2 * delta["model.value_and_grads"]
    _, n = reported(lambda: value_and_grad(potential, state.theta))
    assert n == 0


def _priors_on(dev, spec, theta, g_lp, g_sites):
    """``(log_prior, sites (C, dim), grad)`` of ``model.log_prior_and_sites`` at
    ``theta``, computed on ``dev`` and returned on the CPU; the gradient as
    ``testing.priors_twin`` takes it."""
    from bumpcosmology_torch.inference.model import log_prior_and_sites

    th = theta.to(dev).requires_grad_(True)
    lp, sites = log_prior_and_sites(spec, th)
    assert list(sites) == list(spec.names)
    stacked = torch.stack([sites[k] for k in spec.names], -1)
    loss = (g_lp.to(dev) * lp).sum() + (g_sites.to(dev) * stacked).sum()
    (grad,) = torch.autograd.grad(loss, th)
    torch.cuda.synchronize()
    return lp.detach().cpu(), stacked.detach().cpu(), grad.cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1, 3, 4, 128])
@pytest.mark.parametrize("prior_set", ["pop_cosmo", "pop", "plpeak_cosmo", "brokenpl_cosmo", "every_case"])
def test_priors_kernel_matches_the_per_site_code(dev, prior_set, c, dtype):
    """Kernel P (``csrc/priors.cu``) against the per-site code on the CPU at
    N(0, 3^2) points and rows at +40, -40 (and 0): log prior, sites and the
    gradient within ``testing.priors_gaps``' limits, the same entries -inf,
    and two launches each way bit for bit the same."""
    from bumpcosmology_torch.inference.model import ModelSpec
    from bumpcosmology_torch.ops import cuda_priors
    from bumpcosmology_torch.testing import PRIOR_SETS, prior_thetas, priors_gaps, priors_twin

    spec = ModelSpec(priors=dict(PRIOR_SETS[prior_set]), loglike=None)
    theta = prior_thetas(c, spec.dim, seed=c, dtype=dtype)
    gen = torch.Generator().manual_seed(7)
    g_lp = torch.randn((c,), generator=gen, dtype=dtype)
    g_sites = torch.randn((c, spec.dim), generator=gen, dtype=dtype)
    before = dict(cuda_priors.LAUNCHES)
    got = _priors_on(dev, spec, theta, g_lp, g_sites)
    again = _priors_on(dev, spec, theta, g_lp, g_sites)
    assert cuda_priors.LAUNCHES == {k: v + 2 for k, v in before.items()}
    gaps = priors_gaps(got, priors_twin(spec, theta, g_lp, g_sites), cuda_priors.table_rows(spec.priors))
    print(f"priors {prior_set} C={c} {dtype}: {gaps}")
    assert gaps.pop("same_finite")
    assert max(gaps.values()) <= 1.0, gaps
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_priors_kernel_runs_once_each_way_a_value_and_grad_of_a_transition(dev, monkeypatch):
    """Over one NUTS transition of the flagship (4 chains of the committed
    adapted state, depth 6), kernel P's forward and backward each launch once
    a value+grad, and NUTS reads the device as often as in the same transition
    with the per-site code on the card: the kernel reads nothing back."""
    from pathlib import Path

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference import model, nuts
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.utils import load_warmup, profiling

    bench = Path(__file__).resolve().parents[1] / "benchmarks"
    spec = pop_cosmo_model_spec(load_pop_cosmo_data(bench / "flagship_catalog.npz", device=dev), 256, 1024,
                                device=dev)
    warm = load_warmup(bench / "flagship_warmup16.npz", device=dev)
    potential, c = model.make_potential(spec), 4
    theta = warm.state.theta[:c]
    gen = torch.Generator(device=dev).manual_seed(11)
    step = lambda s: nuts.nuts_transition(potential, s, warm.eps[:c], warm.cov[:c], warm.chol_cov[:c], gen, 6)  # noqa: E731
    state, _ = step(nuts.ChainState(theta, *model.value_and_grad(potential, theta)))
    torch.cuda.synchronize()
    start, gen_state = state, gen.get_state()
    counted = {}
    for route in ("kernel", "per_site"):
        if route == "per_site":
            monkeypatch.setattr(model, "log_prior_and_sites",
                                lambda sp, th: (model._log_prior_and_jac(sp, th), model.constrain(sp, th)))
        gen.set_state(gen_state)
        before = profiling.counters()
        _, stats = step(start)
        torch.cuda.synchronize()
        after = profiling.counters()
        counted[route] = {k: after[k] - before[k] for k in after}, stats.n_leapfrog.cpu()
    (kernel, n_kernel), (per_site, n_per_site) = counted["kernel"], counted["per_site"]
    print(f"priors engagement: {kernel['model.value_and_grads']} value+grads, {kernel['nuts.host_syncs']} host "
          f"syncs with the kernel, {per_site['nuts.host_syncs']} with the per-site code")
    assert kernel["model.value_and_grads"] > 1
    assert kernel["cuda_priors.priors_fwd"] == kernel["cuda_priors.priors_bwd"] == kernel["model.value_and_grads"]
    assert per_site["cuda_priors.priors_fwd"] == per_site["cuda_priors.priors_bwd"] == 0
    assert torch.equal(n_kernel, n_per_site)
    assert kernel["nuts.host_syncs"] == per_site["nuts.host_syncs"]


# ---------------------------------------------------------------------------
# Kernel F: the q-normalised families' joint route
# ---------------------------------------------------------------------------

# sites on the edges of the POWER-LAW+PEAK model, a chain each (cardbench/tests/test_cardbench_plpeak.py's
# EDGES); the broken power law takes those of its sites it shares
FAMILY_EDGES = {
    "h": (0.7, 0.36, 1.39, 0.68), "Om": (0.3, 0.02, 0.95, 0.31), "w": (-1.0, -1.45, -0.55, -0.9),
    "alpha": (2.5, 11.9, 1.0 - 1e-13, -3.9), "beta_q": (1.0, -3.9, 0.0, 11.9),
    "mmin": (8.0, 9.5, 2.1, 5.0), "mmax": (30.05, 99.9, 60.0, 45.0), "lam_peak": (0.3, 0.001, 0.5, 0.99),
    "mu_m": (45.0, 21.0, 35.0, 20.2), "sigma_m": (8.0, 9.9, 3.0, 1.01), "delta_m": (0.05, 9.95, 4.0, 0.001),
    "lam": (2.7, -1.2, 6.6, 0.0), "dkappa": (3.0, 1.1, 6.8, 2.0), "zp": (1.9, 0.05, 3.8, 1.0),
    "R_unit": (0.0, 1.0, -1.0, 0.5),
    # POWER LAW + SPLINE's heights at +-3 and in between, alternating from knot to knot in the last chain
    **{f"f_{i}": (3.0, -3.0, 0.5 * (i % 5) - 1.0, 3.0 * (-1) ** i) for i in range(1, 19)},
}
FAMILIES = ("plpeak", "brokenpl", "pspline")


def _family_case(dev, family, c, layout, dtype, seed=5, edges=False, nobs=8, nsamp=64, nsel=1024):
    """(data, sites) of a small joint fit of ``family`` on the card: one
    synthetic catalog shared by the chains, or (``per_chain``) four catalogs
    a chain each in turn; the sites at ``c`` prior draws, or at the model's
    edges (``c`` = 4)."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import ModelSpec, constrain, prior_sample
    from bumpcosmology_torch.testing import synthetic_pop_cosmo_data

    def cast(d):
        return lk.PopCosmoData(*(type(x)(*(t.to(dtype) for t in x)) for x in (d.events, d.selection)))

    cats = [cast(synthetic_pop_cosmo_data(nobs, nsamp, nsel, seed=3 + s, device=dev)) for s in range(4)]
    data = lk.stack_fleet([cats[i % 4] for i in range(c)]) if layout == "per_chain" else cats[0]
    spec = ModelSpec(priors=dict(lk.MASS_FAMILIES[family].cosmo_priors), loglike=None, device=torch.device("cpu"))
    theta = prior_sample(spec, torch.Generator().manual_seed(seed), shape=(c,)).to(dtype)
    sites = constrain(spec, theta)
    if edges:
        sites.update({k: torch.tensor(v, dtype=dtype) for k, v in FAMILY_EDGES.items() if k in sites})
    return data, {k: v.detach().to(dev) for k, v in sites.items()}


def _family_value_and_grad(family, data, sites, plain, n_grid=128, n_z=256, bounds=None, g=None):
    """``(lse_ev, lse_sel, {site: gradient}, launches)`` of the joint route:
    kernel F (``plain=False``) or its eager twin on the card; the gradient of
    the log-likelihood, or with ``g = (g_ev, g_sel)`` of the log-sum-exps
    weighted by them; ``launches`` the change of ``cuda_families.LAUNCHES``."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.ops import cuda_families

    build = lk.MASS_FAMILIES[family].build
    bounds = lk.dl_bounds_of(data, margin=0.1) if bounds is None else bounds
    leaves = {k: v.clone().requires_grad_(True) for k, v in sites.items()}
    before = dict(cuda_families.LAUNCHES)
    lse_ev, lse_sel = lk.pop_cosmo_segment_lse(leaves, data, n_grid, n_z, bounds, lk.query_table(data), plain, build)
    if g is None:
        nobs, nsamp = data.events.a.shape[-2:]
        loss = (lse_ev.sum(-1) - nobs * lse_sel).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    else:
        grads = torch.autograd.grad((lse_ev, lse_sel), list(leaves.values()), g, allow_unused=True)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in cuda_families.LAUNCHES.items() if v != before[k]}
    grads = {k: torch.zeros_like(v) if d is None else d for (k, v), d in zip(leaves.items(), grads)}
    return lse_ev.detach(), lse_sel.detach(), grads, launches


def _assert_family_close(got, ref):
    """The families' parity limits on the card: |d lse| / (1 + |lse|) < 2e-4,
    |d grad| / (1 + |grad|) < 5e-3, site by site."""
    for a, b in zip(got[:2], ref[:2]):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        fin = torch.isfinite(b)
        assert float(((a[fin] - b[fin]).abs() / (1 + b[fin].abs())).max()) < 2e-4
    for k, b in ref[2].items():
        a = got[2][k]
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()), k
        assert float(((a - b).abs() / (1 + b.abs())).max()) < 5e-3, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["shared", "per_chain"])
@pytest.mark.parametrize("c", [1, 4, 128])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_kernel_matches_the_eager_twin(dev, family, c, layout, dtype):
    """Kernel F's per-event and selection log-sum-exps and the gradient of
    the log-likelihood by every site against the eager twin on the card
    (``plain=True``), within the families' parity limits; F launches once
    each way, on the layout's counter, and the twin launches nothing of it."""
    data, sites = _family_case(dev, family, c, layout, dtype)
    got = _family_value_and_grad(family, data, sites, plain=False)
    ref = _family_value_and_grad(family, data, sites, plain=True)
    suffix = "_per_chain" if layout == "per_chain" else ""
    assert got[3] == {"families_fwd" + suffix: 1, "families_bwd" + suffix: 1} and ref[3] == {}
    _assert_family_close(got, ref)


def _on_cpu(data, sites):
    """(data, sites) moved to the CPU."""
    from bumpcosmology_torch.inference import likelihoods as lk

    return (lk.PopCosmoData(*(type(x)(*(t.cpu() for t in x)) for x in (data.events, data.selection))),
            {k: v.cpu() for k, v in sites.items()})


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("layout", ["shared", "per_chain"])
def test_pspline_kernel_in_float64_against_the_eager_twin_on_the_cpu(dev, layout, edges):
    """POWER LAW + SPLINE through kernel F in float64 against its eager twin
    in float64 on the CPU (whose gathers add in order): the log-sum-exps
    within 1e-10 of 1 + |twin's| (float64's rounding over a few hundred
    operations a row, summed in another order), and the gradient by every
    site within 1e-10 as well (the kernel's table cotangents are sums of
    contributions each rounded to at most 2^-41; the gaps read 1.9e-11 to
    4.0e-11 on an H100); the gaps are printed."""
    from bumpcosmology_torch.inference import likelihoods as lk

    data, sites = _family_case(dev, "pspline", 4, layout, torch.float64, edges=edges)
    bounds = lk.dl_bounds_of(data, margin=0.1)
    got = _family_value_and_grad("pspline", data, sites, plain=False, bounds=bounds)
    ref = _family_value_and_grad("pspline", *_on_cpu(data, sites), plain=True, bounds=bounds)
    gaps = {}
    for name, a, b in (("lse_ev", got[0], ref[0]), ("lse_sel", got[1], ref[1])):
        gaps[name] = float(((a.cpu() - b).abs() / (1 + b.abs())).max())
        assert gaps[name] < 1e-10, (name, gaps)
    for k, b in ref[2].items():
        gaps[k] = float(((got[2][k].cpu() - b).abs() / (1 + b.abs())).max())
    print("pspline float64 gaps", layout, edges, max(gaps.items(), key=lambda kv: kv[1]))
    assert max(v for k, v in gaps.items() if not k.startswith("lse")) < 1e-10, gaps


@pytest.mark.parametrize("n_z", [1024, 8192])
@pytest.mark.parametrize("family", ["plpeak", "pspline"])
def test_family_kernel_at_the_whole_catalog(dev, family, n_z):
    """The committed catalog whole, as ``gwtc3_pspline.nuts`` runs it: 56
    events x 256 PE samples and 24,576 injections, 38,912 rows a chain, 4
    chains at prior draws, float32, the q-norm table at 256 masses.  F
    against its eager twin on the card within the families' parity limits,
    on the backward's shared-memory route at n_z = 1,024 and its
    device-memory route at 8,192, and twice bit for bit."""
    import json

    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import ModelSpec, constrain, prior_sample
    from cardbench import harness

    config = json.loads((harness.BENCH_DIR / "configs" / "flagship_plpeak.json").read_text())
    raw = harness.read_catalog(harness.data_path(config, "catalog"))
    assert raw["ev_a"].shape == (56, 256) and raw["sel_a"].shape == (24576,)
    data = harness.program_data(raw, dev)
    spec = ModelSpec(priors=dict(lk.MASS_FAMILIES[family].cosmo_priors), loglike=None, device=torch.device("cpu"))
    sites = constrain(spec, prior_sample(spec, torch.Generator().manual_seed(23), shape=(4,)))
    sites = {k: v.detach().to(dev) for k, v in sites.items()}
    bounds = lk.dl_bounds_of(data)
    got = _family_value_and_grad(family, data, sites, plain=False, n_grid=256, n_z=n_z, bounds=bounds)
    route = "families_bwd" if n_z == 1024 else "families_bwd_global"
    assert got[3] == {"families_fwd": 1, route: 1}
    _assert_family_close(got, _family_value_and_grad(family, data, sites, plain=True, n_grid=256, n_z=n_z,
                                                     bounds=bounds))
    again = _family_value_and_grad(family, data, sites, plain=False, n_grid=256, n_z=n_z, bounds=bounds)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    for k, v in got[2].items():
        assert torch.equal(v.view(torch.int32), again[2][k].view(torch.int32)), k


def test_family_kernel_counts_its_launches_by_family(dev):
    """``cuda_families.BY_FAMILY`` tells a POWER LAW + SPLINE launch from a
    POWER-LAW+PEAK one, and ``profiling.counters()`` reads it."""
    from bumpcosmology_torch.ops import cuda_families
    from bumpcosmology_torch.utils import profiling

    for family in ("plpeak", "pspline"):
        data, sites = _family_case(dev, family, 4, "shared", torch.float32)
        before = dict(cuda_families.BY_FAMILY)
        _family_value_and_grad(family, data, sites, plain=False)
        delta = {k: v - before[k] for k, v in cuda_families.BY_FAMILY.items() if v != before[k]}
        assert delta == {f"{family}_fwd": 1, f"{family}_bwd": 1}
        assert profiling.counters()[f"cuda_families_by_family.{family}_bwd"] == cuda_families.BY_FAMILY[
            f"{family}_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_kernel_at_the_model_edges(dev, family, dtype):
    """The same at sites on the model's edges: alpha within 1e-13 of 1 (the
    power law's series branch), delta_m at 0.001 and 9.95, lam_peak at
    0.001 and 0.99, redshift parameters at their bounds, the spline's
    heights at +-3."""
    data, sites = _family_case(dev, family, 4, "shared", dtype, edges=True)
    _assert_family_close(_family_value_and_grad(family, data, sites, plain=False),
                         _family_value_and_grad(family, data, sites, plain=True))


@pytest.mark.parametrize("layout", ["shared", "per_chain"])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_kernel_backward_is_bit_identical_between_launches(dev, family, layout):
    """Two value+grads through kernel F give the same bits, with the shared
    query table and with one a chain: the table cotangents are summed in
    fixed point and the chain's sums in a fixed order."""
    data, sites = _family_case(dev, family, 4, layout, torch.float32)
    first = _family_value_and_grad(family, data, sites, plain=False)
    second = _family_value_and_grad(family, data, sites, plain=False)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for k, v in first[2].items():
        assert torch.equal(v.view(torch.int32), second[2][k].view(torch.int32)), k


@pytest.mark.parametrize("family", FAMILIES)
def test_family_kernel_gives_an_all_dead_segment_minus_infinity_and_no_gradient(dev, family):
    """An event whose rows all weigh -inf (log pdraw = +inf): F returns -inf
    for it and finite gradients under a non-zero cotangent of every
    segment, the same as the eager twin on the catalog without that event
    (whose own logsumexp backward would give NaN there)."""
    from bumpcosmology_torch.inference import likelihoods as lk

    data, sites = _family_case(dev, family, 4, "shared", torch.float32)
    bounds = lk.dl_bounds_of(data, margin=0.1)
    ev = data.events
    dead = data._replace(events=ev._replace(log_pdraw=torch.cat([torch.full_like(ev.log_pdraw[:1], float("inf")),
                                                                 ev.log_pdraw[1:]])))
    alive = data._replace(events=type(ev)(*(x[1:] for x in ev)))
    nobs = ev.a.shape[0]
    gen = torch.Generator().manual_seed(3)
    g_ev, g_sel = torch.rand((4, nobs), generator=gen).to(dev), torch.rand((4,), generator=gen).to(dev)
    got = _family_value_and_grad(family, dead, sites, plain=False, bounds=bounds, g=(g_ev, g_sel))
    ref = _family_value_and_grad(family, alive, sites, plain=True, bounds=bounds, g=(g_ev[:, 1:], g_sel))
    assert bool(torch.isneginf(got[0][:, 0]).all())
    _assert_family_close((got[0][:, 1:], got[1], got[2]), ref[:3])


@pytest.mark.parametrize("layout", ["shared", "per_chain"])
def test_family_kernel_backward_in_device_memory(dev, layout):
    """A detector table of 8,192 rows, beyond the backward's shared memory:
    the backward takes its device-memory route (``_global``), matches the
    twin, and repeats bit for bit."""
    data, sites = _family_case(dev, "plpeak", 4, layout, torch.float32)
    got = _family_value_and_grad("plpeak", data, sites, plain=False, n_z=8192)
    suffix = "_per_chain" if layout == "per_chain" else ""
    assert got[3] == {"families_fwd" + suffix: 1, "families_bwd_global" + suffix: 1}
    _assert_family_close(got, _family_value_and_grad("plpeak", data, sites, plain=True, n_z=8192))
    again = _family_value_and_grad("plpeak", data, sites, plain=False, n_z=8192)
    for k, v in got[2].items():
        assert torch.equal(v, again[2][k]), k


def kernel_f_digests(dev):
    """sha256 of kernel F's outputs for POWER-LAW+PEAK and BROKEN POWER LAW on
    fixed inputs: both types, both query layouts and both backward routes
    (n_z = 256 and 8,192), the per-event and selection log-sum-exps and the
    cotangents of the detector table, the q-norm table and the sites for
    fixed segment cotangents.  What a third family in the kernel must leave
    as it was."""
    import hashlib

    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table
    from bumpcosmology_torch.ops import cuda_families

    out = {}
    for family in ("plpeak", "brokenpl"):
        raw = hashlib.sha256()
        for dtype in (torch.float32, torch.float64):
            for layout in ("shared", "per_chain"):
                data, sites = _family_case(dev, family, 4, layout, dtype)
                bounds = lk.dl_bounds_of(data, margin=0.1)
                nobs, nsamp = data.events.a.shape[-2:]
                for n_z in (256, 8192):
                    with torch.no_grad():
                        det = build_detector_table(build_cosmology(lk.cosmo_from_sites(sites), n=n_z), *bounds, n=n_z)
                        pop = lk.MASS_FAMILIES[family].build(sites, 128, pivot=False)
                        scal = cuda_families.family_scalars(family, pop.params.mass, pop.params.redshift)
                    cols, nq, scal = (t.detach().contiguous().clone().requires_grad_(True)
                                      for t in (det.cols, pop.log_nq, scal))
                    lse_ev, lse_sel = cuda_families.family_lse(family, det._replace(cols=cols), nq, pop.dm, scal,
                                                               lk.query_table(data), nobs, nsamp)
                    gen = torch.Generator().manual_seed(17)
                    g = [torch.rand(x.shape, generator=gen, dtype=torch.float64).to(device=dev, dtype=dtype)
                         for x in (lse_ev, lse_sel)]
                    for x in (lse_ev, lse_sel, *torch.autograd.grad((lse_ev, lse_sel), (cols, nq, scal), g)):
                        raw.update(x.detach().cpu().numpy().tobytes())
        out[family] = raw.hexdigest()
    return out


# kernel_f_digests on an H100 80GB HBM3 (sm_90a, ops/_build.py's flags), taken from the kernel before POWER LAW +
# SPLINE joined it
KERNEL_F_DIGESTS = {"plpeak": "6ffae2de9b6796f7c8b019d6f4ce40dd1bbc08b0be329878578feebc3804c467",
                    "brokenpl": "e8149cf6c843192ff6e69ce456bf678a1cc93b30aee66c7358ff1e84ff548614"}


def test_family_kernel_gives_the_bits_it_gave_before_the_spline(dev):
    """Kernel F gives POWER-LAW+PEAK and BROKEN POWER LAW the bits it gave
    before POWER LAW + SPLINE's spline table joined it."""
    if torch.cuda.get_device_capability(dev) != (9, 0):
        pytest.skip("the digests were taken on an sm_90 card")
    assert kernel_f_digests(dev) == KERNEL_F_DIGESTS


def kernel_b_digests(dev):
    """sha256 of kernel B's outputs on fixed inputs, both epilogues, both
    directions, both query layouts and both backward routes (K = 1,024 and
    8,192), and of the bump's joint value+grad at 4 chains of the committed
    flagship state: what the shared skeleton (``csrc/rows.cuh``) must leave
    as it was."""
    import hashlib
    from pathlib import Path

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad
    from bumpcosmology_torch.utils import load_warmup

    rng = np.random.default_rng(2021)
    raw = hashlib.sha256()
    c, nobs, nsamp, nsel = 4, 16, 128, 2048
    n = nobs * nsamp + nsel
    for k in (1024, 8192):
        tables, qry = _logwts_inputs(rng, dev, c, k, 256, n)
        for q in (qry, torch.stack([qry[torch.as_tensor(rng.permutation(n), device=dev)] for _ in range(c)])):
            out = cuda_logwts._logwts_fwd_cuda(*tables, q)
            g = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32), device=dev) * torch.isfinite(out)
            lse_ev, lse_sel = cuda_logwts._logwts_lse_fwd_cuda(*tables, q, nobs, nsamp)
            g_ev = torch.as_tensor(rng.normal(size=(c, nobs)).astype(np.float32), device=dev)
            g_sel = torch.as_tensor(rng.normal(size=c).astype(np.float32), device=dev)
            for x in (out, *cuda_logwts._logwts_bwd_cuda(*tables, q, g), lse_ev, lse_sel,
                      *cuda_logwts._logwts_lse_bwd_cuda(*tables, q, lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp)):
                raw.update(x.cpu().numpy().tobytes())
    bench = Path(cuda_logwts.__file__).resolve().parents[2] / "benchmarks"
    spec = pop_cosmo_model_spec(load_pop_cosmo_data(bench / "flagship_catalog.npz", device=dev), 256, 1024,
                                device=dev)
    theta = load_warmup(bench / "flagship_warmup16.npz", device=dev).state.theta[:4]
    vg = hashlib.sha256()
    for x in value_and_grad(make_potential(spec), theta):
        vg.update(x.cpu().numpy().tobytes())
    return {"kernel_b": raw.hexdigest(), "bump_value_and_grad": vg.hexdigest()}


# kernel_b_digests on an H100 80GB HBM3 (sm_90a, ops/_build.py's flags): kernel B's from before kernel F shared
# its skeleton; the bump's value+grad since kernel T builds its detector table (T's prefix sum adds in another
# order than torch.cumsum, so the table's bits, and the value+grad's, are T's)
KERNEL_B_DIGESTS = {"kernel_b": "3f28a53468168c7c173f5622140426ba1ade76cafba5e515e16b4fc63ca0cf5a",
                    "bump_value_and_grad": "b120d8ab7dd6fd4026d22c0696705e041449e2ab9adf47f7badbf88779fce1bb"}


def test_kernel_b_gives_the_bits_it_gave_before_the_shared_skeleton(dev):
    """Kernel B gives the same bits as before ``csrc/rows.cuh`` took its
    skeleton out of ``logwts.cu``, and the bump's joint value+grad through it
    and kernel T the bits it gave when T took the tables."""
    if torch.cuda.get_device_capability(dev) != (9, 0):
        pytest.skip("the digests were taken on an sm_90 card")
    assert kernel_b_digests(dev) == KERNEL_B_DIGESTS


# ---------------------------------------------------------------------------
# Kernel T: the cosmology and detector tables
# ---------------------------------------------------------------------------


def _tables_sites(dev, c, dtype, seed=7):
    """(h, Om, w) at ``c`` draws of the joint model's priors, on ``dev``."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import ModelSpec, constrain, prior_sample

    spec = ModelSpec(priors={k: lk.POP_COSMO_PRIORS[k] for k in ("h", "Om", "w")}, loglike=None,
                     device=torch.device("cpu"))
    theta = prior_sample(spec, torch.Generator().manual_seed(seed), shape=(c,)).double()
    return tuple(x.to(dtype).to(dev) for x in constrain(spec, theta).values())


def _tables_value_and_grad(sites, n, g, kernel, dl_bounds=(0.03, 14.0)):
    """``(cols, (3, C) cotangents of h, Om, w, launches)`` of the detector
    table by kernel T (``kernel``) or by the eager table code, for the table's
    cotangent ``g``; ``launches`` the change of ``cuda_tables.LAUNCHES``."""
    from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table, kernel_detector_table
    from bumpcosmology_torch.models.parameters import CosmoParams
    from bumpcosmology_torch.ops import cuda_tables

    leaves = [x.clone().requires_grad_(True) for x in sites]
    before = dict(cuda_tables.LAUNCHES)
    if kernel:
        cols = kernel_detector_table(CosmoParams(*leaves), *dl_bounds, n=n).cols
    else:
        cols = build_detector_table(build_cosmology(CosmoParams(*leaves), n=n), *dl_bounds, n=n).cols
    grads = torch.autograd.grad((cols * g).sum(), leaves)
    if cols.is_cuda:
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in cuda_tables.LAUNCHES.items() if v != before[k]}
    return cols.detach(), torch.stack(grads), launches


def _rel_gap(a, b):
    a, b = a.double(), b.double()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    fin = ~torch.isnan(b)
    return float(((a[fin] - b[fin]).abs() / (1 + b[fin].abs())).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1, 4, 128])
@pytest.mark.parametrize("n", [1024, 8192])
def test_tables_kernel_matches_the_eager_twin(dev, n, c, dtype):
    """Kernel T's detector table and the cotangents of h, Om and w for a
    random cotangent of the table, against the eager table code (the twin) in
    float64 on the CPU, whose gathers add their cotangents in order (the
    card's deterministic gather rounds each to a fixed point of n 2^-52 of
    its row's largest, which cancellation in the chain rule lifts to 1e-9 to
    1e-7 of the sites' cotangents): float64 within 1e-10 of 1 + |twin's|;
    float32 as close to it as the twin's own float32 on the card comes,
    within four times its gap.  T launches once each way, the twin none;
    n = 8,192 puts a chain's arrays in device memory."""
    sites = _tables_sites(dev, c, dtype)
    g = torch.randn((c, n, 2), generator=torch.Generator().manual_seed(3), dtype=torch.float64).to(dtype).to(dev)
    got = _tables_value_and_grad(sites, n, g, kernel=True)
    ref = _tables_value_and_grad(sites, n, g, kernel=False)
    assert got[2] == {"tables_fwd": 1, "tables_bwd": 1} and ref[2] == {}
    cpu = torch.device("cpu")
    truth = _tables_value_and_grad(tuple(x.to(cpu, torch.float64) for x in sites), n, g.to(cpu, torch.float64),
                                   kernel=False)
    for a, b, t in zip(got[:2], ref[:2], truth[:2]):
        a, b = a.cpu(), b.cpu()
        if dtype == torch.float64:
            assert _rel_gap(a, t) < 1e-10
        else:
            assert _rel_gap(a, t) <= 4 * _rel_gap(b, t)


def test_tables_kernel_repeats_bit_for_bit_and_a_chain_does_not_depend_on_the_others(dev):
    """Two value+grads through kernel T give the same bits, and a chain's
    table and cotangents are the same bits alone or among 4 or 128."""
    sites = _tables_sites(dev, 128, torch.float32)
    g = torch.randn((128, 1024, 2), generator=torch.Generator().manual_seed(5)).to(dev)
    first = _tables_value_and_grad(sites, 1024, g, kernel=True)
    second = _tables_value_and_grad(sites, 1024, g, kernel=True)
    for a, b in zip(first[:2], second[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for idx in ([5], [0, 3, 64, 127]):
        part = _tables_value_and_grad(tuple(x[idx] for x in sites), 1024, g[idx], kernel=True)
        assert torch.equal(part[0], first[0][idx]) and torch.equal(part[1], first[1][:, idx])


def test_tables_kernel_calls_no_synchronising_function(dev):
    """Kernel T's forward and backward under CUDA's sync debug mode: no
    synchronising call (the wrapper reads nothing back)."""
    import warnings

    sites = _tables_sites(dev, 4, torch.float32)
    g = torch.randn((4, 1024, 2), generator=torch.Generator().manual_seed(5)).to(dev)
    _tables_value_and_grad(sites, 1024, g, kernel=True)  # the library's load and the route's first read
    from bumpcosmology_torch.models.cosmology import kernel_detector_table
    from bumpcosmology_torch.models.parameters import CosmoParams

    leaves = [x.clone().requires_grad_(True) for x in sites]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cols = kernel_detector_table(CosmoParams(*leaves), 0.03, 14.0, n=1024).cols
            torch.autograd.grad((cols * g).sum(), leaves)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]


@pytest.mark.parametrize("family", ["bump", "plpeak", "brokenpl"])
def test_tables_kernel_runs_once_each_way_a_value_and_grad_of_a_transition(dev, family):
    """Over a NUTS transition of each family's joint potential on the card
    (4 chains from prior draws on a synthetic catalog, depth 4), kernel T
    launches once forward and once backward a value+grad."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference import nuts
    from bumpcosmology_torch.inference.model import ModelSpec, make_potential, prior_sample, value_and_grad
    from bumpcosmology_torch.testing import synthetic_pop_cosmo_data
    from bumpcosmology_torch.utils import profiling

    fam = lk.MASS_FAMILIES[family]
    data = synthetic_pop_cosmo_data(8, 64, 1024, seed=3, device=dev)
    spec = fam.cosmo_spec(data, n_grid=128, n_z=1024, device=dev)
    potential, c = make_potential(spec), 4
    theta = prior_sample(ModelSpec(priors=dict(spec.priors), loglike=None, device=torch.device("cpu")),
                         torch.Generator().manual_seed(9), shape=(c,)).to(dev)
    state = nuts.ChainState(theta, *value_and_grad(potential, theta))
    dim = theta.shape[1]
    eye = torch.eye(dim, device=dev).expand(c, dim, dim).contiguous()
    gen = torch.Generator(device=dev).manual_seed(13)
    before = profiling.counters()
    _, stats = nuts.nuts_transition(potential, state, torch.full((c,), 1e-3, device=dev), eye, eye, gen, 4)
    torch.cuda.synchronize()
    after = profiling.counters()
    delta = {k: after[k] - before[k] for k in after}
    assert int(stats.n_leapfrog.max()) > 1 and delta["model.value_and_grads"] > 1
    assert delta["cuda_tables.tables_fwd"] == delta["cuda_tables.tables_bwd"] == delta["model.value_and_grads"]
