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


@pytest.mark.parametrize("family", ["plpeak", "brokenpl"])
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
