"""The frozen work counts against the bounds the port's records give
(PERF.md, the table of TPU kernels: H100 SXM peaks, chip_smoke.py's counts)."""
import pytest

from cardbench import counts


def test_kernel_a_bound_at_the_flagship_shape():
    # A-fwd 0.000251 ms and A-bwd 0.000251 ms at C = 16, G = 256, both set by the special-function unit
    assert 1e3 * counts.a_bump_bound_s(16, 256) == pytest.approx(0.000502, rel=2e-3)


def test_kernel_b_lse_backward_bound_at_the_flagship_shape():
    # B-bwd lse 0.00175 ms (operations) at 16 chains x 38,912 queries, K = 1,024, G = 256
    assert 1e3 * counts.b_lse_bwd_bound_s(16, 38912, 1024, 256, 56, per_chain=False) == pytest.approx(
        0.00175, rel=3e-3)


def test_leapfrog_operations():
    # 16 x 256^2 x 25 + 16 x 38,912 x 289 (PERF.md's flagship sizing), and the cell's 4 x 256^2 x 25 + 4 x 8,192 x 289
    assert counts.leapfrog_ops(16, 256, 38912) == pytest.approx(2.06e8, rel=2e-3)
    assert counts.leapfrog_ops(4, 256, 56 * 128 + 1024) == 4 * 256 * 256 * 25 + 4 * 8192 * 289


def test_the_bump_count_is_todays_formula_at_the_flagship_shapes():
    queries = 56 * 128 + 1024
    today = 4 * (256 * 256 * (9 + 16) + queries * (97 + 4 + 185 + 3))
    assert counts.leapfrog_ops(4, 256, queries) == counts.leapfrog_ops(4, 256, queries, "bump") == today


@pytest.mark.parametrize("family", ["bump", "plpeak", "brokenpl"])
def test_a_familys_count_is_linear_in_chains_and_in_queries(family):
    ops = lambda c, n: counts.leapfrog_ops(c, 256, n, family)  # noqa: E731
    assert ops(8, 8192) == 2 * ops(4, 8192) == 8 * ops(1, 8192)
    assert ops(4, 8192) - ops(4, 4096) == ops(4, 4096) - ops(4, 0) > 0
    assert ops(1, 0) > 0  # the per-chain tables


def test_the_families_counts_at_the_flagship_shapes():
    """A chain-query of POWER-LAW+PEAK takes 123 + 119 operations, of BROKEN
    POWER LAW 116 + 108; the q-normalisation table 256 x 128 cells of 52 and
    256 x 127 segments of 20, and the pivot one evaluation a chain."""
    per_query = {f: sum(a + b for _, a, b in counts.FAMILY_QUERY_OPS[f]) for f in ("plpeak", "brokenpl")}
    assert per_query == {"plpeak": 242, "brokenpl": 224}
    grid = 256 * 128 * 52 + 256 * 127 * 20
    assert counts.leapfrog_ops(4, 256, 8192, "plpeak") == 4 * (8192 * 242 + grid + 198)
    assert counts.leapfrog_ops(4, 256, 8192, "brokenpl") == 4 * (8192 * 224 + grid + 180)


def test_mfu_reads_the_bump_as_before():
    """``mfu.leapfrog`` on a fixed window: today's count for the bump."""
    from cardbench import harness

    w = harness.Window(1.0)
    w.entries, w.chains, w.close_t = [0.0, 0.02, 0.05, 0.06], [4, 2, 3, 4], 0.1
    run = harness.Run(w, {}, dict(family="bump", n_grid=256, n_z=1024, queries=8192, nobs=56, per_chain=False),
                      counts.H100_MAX_SM_CLOCK_HZ)
    ops = sum(c * (256 * 256 * 25 + 8192 * 289) for c in (4, 2, 3, 4))
    assert harness.load_reader("mfu.leapfrog")(run) == pytest.approx(100.0 * ops / 0.1 / 67e12, rel=1e-12)
    run.shapes["family"] = "plpeak"
    assert harness.load_reader("mfu.leapfrog")(run) == pytest.approx(
        100.0 * sum(counts.leapfrog_ops(c, 256, 8192, "plpeak") for c in (4, 2, 3, 4)) / 0.1 / 67e12, rel=1e-12)
