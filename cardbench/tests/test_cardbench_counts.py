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
