"""The yardstick: the card's peaks and the work one batched value+grad of
the bump joint potential needs, counted from shapes.

Frozen copy of ``chip_smoke.py`` (lines 261-302 and 391-401 at commit
fb8d8bd): the H100 SXM peaks of NVIDIA's data sheet and the FP32
operations per unit of work, tallied there from ``csrc/bump.cu`` and
``csrc/logwts.cu`` (each exp/log/log1p one operation).  The counts are of
the work these inputs need, whatever implements it: kernel A fills and
log-trapezoids a ``(G, G)`` grid per chain, kernel B weighs every
chain-query against the per-chain tables and reduces each event's and the
selection's rows by log-sum-exp.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9  # the H100 SXM's boost clock, used where nvidia-smi cannot be read

OPS_A_FWD_PER_CELL = 9
OPS_A_BWD_PER_CELL = 16
SFU_A_PER_CELL = 1
OPS_B_FWD_PER_QUERY = 97
OPS_B_BWD_PER_QUERY = 185
OPS_B_LSE_FWD_EXTRA = 4
OPS_B_LSE_BWD_EXTRA = 3


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time in seconds: the larger of bytes over the HBM rate and
    FP32 operations over the FP32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def leapfrog_ops(chains: int, n_grid: int, queries: int) -> float:
    """FP32 operations of one batched value+grad of ``chains`` chains:
    kernel A forward and backward over ``n_grid``² cells a chain, kernel B's
    ``lse`` forward and backward over ``queries`` rows a chain."""
    a = n_grid * n_grid * (OPS_A_FWD_PER_CELL + OPS_A_BWD_PER_CELL)
    b = queries * (OPS_B_FWD_PER_QUERY + OPS_B_LSE_FWD_EXTRA + OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA)
    return float(chains) * (a + b)


def a_bump_bound_s(chains: int, n_grid: int, clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    """Kernel A's forward plus backward bound for ``chains`` chains: each the
    largest of bytes, FP32 operations and one special-function result per
    cell at 16 a clock per SM (``bound_a`` of ``chip_smoke.py``)."""
    cells = chains * n_grid * n_grid
    sfu = cells * SFU_A_PER_CELL / (SFU_PER_CLOCK_PER_SM * H100_SMS * clock_hz)
    fwd = max(bound_s(chains * 5 * 4 + chains * n_grid * 4, cells * OPS_A_FWD_PER_CELL), sfu)
    bwd = max(bound_s(chains * 5 * 4 * 2 + 2 * chains * n_grid * 4, cells * OPS_A_BWD_PER_CELL), sfu)
    return fwd + bwd


def b_lse_bwd_bound_s(chains: int, queries: int, n_z: int, n_grid: int, nobs: int, per_chain: bool) -> float:
    """Kernel B's ``lse`` backward bound for ``chains`` chains: the query
    rows (16 bytes each, once, or once a chain for per-chain tables), the
    tables and their cotangents, the segment log-sum-exps and their
    cotangents; 185 + 3 operations a chain-query."""
    table_bytes = chains * (n_z * 8 + n_grid * 4 + 15 * 4)
    seg_bytes = chains * (nobs + 1) * 4
    query_bytes = (chains if per_chain else 1) * queries * 16
    return bound_s(query_bytes + 2 * table_bytes + 2 * seg_bytes,
                   chains * queries * (OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA))
