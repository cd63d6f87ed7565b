"""The priors and transforms on the CPU, and the table that the CUDA kernel
of the priors (``csrc/priors.cu``) reads.

The CPU takes the per-site code of ``inference/model.py`` unchanged; these
tests hold ``model.log_prior_and_sites`` to it bit for bit, hold each prior
family's row of the kernel's table to its codes and float64 constants, and
hold the kernel's algebra, written here in tensor code from the table as
``csrc/priors.cu`` writes it, to the per-site code and its autograd
gradient.  The kernel itself is held to the same code on the card
(``tests/test_torch_cuda.py``).
"""
import math

import pytest
import torch

from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal, Uniform, _trunc_log_z
from bumpcosmology_torch.inference.model import (
    ModelSpec,
    log_prior_and_sites,
    make_potential,
    value_and_grad,
)
from bumpcosmology_torch.ops import cuda_priors as kp
from bumpcosmology_torch.ops.special import softplus
from bumpcosmology_torch.testing import PRIOR_SETS, prior_thetas, priors_gaps, priors_twin
from bumpcosmology_torch.utils import profiling

INF = math.inf

ROWS = {
    "normal": (Normal(1.5, 2.0), (kp.IDENTITY, kp.NORMAL, 1.5, 2.0, -INF, INF, 0.0, 0.0, math.log(2.0), 0.0)),
    "uniform": (Uniform(-6.5, -0.5), (kp.SIGMOID, kp.UNIFORM, 0.0, 1.0, -6.5, -0.5, 6.0, math.log(6.0), 0.0, 0.0)),
    "trunc_both": (TruncatedNormal(0.3, 0.15, low=0.0, high=1.0),
                   (kp.SIGMOID, kp.TRUNCATED_NORMAL, 0.3, 0.15, 0.0, 1.0, 1.0, 0.0, math.log(0.15),
                    _trunc_log_z(0.3, 0.15, 0.0, 1.0))),
    "trunc_low": (TruncatedNormal(2.0, 2.0, low=1.0),
                  (kp.EXP_ABOVE_LOW, kp.TRUNCATED_NORMAL, 2.0, 2.0, 1.0, INF, 0.0, 0.0, math.log(2.0),
                   _trunc_log_z(2.0, 2.0, 1.0, None))),
    "trunc_high": (TruncatedNormal(-1.0, 0.5, high=0.25),
                   (kp.EXP_BELOW_HIGH, kp.TRUNCATED_NORMAL, -1.0, 0.5, -INF, 0.25, 0.0, 0.0, math.log(0.5),
                    _trunc_log_z(-1.0, 0.5, None, 0.25))),
    "trunc_none": (TruncatedNormal(0.5, 3.0),
                   (kp.IDENTITY, kp.TRUNCATED_NORMAL, 0.5, 3.0, -INF, INF, 0.0, 0.0, math.log(3.0), 0.0)),
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_each_prior_family_maps_to_its_codes_and_float64_constants(case):
    dist, expected = ROWS[case]
    (row,) = kp.table_rows({"x": dist})
    assert len(row) == len(kp.COLUMNS)
    assert row == expected, dict(zip(kp.COLUMNS, row))
    if case.startswith("trunc_") and case != "trunc_none":
        assert row[kp.COLUMNS.index("log_z")] == dist._log_z() < 0.0


def test_priors_of_two_families_with_the_same_numbers_get_two_tables():
    """A NamedTuple hashes as its fields, so ``Normal(0, 1)`` and
    ``Uniform(0, 1)`` are equal tuples; the kernel's table of each is its own."""
    normal, uniform = {"x": Normal(0.0, 1.0)}, {"x": Uniform(0.0, 1.0)}
    assert kp.table_rows(normal) != kp.table_rows(uniform)
    cpu = torch.device("cpu")
    for first, second in ((normal, uniform), (uniform, normal)):
        kp._TABLES.clear()
        a, b = kp.device_table(first, cpu, torch.float32), kp.device_table(second, cpu, torch.float32)
        assert a.tolist() == [list(map(float, kp.table_rows(first)[0]))]
        assert b.tolist() == [list(map(float, kp.table_rows(second)[0]))]
        assert not torch.equal(a, b)
    assert kp.device_table(normal, cpu, torch.float32) is kp.device_table(dict(normal), cpu, torch.float32)


class _Laplace:
    def constrain(self, u):
        return u


def test_an_unknown_prior_type_raises_when_the_potential_is_built():
    spec = ModelSpec(priors={"x": Normal(0.0, 1.0), "y": _Laplace()}, loglike=lambda s: 0.0 * s["x"])
    with pytest.raises(ValueError, match="_Laplace"):
        make_potential(spec)


def test_counters_list_the_priors_kernel_and_the_cpu_leaves_them_at_zero():
    spec = ModelSpec(priors=dict(PRIOR_SETS["every_case"]), loglike=lambda s: 0.0 * s["normal"])
    before = profiling.counters()
    assert {"cuda_priors.priors_fwd", "cuda_priors.priors_bwd"} <= set(before)
    value_and_grad(make_potential(spec), prior_thetas(3, spec.dim))
    after = profiling.counters()
    assert after["model.value_and_grads"] == before["model.value_and_grads"] + 1
    assert after["cuda_priors.priors_fwd"] == before["cuda_priors.priors_fwd"] == 0
    assert after["cuda_priors.priors_bwd"] == before["cuda_priors.priors_bwd"] == 0


def _cotangents(theta, seed=1):
    gen = torch.Generator().manual_seed(seed)
    c, dim = theta.shape
    return (torch.randn((c,), generator=gen, dtype=theta.dtype),
            torch.randn((c, dim), generator=gen, dtype=theta.dtype))


@pytest.mark.parametrize("prior_set", sorted(PRIOR_SETS))
def test_the_cpu_route_is_the_per_site_code_bit_for_bit(prior_set):
    spec = ModelSpec(priors=dict(PRIOR_SETS[prior_set]), loglike=None)
    theta = prior_thetas(7, spec.dim, seed=5)
    g_lp, g_sites = _cotangents(theta)
    lp_ref, sites_ref, grad_ref, _ = priors_twin(spec, theta, g_lp, g_sites)
    th = theta.clone().requires_grad_(True)
    lp, sites = log_prior_and_sites(spec, th)
    assert list(sites) == list(spec.names)
    loss = (g_lp * lp).sum() + sum((g_sites[:, i] * sites[k]).sum() for i, k in enumerate(spec.names))
    (grad,) = torch.autograd.grad(loss, th)
    assert torch.equal(lp, lp_ref)
    assert torch.equal(torch.stack([sites[k] for k in spec.names], -1), sites_ref)
    assert torch.equal(grad, grad_ref)


def _kernel_algebra(table, theta, g_lp, g_sites):
    """What ``csrc/priors.cu`` computes, in tensor code from the table: the
    forward's operations in the kernel's order and its analytic backward."""
    col = {name: table[:, k].to(theta.dtype) for k, name in enumerate(kp.COLUMNS)}
    tr, de = table[:, 0].long(), table[:, 1].long()
    u = theta
    s = 1.0 / (1.0 + torch.exp(-u))
    e = torch.exp(u)
    x = torch.where(tr == kp.SIGMOID, col["low"] + col["width"] * s,
                    torch.where(tr == kp.EXP_ABOVE_LOW, col["low"] + e,
                                torch.where(tr == kp.EXP_BELOW_HIGH, col["high"] - e, u)))
    z = (x - col["loc"]) / col["scale"]
    inside = (de == kp.NORMAL) | ((x >= col["low"]) & (x <= col["high"]))
    normal = (((-0.5 * z) * z - 0.5 * math.log(2.0 * math.pi)) - col["log_scale"]) - col["log_z"]
    lp = torch.where(inside, torch.where(de == kp.UNIFORM, -col["log_width"], normal), -math.inf)
    lj = torch.where(tr == kp.SIGMOID, (col["log_width"] - softplus(-u)) - softplus(u),
                     torch.where(tr == kp.IDENTITY, torch.zeros_like(u), u))
    total = torch.zeros_like(u[:, 0])
    for i in range(u.shape[1]):
        total = (total + lp[:, i]) + lj[:, i]
    g = g_lp[:, None]
    g_x = torch.where((de == kp.UNIFORM) | ~inside, torch.zeros_like(u), (-(g * z)) / col["scale"])
    g_jac = torch.where(tr == kp.SIGMOID, g * -torch.tanh(0.5 * u),
                        torch.where(tr == kp.IDENTITY, torch.zeros_like(u), g.expand_as(u)))

    def through(gv):
        return torch.where(tr == kp.SIGMOID, ((gv * col["width"]) * (1.0 - s)) * s,
                           torch.where(tr == kp.EXP_ABOVE_LOW, gv * e,
                                       torch.where(tr == kp.EXP_BELOW_HIGH, (-gv) * e, gv)))

    return total, x, through(g_sites) + (through(g_x) + g_jac)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("prior_set", sorted(PRIOR_SETS))
def test_the_kernels_algebra_from_the_table_matches_the_per_site_code(prior_set, dtype):
    spec = ModelSpec(priors=dict(PRIOR_SETS[prior_set]), loglike=None)
    rows = kp.table_rows(spec.priors)
    table = torch.tensor(rows, dtype=torch.float64)
    theta = prior_thetas(64, spec.dim, seed=2, dtype=dtype)
    g_lp, g_sites = _cotangents(theta)
    gaps = priors_gaps(_kernel_algebra(table, theta, g_lp, g_sites), priors_twin(spec, theta, g_lp, g_sites), rows)
    assert gaps.pop("same_finite")
    assert max(gaps.values()) <= 1.0, gaps
