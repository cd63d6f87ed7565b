"""Port parity, L0: integrate and interp against the JAX package on the same inputs.

Tolerances: float32 on both sides, same formulas; the only differences are
summation order (cumsum, logsumexp) — rtol 1e-6 / atol 1e-6 unless stated.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_torch.ops import integrate as tint
from bumpcosmology_torch.ops import interp as tinterp

# the JAX package's ops/__init__ re-exports functions under the module names
jint = importlib.import_module("bumpcosmology_tpu.ops.integrate")
jinterp = importlib.import_module("bumpcosmology_tpu.ops.interp")

RTOL = ATOL = 1e-6


def _pair(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("name", ["cumtrapz", "trapz", "log_trapz"])
def test_integrate_matches_jax(name):
    rng = np.random.default_rng(0)
    xs = np.sort(rng.uniform(0.0, 5.0, size=(3, 40)), axis=1)
    ys = rng.normal(size=(3, 40))
    (jx, tx), (jy, ty) = _pair(xs), _pair(ys)
    ref = np.asarray(getattr(jint, name)(jy, jx, axis=1))
    got = getattr(tint, name)(ty, tx, axis=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # 1-D grid shared by a batch
    ref1 = np.asarray(getattr(jint, name)(jy, jx[0], axis=-1))
    got1 = getattr(tint, name)(ty, tx[0], axis=-1).numpy()
    np.testing.assert_allclose(got1, ref1, rtol=RTOL, atol=ATOL)


def test_interp_value_and_grad_match_jax():
    """searchsorted gather form, with gradients to queries and both tables."""
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0.0, 10.0, 30)).astype(np.float32)
    fp = rng.normal(size=30).astype(np.float32)
    x = rng.uniform(-1.0, 11.0, 50).astype(np.float32)  # includes both clamped ends
    g = rng.normal(size=50).astype(np.float32)

    def jloss(x, xp, fp):
        return jnp.vdot(jnp.asarray(g), jinterp.interp(x, xp, fp, method="gather"))

    ref_v = np.asarray(jinterp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp), method="gather"))
    ref_g = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    tx, txp, tfp = (torch.tensor(a, requires_grad=True) for a in (x, xp, fp))
    out = tinterp.interp(tx, txp, tfp)
    np.testing.assert_allclose(out.detach().numpy(), ref_v, rtol=RTOL, atol=ATOL)
    (out * torch.as_tensor(g)).sum().backward()
    for t, r in zip((tx, txp, tfp), ref_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_interp_batched_tables():
    """A (C, K) table batch with (C, M) queries equals C separate lookups."""
    rng = np.random.default_rng(2)
    xp = np.sort(rng.uniform(0.0, 10.0, (3, 20)), axis=1).astype(np.float32)
    fp = rng.normal(size=(3, 20)).astype(np.float32)
    x = rng.uniform(0.0, 10.0, (3, 7)).astype(np.float32)
    got = tinterp.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    for c in range(3):
        ref = np.asarray(jinterp.interp(jnp.asarray(x[c]), jnp.asarray(xp[c]), jnp.asarray(fp[c]),
                                        method="gather"))
        np.testing.assert_allclose(got[c], ref, rtol=RTOL, atol=ATOL)


def test_interp_unit_spaced_matches_jax():
    rng = np.random.default_rng(3)
    fp = rng.normal(size=(2, 33)).astype(np.float32)
    cols = rng.normal(size=(2, 33, 2)).astype(np.float32)
    x = rng.uniform(-0.5, 4.5, (2, 40)).astype(np.float32)
    x0, dx = 0.25, 0.125
    got = tinterp.interp_unit_spaced(torch.as_tensor(x), x0, dx, torch.as_tensor(fp)).numpy()
    gotc = tinterp.interp_unit_spaced_columns(torch.as_tensor(x), x0, dx, torch.as_tensor(cols)).numpy()
    for c in range(2):
        ref = np.asarray(jinterp.interp_unit_spaced(jnp.asarray(x[c]), x0, dx, jnp.asarray(fp[c]),
                                                    method="gather"))
        refc = np.asarray(jinterp.interp_unit_spaced(jnp.asarray(x[c]), x0, dx, jnp.asarray(cols[c]),
                                                     method="gather"))
        np.testing.assert_allclose(got[c], ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gotc[c], refc, rtol=RTOL, atol=ATOL)


def test_table_fetch_is_full_fp32():
    """Precision rule: a fetch at a knot returns the table value bit for bit.

    A one-hot matmul in TF32 (or a TPU default-precision dot) keeps about 10
    (or 8) mantissa bits and would fail this exactly; the gather cannot."""
    rng = np.random.default_rng(4)
    fp = torch.as_tensor((1.0 + rng.random(257)).astype(np.float32) * 1e3)
    x = torch.arange(257, dtype=torch.float32) * 0.5 + 1.0  # every knot of 1 + k/2
    got = tinterp.interp_unit_spaced(x, 1.0, 0.5, fp)
    assert torch.equal(got, fp)
    import bumpcosmology_torch.inference.likelihoods  # noqa: F401  (the whole main path)

    assert not torch.backends.cuda.matmul.allow_tf32


def test_unit_bracket_takes_a_nan_position_as_the_reference_does():
    """A diverging trajectory reaches NaN parameters: the gather must not see
    an index cast from NaN (it raised here; JAX's gather clamps).  The value is
    NaN, as JAX's; kernel B's twin takes the same bracket (index 0, as the
    kernel's ``fmaxf``)."""
    from bumpcosmology_torch.ops import cuda_logwts

    fp = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    x = np.array([0.3, np.nan, np.inf, -np.inf], np.float32)
    ref = jinterp._interp_unit_gather(jnp.asarray(x), 0.0, 0.125, jnp.asarray(fp))
    got = tinterp.interp_unit_spaced(torch.as_tensor(x), 0.0, 0.125, torch.as_tensor(fp))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert np.isnan(got[1].item())
    batched = tinterp.interp_unit_spaced(torch.as_tensor(x)[None], 0.0, 0.125, torch.as_tensor(fp)[None])
    assert torch.equal(batched[0].isnan(), got.isnan())
    lo, t, slope = cuda_logwts._bracket(torch.tensor([2.5, float("nan")]), 8)
    assert lo.tolist() == [2, 0] and t.isnan().tolist() == [False, True] and slope.tolist() == [True, False]


@pytest.mark.parametrize("ncol", [1, 2])
def test_table_row_cotangents_sum_the_same_in_any_order(ncol):
    """The lookups' backward (``interp._Rows``) adds a row's cotangents
    exactly: the same bits whatever order the entries come in (the CPU's
    ``index_add_`` takes them in order, so a permutation stands for the
    card's atomics), within 1e-9 of the row's float64 sum relative to its
    largest cotangent, and a row of huge cotangents (a diverging chain)
    leaves the other rows' sums as they are."""
    rng = np.random.default_rng(3)
    rows, n = 40, 5000
    idx = torch.as_tensor(rng.integers(0, rows, (2, n)))
    g = rng.normal(size=(2, n, ncol)).astype(np.float32) * np.exp(rng.uniform(-8, 8, (2, n, 1))).astype(np.float32)
    g[idx.numpy() == 7] *= np.float32(1e30)  # one row of huge cotangents
    g = torch.as_tensor(g if ncol > 1 else g[..., 0])

    def backward(order):
        flat = torch.zeros((rows, ncol) if ncol > 1 else (rows,), requires_grad=True)
        i, gg = idx.reshape(-1)[order].reshape(2, n), g.reshape(2 * n, -1)[order].reshape(g.shape)
        tinterp._Rows.apply(flat, i).backward(gg)
        return flat.grad

    first = backward(torch.arange(2 * n))
    for seed in range(3):
        assert torch.equal(backward(torch.as_tensor(np.random.default_rng(seed).permutation(2 * n))), first)
    g64, i64 = g.reshape(2 * n, -1).double().numpy(), idx.reshape(-1).numpy()
    exact = np.zeros((rows, ncol))
    np.add.at(exact, i64, g64)
    largest = np.zeros((rows, ncol))
    np.maximum.at(largest, i64, np.abs(g64))
    got = first.reshape(rows, ncol).double().numpy()
    assert np.all(np.abs(got - exact) <= 1e-9 * largest + np.abs(exact) * 2.0 ** -24)


def test_table_row_cotangents_that_are_subnormal_sum_exactly():
    """A float64 row whose cotangents are all subnormal (a density far below
    its wall, reached through the card's lookups) sums them exactly, where
    the row's step ``q`` would otherwise round to zero and make it NaN."""
    flat = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    g = torch.tensor([1e-310, 2e-310, 1.0, 0.0, 5e-324], dtype=torch.float64)
    tinterp._Rows.apply(flat, torch.tensor([0, 0, 1, 2, 3])).backward(g)
    assert flat.grad.tolist() == [1e-310 + 2e-310, 1.0, 0.0, 5e-324]

