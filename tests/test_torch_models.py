"""Port parity, L1: kernel A's plain twin, the mass function, cosmology and
detector tables, and the population intensity — values, and autograd of the
port against ``jax.grad`` of the JAX package, on the same numpy inputs.

Tolerances:
* kernel A: rtol 1e-4 / atol 5e-5 forward and rtol 2e-4 / atol 1e-5 on the
  VJP, those of ``tests/test_pallas_bump.py:39,57`` (the grids are written
  ``lo + j d`` here and ``linspace`` in the jnp reference: ~1e-6 relative);
* tables built on the bump (mass function, intensity): rtol 1e-4 / atol 2e-4,
  the bump's tolerance carried through a few log-sum-exps;
* cosmology tables (same float32 formulas, different summation order):
  rtol 2e-5 on values, 1e-4 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.models import cosmology as jcos
from bumpcosmology_tpu.models import population as jpop
from bumpcosmology_tpu.models.mass import build_mass_function as jbuild_mass
from bumpcosmology_tpu.models.mass import log_dndm as jlog_dndm
from bumpcosmology_tpu.models.mass import pisn_bump_log_dndm_grid, set_bump_kernel
from bumpcosmology_tpu.models.parameters import DEFAULT_POPULATION, CosmoParams
from bumpcosmology_tpu.ops.pallas_bump import bump_log_dn_pallas
from bumpcosmology_torch import convert
from bumpcosmology_torch.models import cosmology as tcos
from bumpcosmology_torch.models import population as tpop
from bumpcosmology_torch.models.mass import build_mass_function, log_dndm
from bumpcosmology_torch.ops.cuda_bump import PARAM_NAMES, bump_log_dn, bump_log_dn_plain

MP = DEFAULT_POPULATION.mass


def _jax_bump(a, b, mpisn, mbhmax, sigma, n_grid):
    set_bump_kernel("jax")
    try:
        return pisn_bump_log_dndm_grid(MP._replace(a=a, b=b, mpisn=mpisn, mbhmax=mbhmax, sigma=sigma),
                                       n_grid)[2]
    finally:
        set_bump_kernel(None)


def _draws(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mpisn = MP.mpisn + 2.0 * rng.normal()
        out.append([MP.a + 0.3 * rng.normal(), MP.b + 0.3 * rng.normal(), mpisn,
                    mpisn + rng.uniform(2.0, 8.0), rng.uniform(1.5, 3.5)])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("n_grid", [128, 256])
def test_bump_plain_forward_matches_jnp(n_grid):
    p = _draws(3)
    got = bump_log_dn(torch.as_tensor(p), n_grid).numpy()  # CPU tensor -> plain twin
    for c in range(3):
        ref = np.asarray(_jax_bump(*(jnp.float32(v) for v in p[c]), n_grid))
        np.testing.assert_allclose(got[c], ref, rtol=1e-4, atol=5e-5)


def test_bump_plain_vjp_matches_autodiff():
    g = np.random.default_rng(0).normal(size=256).astype(np.float32)
    p0 = np.asarray([[MP.a, MP.b, MP.mpisn, MP.mbhmax, MP.sigma]], np.float32)
    p = np.concatenate([p0, _draws(2, seed=5)])
    t = torch.tensor(p, requires_grad=True)
    (bump_log_dn_plain(t, 256) * torch.as_tensor(g)).sum().backward()
    for c in range(p.shape[0]):
        gr = jax.grad(lambda *xs: jnp.vdot(g, _jax_bump(*xs, 256)), argnums=(0, 1, 2, 3, 4))(
            *(jnp.float32(v) for v in p[c]))
        for k, name in enumerate(PARAM_NAMES):
            np.testing.assert_allclose(float(t.grad[c, k]), float(gr[k]), rtol=2e-4, atol=1e-5,
                                       err_msg=f"chain {c}: grad wrt {name}")


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("n_grid", [48, 100])
def test_bump_plain_ragged_shapes_match_jax(n_grid, c):
    """Grids that are no multiple of a warp, one chain and three: the twin's
    values against the jnp route and the Pallas kernel (interpret mode), its
    VJP against JAX autodiff of the jnp route, at the kernel's tolerances."""
    p = _draws(c, seed=11 + n_grid)
    g = np.random.default_rng(n_grid).normal(size=(c, n_grid)).astype(np.float32)
    t = torch.tensor(p, requires_grad=True)
    out = bump_log_dn(t, n_grid)  # CPU tensor -> plain twin
    assert out.shape == (c, n_grid)
    (out * torch.as_tensor(g)).sum().backward()
    for k in range(c):
        xs = tuple(jnp.float32(v) for v in p[k])
        for ref in (_jax_bump(*xs, n_grid), bump_log_dn_pallas(*xs, n_grid, True)):
            np.testing.assert_allclose(out.detach().numpy()[k], np.asarray(ref), rtol=1e-4, atol=5e-5)
        gr = jax.grad(lambda *a: jnp.vdot(g[k], _jax_bump(*a, n_grid)), argnums=(0, 1, 2, 3, 4))(*xs)
        for j, name in enumerate(PARAM_NAMES):
            np.testing.assert_allclose(float(t.grad[k, j]), float(gr[j]), rtol=2e-4, atol=1e-5,
                                       err_msg=f"chain {k}: grad wrt {name}")


def _mass_draws():
    """Three full mass-parameter sets as the JAX package's MassParams."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(3):
        mp = MP._replace(
            a=np.float32(MP.a + 0.2 * rng.normal()), c=np.float32(MP.c + 0.3 * rng.normal()),
            mpisn=np.float32(MP.mpisn + rng.normal()), sigma=np.float32(rng.uniform(1.8, 3.0)),
            fpl=np.float32(rng.uniform(0.05, 0.4)), beta=np.float32(MP.beta + rng.normal()),
        )
        out.append(mp._replace(mbhmax=np.float32(mp.mpisn + rng.uniform(3.0, 7.0))))
    return out


def _stack_mass(draws, requires_grad=False):
    from bumpcosmology_torch.models.parameters import MassParams

    leaves = [torch.tensor(np.asarray([getattr(d, f) for d in draws], np.float32),
                           requires_grad=requires_grad) for f in MassParams._fields]
    return MassParams(*leaves)


def test_mass_function_and_log_dndm_match_jax():
    draws = _mass_draws()
    masses = np.linspace(3.0, 80.0, 61).astype(np.float32)  # spans MBH_MIN, the bump and the tail
    table = build_mass_function(_stack_mass(draws), n_grid=128)
    got = log_dndm(table, torch.as_tensor(masses).expand(3, -1)).numpy()
    for c, d in enumerate(draws):
        jt = jbuild_mass(d, n_grid=128)
        np.testing.assert_allclose(table.log_bump[c].numpy(), np.asarray(jt.log_bump), rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(float(table.log_pl_norm[c]), float(jt.log_pl_norm), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(float(table.log_norm[c]), float(jt.log_norm), rtol=1e-4, atol=2e-4)
        ref = np.asarray(jlog_dndm(jt, jnp.asarray(masses)))
        assert np.array_equal(np.isinf(got[c]), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[c][fin], ref[fin], rtol=1e-4, atol=2e-4)


def test_log_dndm_grad_matches_jax():
    """Autograd through kernel A's twin, the interp and the normalization."""
    draws = _mass_draws()
    rng = np.random.default_rng(9)
    masses = rng.uniform(6.0, 70.0, 40).astype(np.float32)
    g = rng.normal(size=40).astype(np.float32)
    params = _stack_mass(draws, requires_grad=True)
    (log_dndm(build_mass_function(params, 128), torch.as_tensor(masses).expand(3, -1))
     * torch.as_tensor(g)).sum().backward()
    for c, d in enumerate(draws):
        ref = jax.grad(lambda mp: jnp.vdot(g, jlog_dndm(jbuild_mass(mp, 128), jnp.asarray(masses))))(
            type(d)(*(jnp.float32(v) for v in d)))
        for f in type(d)._fields:
            want = float(getattr(ref, f))
            grad = getattr(params, f).grad  # None for a leaf log_dndm never reads (beta)
            np.testing.assert_allclose(0.0 if grad is None else float(grad[c]), want,
                                       rtol=1e-3, atol=2e-3 * max(1.0, abs(want)),
                                       err_msg=f"chain {c}: grad wrt {f}")


COSMOS = [(0.7, 0.3, -1.0), (0.6, 0.45, -0.8), (0.9, 0.2, -1.3)]
DL_LO, DL_HI = 0.1, 20.0


def _tcosmo(requires_grad=False):
    """The three cosmologies as one chain batch, carried across from the JAX package's container."""
    arr = np.asarray(COSMOS, np.float32).T
    params = convert.cosmo_params(CosmoParams(*arr), device="cpu")
    return type(params)(*(x.requires_grad_(requires_grad) for x in params))


def test_cosmology_and_detector_tables_match_jax():
    n = 128
    tab = tcos.build_cosmology(_tcosmo(), n=n)
    det = tcos.build_detector_table(tab, DL_LO, DL_HI, n=n)
    for c, cp in enumerate(COSMOS):
        jt = jcos.build_cosmology(CosmoParams(*(jnp.float32(v) for v in cp)), n=n)
        jdet = jcos.build_detector_table(jt, DL_LO, DL_HI, n=n)
        for col in ("dc", "dl", "ddl", "dvc"):
            np.testing.assert_allclose(getattr(tab, col)[c].numpy(), np.asarray(getattr(jt, col)),
                                       rtol=2e-5, atol=1e-6, err_msg=col)
        np.testing.assert_allclose(det.cols[c].numpy(), np.asarray(jdet.cols), rtol=2e-5, atol=2e-5)
    q = np.exp(np.random.default_rng(1).uniform(np.log(DL_LO), np.log(DL_HI), 30)).astype(np.float32)
    z, lj = tcos.z_and_logjac_at_dl(det, torch.as_tensor(q).expand(3, -1))
    jz, jlj = jcos.z_and_logjac_at_dl(jdet, jnp.asarray(q))
    np.testing.assert_allclose(z[-1].numpy(), np.asarray(jz), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(lj[-1].numpy(), np.asarray(jlj), rtol=2e-5, atol=2e-5)


def test_detector_table_grad_matches_jax():
    n = 128
    g = np.random.default_rng(2).normal(size=(n, 2)).astype(np.float32)
    params = _tcosmo(requires_grad=True)
    det = tcos.build_detector_table(tcos.build_cosmology(params, n=n), DL_LO, DL_HI, n=n)
    (det.cols * torch.as_tensor(g)).sum().backward()
    for c, cp in enumerate(COSMOS):
        ref = jax.grad(lambda p: jnp.vdot(g, jcos.build_detector_table(
            jcos.build_cosmology(p, n=n), DL_LO, DL_HI, n=n).cols))(
            CosmoParams(*(jnp.float32(v) for v in cp)))
        for f in ("h", "Om", "w"):
            want = float(getattr(ref, f))
            grad = getattr(params, f).grad  # None for a leaf log_dndm never reads (beta)
            np.testing.assert_allclose(0.0 if grad is None else float(grad[c]), want, rtol=1e-4,
                                       atol=1e-4 * max(1.0, abs(want)), err_msg=f"grad wrt {f}")


def test_log_dndmdqdv_value_and_grad_match_jax():
    rng = np.random.default_rng(11)
    m1 = rng.uniform(6.0, 60.0, 50).astype(np.float32)
    q = rng.uniform(0.2, 1.0, 50).astype(np.float32)
    z = rng.uniform(0.01, 2.0, 50).astype(np.float32)
    g = rng.normal(size=50).astype(np.float32)
    jparams = DEFAULT_POPULATION._replace(
        mass=DEFAULT_POPULATION.mass._replace(**{f: np.float32(v) for f, v in
                                                 DEFAULT_POPULATION.mass._asdict().items()}),
        redshift=DEFAULT_POPULATION.redshift._replace(**{f: np.float32(v) for f, v in
                                                         DEFAULT_POPULATION.redshift._asdict().items()}),
    )
    tparams = convert.population_params(jparams, device="cpu")
    for leaf in (*tparams.mass, *tparams.redshift):
        leaf.requires_grad_(True)
    pop = tpop.build_population(tparams, 128)
    t_args = [torch.as_tensor(x)[None] for x in (m1, q, z)]
    out = tpop.log_dndmdqdv(pop, *t_args)
    (out * torch.as_tensor(g)).sum().backward()

    def jloss(p):
        return jnp.vdot(g, jpop.log_dndmdqdv(jpop.build_population(p, 128), m1, q, z))

    ref_v = np.asarray(jpop.log_dndmdqdv(jpop.build_population(jparams, 128), m1, q, z))
    fin = np.isfinite(ref_v)
    np.testing.assert_allclose(out.detach().numpy()[0][fin], ref_v[fin], rtol=1e-4, atol=2e-4)
    ref_g = jax.grad(jloss)(jax.tree.map(jnp.float32, jparams))
    for group, tgroup in ((ref_g.mass, tparams.mass), (ref_g.redshift, tparams.redshift)):
        for f in type(group)._fields:
            want = float(getattr(group, f))
            np.testing.assert_allclose(float(getattr(tgroup, f).grad[0]), want, rtol=1e-3,
                                       atol=2e-3 * max(1.0, abs(want)), err_msg=f"grad wrt {f}")
