"""The scale-out layer (``parallel/``, ``ops.collectives``,
``sharded_logsumexp``, ``fit(mesh=)``) on CPU ranks, against the JAX
package's dense functions.

Ranks are spawned processes joined by gloo through a ``file://`` store under
``tmp_path``: world 2 (a 1 x 2 mesh: the data split in two) and world 4 (a
2 x 2 mesh), one spawn each, every check of that world in the one spawn.
Each rank writes what it computed; the test holds it here:

* ``sharded_logsumexp`` against ``torch.logsumexp`` of the gathered array,
  values and gradients (this rank's slice), with a shard that is all
  ``-inf``, at rtol 1e-6 / atol 1e-6;
* both sharded likelihoods (a spec built on the shard, and the
  ``make_sharded_*`` log-likelihoods) on ``tests/test_sharding.py``'s frames
  (``_source_frame``, seeds 11 and 13) against the JAX ``pop_loglike`` and
  ``pop_cosmo_loglike`` at rtol 2e-5 / atol 2e-4 (``test_sharding.py:51,89``),
  and their potentials' value+grad against ``jax.value_and_grad`` of the
  dense JAX potential at ``tests/test_torch_potential.py``'s limits
  (|ΔU|/(1+|U|) < 2e-4, |Δgrad|/(1+|grad|) < 5e-3);
* the deterministics of a shard (gathered rows) against the dense port's;
* ``make_mesh``'s factorisation and its ``ValueError``;
* ``fit`` with ``nuts`` and ``nuts+chees`` on both meshes returns (4, 5)
  finite draws, the same on every rank (``test_sharding.py:108-164``), with
  ``warmup_chunk_size``; on the 2 x 2 mesh the two rows draw differently;
* a draw on the mesh from the adapted state of that fit is within 1e-3
  (|d|/(1+|ref|)) of a dense fit's of each row's chains from the same
  state and the row's seed (the data split changes only the rounding; after
  a 10-step warmup the steps are large enough that the rounding parts the
  chains chaotically over later draws, so one draw is held);

and, in this process as a world of one, ``fit(mesh=)`` on a 1 x 1 mesh is
``fit()`` bit for bit.
"""
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

N_GRID, N_Z = 48, 64
CHAINS = 3
SPAWN_TIMEOUT_S = 600


def _source_frame(nobs=6, nsamp=32, nsel=64, seed=11):
    """``tests/test_sharding.py``'s frame."""
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(8.0, 70.0, size=(nobs, nsamp)),
        rng.uniform(0.3, 1.0, size=(nobs, nsamp)),
        rng.uniform(0.02, 1.5, size=(nobs, nsamp)),
        rng.uniform(0.5, 2.0, size=(nobs, nsamp)),
        rng.uniform(8.0, 70.0, size=nsel),
        rng.uniform(0.3, 1.0, size=nsel),
        rng.uniform(0.02, 1.5, size=nsel),
        rng.uniform(0.5, 2.0, size=nsel),
    )


# ------------------------------------------------------------------ the ranks


def _rank_work(rank, world, init, tmp, rows):
    """One rank: every check of this world, written to ``rank<r>.pt``."""
    from bumpcosmology_torch.inference.likelihoods import (
        pop_cosmo_deterministics,
        pop_cosmo_model_spec,
        pop_deterministics,
        pop_model_spec,
    )
    from bumpcosmology_torch.inference.model import ModelSpec, constrain, make_potential, value_and_grad
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.inference.sampler import _row_seed, _tree_map, fit
    from bumpcosmology_torch.ops.logsumexp import sharded_logsumexp
    from bumpcosmology_torch.parallel import (
        DATA_AXIS,
        make_mesh,
        make_sharded_pop_cosmo_loglike,
        make_sharded_pop_loglike,
        shard_pop_cosmo_data,
        shard_pop_data,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S // 2))
    try:
        inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {}
        mesh = make_mesh(rows)
        out["shape"] = dict(mesh.shape)
        try:
            make_mesh(3)
        except ValueError as err:
            out["mesh_error"] = str(err)
        group, k, i = mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
        out["data_index"] = i
        pop = inp["pop"]["data"]
        odd = pop._replace(selection=pop.selection._replace(
            **{f: getattr(pop.selection, f)[:63] for f in ("a", "q", "c", "log_pdraw")}))
        try:
            shard_pop_data(odd, mesh)
        except ValueError as err:
            out["shard_error"] = str(err)

        for name, arr in inp["lse"].items():
            w = arr.shape[1] // k
            for axis in (1, None):
                a = arr[:, i * w:(i + 1) * w].clone().requires_grad_(True)
                v = sharded_logsumexp(a, group, axis=axis)
                v.sum().backward()
                out[f"lse/{name}/{axis}"] = (v.detach(), a.grad)

        for model in ("pop", "pop_cosmo"):
            data, theta = inp[model]["data"], inp[model]["theta"]
            if model == "pop":
                shard = shard_pop_data(data, mesh)
                spec_sh = pop_model_spec(shard, N_GRID, device="cpu")
                explicit = make_sharded_pop_loglike(mesh, data, N_GRID)
                det = lambda s, d: pop_deterministics(s, d, N_GRID)  # noqa: E731
            else:
                shard = shard_pop_cosmo_data(data, mesh)
                spec_sh = pop_cosmo_model_spec(shard, N_GRID, N_Z, device="cpu")
                explicit = make_sharded_pop_cosmo_loglike(mesh, data, N_GRID, N_Z)
                det = lambda s, d: pop_cosmo_deterministics(s, d, N_GRID, N_Z)  # noqa: E731
            spec_ex = ModelSpec(priors=spec_sh.priors, loglike=explicit, device=torch.device("cpu"))
            for path, spec in (("gspmd", spec_sh), ("explicit", spec_ex)):
                with torch.no_grad():
                    ll = spec.loglike(constrain(spec, theta))
                out[f"{model}/{path}"] = (ll, *value_and_grad(make_potential(spec), theta))
            with torch.no_grad():
                out[f"{model}/det"] = det(constrain(spec_sh, theta), shard)

        spec = pop_model_spec(shard_pop_data(inp["pop"]["data"], mesh), N_GRID, device="cpu")
        for sampler in ("nuts", "nuts+chees"):
            res = fit(spec, 0, num_warmup=10, num_samples=5, num_chains=4, cfg=NutsConfig(max_depth=4),
                      mesh=mesh, sampler=sampler, warmup_chunk_size=4, chees_num_adapt=3, verbose=False,
                      device="cpu")
            out[f"fit/{sampler}"] = (res.posterior, res.sample_stats, res.warmup_state.state.theta)
            if sampler == "nuts":
                warm = res.warmup_state
        # from the adapted state, no warmup, one draw: this row's chains on the mesh, and the same chains dense
        row, n = mesh.index("chains"), 4 // rows
        kw = dict(num_warmup=0, num_samples=1, cfg=NutsConfig(max_depth=4), verbose=False, device="cpu")
        on_mesh = fit(spec, 1, num_chains=4, warmup_state=warm, mesh=mesh, **kw)
        dense = fit(pop_model_spec(inp["pop"]["data"], N_GRID, device="cpu"), _row_seed(1, row) if rows > 1 else 1,
                    num_chains=n, warmup_state=_tree_map(lambda t: t[row * n:(row + 1) * n], warm), **kw)
        out["fit/from_warm"] = ({k: v[row * n:(row + 1) * n] for k, v in on_mesh.posterior.items()}, dense.posterior)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world: int, rows: int):
    """Run :func:`_rank_work` on ``world`` spawned ranks; returns their results.
    Ranks still running after ``SPAWN_TIMEOUT_S`` are killed and the test fails."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_work, args=(world, f"file://{tmp}/store", str(tmp), rows), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------- the references


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The frames in both packages, prior draws, and the JAX package's dense
    log-likelihoods and potentials at them."""
    import jax
    import jax.numpy as jnp

    from bumpcosmology_tpu.inference import likelihoods as jl
    from bumpcosmology_tpu.inference.model import constrain as jconstrain
    from bumpcosmology_tpu.inference.model import make_potential as jpotential
    from bumpcosmology_tpu.inference.model import prior_sample as jprior
    from bumpcosmology_tpu.models import dl_at_z, planck18_table
    from bumpcosmology_torch import convert

    jpop = jl.make_pop_data(*_source_frame(seed=11), ndraw=1000.0)
    m1, q, z, pd, m1s, qs, zs, pds = _source_frame(seed=13)
    table = planck18_table()
    dl, dls = (np.asarray(dl_at_z(table, jnp.asarray(x))) for x in (z, zs))
    jcosmo = jl.make_pop_cosmo_data(m1 * (1 + z), q, dl, pd, m1s * (1 + zs), qs, dls, pds, ndraw=1000.0)

    ref, port = {}, {}
    for model, jd, spec_fn, ll_fn, kw, key in (
            ("pop", jpop, jl.pop_model_spec, jl.pop_loglike, dict(n_grid=N_GRID), 1),
            ("pop_cosmo", jcosmo, jl.pop_cosmo_model_spec, jl.pop_cosmo_loglike, dict(n_grid=N_GRID, n_z=N_Z), 2)):
        js = spec_fn(jd, **kw)
        theta = jprior(js, jax.random.PRNGKey(key), (CHAINS,))
        u, g = jax.vmap(jax.value_and_grad(jpotential(js)))(theta)
        if model == "pop_cosmo":  # the spec's route: the detector table on the data's dL range
            kw = dict(kw, dl_bounds=jl.dl_bounds_of(jd))
        ll = jax.vmap(lambda s: ll_fn(s, jd, **kw))(jconstrain(js, theta))
        ref[model] = {"ll": np.asarray(ll), "u": np.asarray(u), "grad": np.asarray(g)}
        port[model] = {"data": (convert.pop_data if model == "pop" else convert.pop_cosmo_data)(jd, "cpu"),
                       "theta": convert.theta_batch(theta, "cpu")}
    rng = np.random.default_rng(7)
    full = torch.as_tensor(rng.normal(0.0, 3.0, (3, 8)), dtype=torch.float32)
    neginf = full.clone()
    neginf[:, 4:] = -torch.inf  # the second half: a shard that is all -inf on 2 data ranks
    port["lse"] = {"full": full, "neginf_shard": neginf}
    tmp = tmp_path_factory.mktemp("parallel_inputs")
    torch.save(port, tmp / "inputs.pt")
    return tmp, ref, port


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)], ids=["world2_1x2", "world4_2x2"])
def ranks(request, inputs, tmp_path_factory):
    world, rows = request.param
    tmp, ref, port = inputs
    run = tmp_path_factory.mktemp(f"world{world}")
    torch.save(port, run / "inputs.pt")
    return world, rows, _spawn(run, world, rows), ref, port


# ------------------------------------------------------------------ the tests


def test_make_mesh_factorises_the_world_and_refuses_what_does_not_divide(ranks):
    world, rows, outs, _, _ = ranks
    for out in outs:
        assert out["shape"] == {"chains": rows, "data": world // rows}
        assert out["mesh_error"] == f"{world} devices not divisible into 3 chain rows"
        assert out["shard_error"] == "32 PE samples per event and 63 injections do not divide into 2 'data' shards"
    assert sorted(o["data_index"] for o in outs) == sorted(r % (world // rows) for r in range(world))


@pytest.mark.parametrize("name", ["full", "neginf_shard"])
@pytest.mark.parametrize("axis", [1, None])
def test_sharded_logsumexp_is_the_gathered_logsumexp(ranks, name, axis):
    world, rows, outs, _, port = ranks
    k = world // rows
    full = port["lse"][name].clone().requires_grad_(True)
    want = torch.logsumexp(full, dim=1) if axis == 1 else torch.logsumexp(full.reshape(-1), dim=0)
    want.sum().backward()
    w = full.shape[1] // k
    for out in outs:
        v, g = out[f"lse/{name}/{axis}"]
        i = out["data_index"]
        assert torch.isfinite(v).all() and torch.isfinite(g).all()
        torch.testing.assert_close(v, want.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g, full.grad[:, i * w:(i + 1) * w], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("path", ["gspmd", "explicit"])
@pytest.mark.parametrize("model", ["pop", "pop_cosmo"])
def test_sharded_likelihoods_match_the_dense_jax_ones(ranks, model, path):
    _, _, outs, ref, _ = ranks
    r = ref[model]
    for out in outs:
        ll, u, g = (x.numpy() for x in out[f"{model}/{path}"])
        assert np.isfinite(ll).all() and np.isfinite(u).all() and np.isfinite(g).all()
        np.testing.assert_allclose(ll, r["ll"], rtol=2e-5, atol=2e-4)
        assert np.all(np.abs(u - r["u"]) / (1.0 + np.abs(r["u"])) < 2e-4)
        assert np.all(np.abs(g - r["grad"]) / (1.0 + np.abs(r["grad"])) < 5e-3)


@pytest.mark.parametrize("model", ["pop", "pop_cosmo"])
def test_explicit_path_is_the_spec_on_the_shard_bit_for_bit(ranks, model):
    """``make_sharded_*`` runs the likelihood of a spec built on the shard
    with the same fixed tables: the same bits, value and gradient."""
    _, _, outs, _, _ = ranks
    for out in outs:
        for got, want in zip(out[f"{model}/explicit"], out[f"{model}/gspmd"]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["pop", "pop_cosmo"])
def test_deterministics_of_a_shard_are_the_dense_ones(ranks, model):
    from bumpcosmology_torch.inference.likelihoods import (
        pop_cosmo_deterministics,
        pop_cosmo_model_spec,
        pop_deterministics,
        pop_model_spec,
    )
    from bumpcosmology_torch.inference.model import constrain

    _, _, outs, _, port = ranks
    data, theta = port[model]["data"], port[model]["theta"]
    with torch.no_grad():
        if model == "pop":
            want = pop_deterministics(constrain(pop_model_spec(data, N_GRID, device="cpu"), theta), data, N_GRID)
        else:
            spec = pop_cosmo_model_spec(data, N_GRID, N_Z, device="cpu")
            want = pop_cosmo_deterministics(constrain(spec, theta), data, N_GRID, N_Z)
    for out in outs:
        got = out[f"{model}/det"]
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("sampler", ["nuts", "nuts+chees"])
def test_fit_on_a_mesh(ranks, sampler):
    """4 chains on the 1 x 2 mesh (one row, the data split) and the 2 x 2 mesh."""
    world, rows, outs, _, _ = ranks
    post0, stats0, warm0 = outs[0][f"fit/{sampler}"]
    assert post0["a"].shape == (4, 5) and warm0.shape == (4, 12)
    for k, v in post0.items():
        assert np.isfinite(v).all(), k
    assert np.isfinite(stats0["accept_prob"]).all()
    if rows == 2:
        assert not np.array_equal(post0["a"][:2], post0["a"][2:])  # the rows draw differently
    for out in outs[1:]:
        post, stats, warm = out[f"fit/{sampler}"]
        for k in post0:
            np.testing.assert_array_equal(post[k], post0[k], err_msg=k)
        for k in stats0:
            np.testing.assert_array_equal(stats[k], stats0[k], err_msg=k)
        assert torch.equal(warm, warm0)


def test_sampling_on_a_mesh_tracks_the_dense_fit(ranks):
    _, _, outs, _, _ = ranks
    for out in outs:
        got, want = out["fit/from_warm"]
        for k in want:
            assert np.all(np.abs(got[k] - want[k]) / (1.0 + np.abs(want[k])) < 1e-3), k


def test_fit_on_a_1x1_mesh_is_fit(tmp_path):
    from bumpcosmology_torch import convert
    from bumpcosmology_torch.inference.likelihoods import pop_model_spec
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.parallel import make_mesh, shard_pop_data
    from bumpcosmology_tpu.inference.likelihoods import make_pop_data

    data = convert.pop_data(make_pop_data(*_source_frame(seed=11), ndraw=1000.0), "cpu")
    kw = dict(num_warmup=12, num_samples=5, num_chains=3, cfg=NutsConfig(max_depth=4), warmup_chunk_size=5,
              verbose=False, device="cpu")
    want = fit(pop_model_spec(data, N_GRID, device="cpu"), 3, **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        got = fit(pop_model_spec(shard_pop_data(data, mesh), N_GRID, device="cpu"), 3, mesh=mesh, **kw)
        with pytest.raises(ValueError, match="takes no checkpoint_path"):
            fit(pop_model_spec(data, N_GRID, device="cpu"), 3, mesh=mesh, checkpoint_path=str(tmp_path / "c"), **kw)
    finally:
        dist.destroy_process_group()
    for k in want.posterior:
        np.testing.assert_array_equal(got.posterior[k], want.posterior[k], err_msg=k)
    for k in want.sample_stats:
        np.testing.assert_array_equal(got.sample_stats[k], want.sample_stats[k], err_msg=k)
    for a, b in zip((*got.final_state.state, *got.final_state[1:]), (*want.final_state.state, *want.final_state[1:])):
        assert torch.equal(a, b)
