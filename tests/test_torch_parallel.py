"""Data- and tensor-parallel training in the port (paddle_tpu_torch.parallel,
distributed.launch), held to the JAX package's ShardedExecutor.

The port's ranks are processes: one world of 2 gloo ranks (spawned, a
FileStore under tmp_path; ``torch_spmd.py``) runs every round once, and
the tests read its results.  The JAX side runs here on the simulated CPU
devices (tests/conftest.py), from the same startup weights.  Tolerances:
fp32 1e-5 of each value's scale; AMP 1e-2 of scale; a batch-norm
network across packages at its first step, at the port's existing
cross-package tolerances for it (tests/test_torch_train.py: the losses at
1e-4, the parameters at 1e-3 of scale).  Mirrors tests/test_parallel.py,
tests/test_sharded_amp.py and tests/test_sharded_embedding.py; the
4-rank world is tests/test_torch_parallel_world4.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import parallel as jpar
from paddle_tpu_torch import parallel
from paddle_tpu_torch.parallel import (MeshConfig, ShardedExecutor,
                                       make_mesh)

import torch_spmd as sp

CPU = ptt.CPUPlace()


def close(got, want, tol, what=""):
    """|got - want| within ``tol`` of want's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of scale > {tol}"


def jax_state(build, *args, **kw):
    main, startup, _ = build(pt, *args, **kw)
    sc = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=sc)
    return {k: np.asarray(sc.numpy(k)) for k in sc.keys()}


def jax_scope(state):
    sc = pt.core.Scope()
    for k, v in state.items():
        sc.set(k, jnp.asarray(v))
    return sc


def jax_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jpar.make_mesh(MeshConfig_j(**axes), devices=jax.devices()[:n])


MeshConfig_j = jpar.MeshConfig


def jax_sharded(build, state, feeds, steps, mesh, fetch=None, amp=False,
                param_specs=None, place=False, build_kw=None, **exe_kw):
    """(fetches of each step, final state) of the JAX ShardedExecutor."""
    main, _, out = build(pt, **(build_kw or {}))
    fetch = fetch or (out if isinstance(out, tuple) else (out,))
    sc = jax_scope(state)
    exe = jpar.ShardedExecutor(mesh=mesh, amp=amp, param_specs=param_specs,
                               **exe_kw)
    if place:
        exe.place_state(main, sc)
    runs = [exe.run(main, feed=feeds, fetch_list=list(fetch), scope=sc)
            for _ in range(steps)]
    return runs, {k: np.asarray(sc.get(k), np.float32)
                  if "float" in str(sc.get(k).dtype) else np.asarray(
                      sc.get(k)) for k in sc.keys()}, exe


def jax_losses(runs):
    return [float(np.asarray(r[0])) for r in runs]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The 2-rank world's rounds, with the JAX states they start from and
    the JAX checkpoint they restore."""
    root = tmp_path_factory.mktemp("world2")
    states = {"mlp": jax_state(sp.build_mlp),
              "mlp_mom": jax_state(sp.build_mlp, momentum=True),
              "mlp_tp": jax_state(sp.build_mlp, tp=True),
              "res": jax_state(sp.build_res),
              "wd": jax_state(sp.build_wide_deep)}
    jsgd, _ = sp.build_trainer(pt)
    jsgd.exe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    states["trainer"] = {k: np.asarray(pt.global_scope().numpy(k))
                         for k in pt.global_scope().keys()}
    jax_dir = str(root / "jax_ckpt")
    _jax_table_checkpoint(jax_dir)
    ranks = sp.run_world(2, sp.world_rounds, root / "w", states, jax_dir,
                         str(root / "port_ckpt"))
    return {"ranks": ranks, "states": states, "root": root,
            "port_ckpt": str(root / "port_ckpt")}


TABLE = np.random.RandomState(0).randn(16, 64).astype(np.float32)


def _jax_table_checkpoint(root):
    """The JAX package's checkpoint of a 16 x 64 table saved 8-way on dim
    0 (tests/test_checkpoint_sharded.py), step 5."""
    from jax.sharding import NamedSharding
    from paddle_tpu.distributed import CheckpointManager
    mesh = jpar.make_mesh(MeshConfig_j(tp=8))
    sc = pt.core.Scope()
    sc.set("emb.w", jax.device_put(jnp.asarray(TABLE),
                                   NamedSharding(mesh, JP("tp", None))))
    CheckpointManager(root, async_save=False).save(5, sc)


# ---------------------------------------------------------------------------
# Data and tensor parallelism (tests/test_parallel.py)
# ---------------------------------------------------------------------------
def test_dp_training_matches_single_device(world2):
    """dp=2 tracks the unsharded run (the port's and the JAX package's
    sharded run) step for step, with the same parameters after."""
    r = world2["ranks"][0]["mlp"]["dp"]
    feeds = sp.mlp_feeds()
    runs, jstate, _ = jax_sharded(sp.build_mlp, world2["states"]["mlp"],
                                  feeds, 3, jax_mesh(dp=2))
    close(r["losses"], r["plain"], 1e-5, "vs unsharded")
    close(r["losses"], jax_losses(runs), 1e-5, "vs JAX")
    for k, v in r["plain_state"].items():
        close(r["state"][k], v, 1e-5, k)
        close(r["state"][k], jstate[k], 1e-5, k)
    # both ranks return the global values
    assert world2["ranks"][1]["mlp"]["dp"]["losses"] == r["losses"]


def test_tp_sharded_params_train(world2):
    """tp-annotated weights train: the losses fall, equal the unsharded
    and the JAX tp run's, and w_col is held in halves by the ranks."""
    r = world2["ranks"][0]["mlp"]["tp"]
    feeds = sp.mlp_feeds()
    runs, jstate, _ = jax_sharded(sp.build_mlp, world2["states"]["mlp_tp"],
                                  feeds, 3, jax_mesh(tp=2), place=True,
                                  build_kw={"tp": True})
    assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]
    close(r["losses"], r["plain"], 1e-5, "vs unsharded")
    close(r["losses"], jax_losses(runs), 1e-5, "vs JAX")
    assert r["w_col_local"] == (16, 16)
    lay1 = world2["ranks"][1]["mlp"]["tp"]["layout"]
    assert r["layout"]["index"] == [[0, 16], [0, 16]]
    assert lay1["index"] == [[0, 16], [16, 32]]
    assert r["layout"]["shape"] == [16, 32]
    for k in ("w_col", "w_row"):
        close(r["state"][k], jstate[k], 1e-5, k)


def test_sharded_run_steps_matches_per_step(world2):
    """run_steps(4) on the tp mesh equals 4 run() calls; stacked feeds
    run each step's slice."""
    r = world2["ranks"][0]["mlp"]["run_steps"]
    close(r["stacked"], r["seq"], 1e-5, "losses")
    close(r["w_stacked"], r["w_seq"], 1e-5, "w_col")
    assert len(r["stacked3"]) == 3 and np.isfinite(r["stacked3"]).all()


def test_collectives_outside_spmd_are_noops():
    x = torch.ones(4)
    assert torch.equal(parallel.psum(x), x)
    assert torch.equal(parallel.all_gather(x), x)
    assert torch.equal(parallel.all_reduce(x, "dp", "max"), x)
    assert torch.equal(parallel.reduce_scatter(x), x)
    # a one-rank mesh bound without a world: still the identity
    with parallel.spmd(make_mesh(MeshConfig())):
        assert torch.equal(parallel.psum(x, "dp"), x)


def test_collectives_outside_spmd_in_a_world(world2):
    r = world2["ranks"][1]["coll"]
    x1 = list(np.arange(4.0) + 10)
    assert r["outside"] == [x1, x1]


# ---------------------------------------------------------------------------
# AMP under the mesh (tests/test_sharded_amp.py)
# ---------------------------------------------------------------------------
def test_sharded_amp_matches_unsharded_amp(world2):
    r = world2["ranks"][0]["mlp"]["amp"]
    feeds = sp.mlp_feeds()
    runs, _, _ = jax_sharded(sp.build_mlp, world2["states"]["mlp_mom"],
                             feeds, 4, jax_mesh(dp=2), amp=True,
                             build_kw={"momentum": True})
    assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]
    close(r["losses"], r["plain"], 1e-2, "vs unsharded AMP")
    close(r["losses"], jax_losses(runs), 1e-2, "vs JAX AMP")
    # the fp32 dp run of the same program, held tighter
    f = world2["ranks"][0]["mlp"]["dp_amp"]
    close(f["losses"], f["plain"], 1e-5, "fp32 Momentum")


def test_sharded_amp_master_weights_stay_fp32(world2):
    dtypes = world2["ranks"][0]["mlp"]["amp"]["dtypes"]
    assert dtypes and all(v == "torch.float32" for v in dtypes.values())


def test_sharded_amp_run_steps_window(world2):
    r = world2["ranks"][0]["mlp"]["amp_window"]
    assert len(r["losses"]) == 5 and np.isfinite(r["losses"]).all()
    close(r["losses"], r["plain"], 1e-2, "window")


# ---------------------------------------------------------------------------
# Vocab-sharded tables (tests/test_sharded_embedding.py)
# ---------------------------------------------------------------------------
def test_manual_sharded_lookup_matches_dense(world2):
    V, D = 16, 4
    table = np.arange(V * D, dtype=np.float32).reshape(V, D)
    ids = np.array([0, V - 1, 3, V // 2, 3])
    for rank in (0, 1):
        r = world2["ranks"][rank]["coll"]
        np.testing.assert_array_equal(r["lookup"], table[ids])
        padded = table[ids] * (ids != 3)[:, None]
        np.testing.assert_array_equal(r["padded"], padded)


def test_sharded_lookup_grad_rows(world2):
    V, D = 16, 4
    ids = np.array([0, V - 1, 3, V // 2, 3])
    g = np.arange(len(ids) * D, dtype=np.float32).reshape(len(ids), D)
    dense = np.zeros((V, D), np.float32)
    np.add.at(dense, ids, g)
    for rank in (0, 1):
        r = world2["ranks"][rank]["coll"]
        want = dense[rank * 8:(rank + 1) * 8]
        np.testing.assert_array_equal(r["grad_rows"], want)
        # the autograd of sharded_lookup lands on the same rows, with the
        # two members' (equal) cotangents summed by the psum's backward
        np.testing.assert_array_equal(r["lookup_grad"], 2 * want)


def test_wide_deep_trains_with_vocab_sharded_tables(world2):
    r = world2["ranks"][0]["wd"]
    feeds = sp.wide_deep_feeds()
    main = sp.build_wide_deep(pt)[0]
    specs = {k: JP(*v) for k, v in sp.table_specs(main).items()}
    runs, jstate, _ = jax_sharded(sp.build_wide_deep, world2["states"]["wd"],
                                  feeds, 4, jax_mesh(tp=2), param_specs=specs,
                                  place=True)
    assert r["tables"] == 4
    assert r["local"][0] * 2 == r["global"][0]
    close(r["losses"], r["plain"], 1e-5, "vs unsharded")
    close(r["losses"], jax_losses(runs), 1e-5, "vs JAX")
    for k, v in jstate.items():
        if k in r["state"] and v.dtype.kind == "f":
            close(r["state"][k], v, 1e-5, k)


# ---------------------------------------------------------------------------
# Batch norm over the global batch
# ---------------------------------------------------------------------------
def test_resnet_bn_dp2_first_step_matches_jax_and_unsharded(world2):
    """A reduced bottleneck ResNet with batch norm at dp=2: the first
    step's loss, accuracy, logits and updated state equal the unsharded
    step's (fp32, 1e-5 of scale) and the JAX sharded step's (the
    cross-package BN tolerances)."""
    _resnet_check(world2["ranks"], world2["states"]["res"], 2)


def _resnet_check(ranks, state, n):
    r = ranks[0]["res"]
    feeds = sp.res_feeds()
    runs, jstate, _ = jax_sharded(sp.build_res, state, feeds, 1,
                                  jax_mesh(dp=n))
    loss, acc, logits = r["fetches"]
    ploss, pacc, plogits = r["plain"]
    close(loss, ploss, 1e-5, "loss vs unsharded")
    close(acc, pacc, 1e-5, "accuracy vs unsharded")
    close(logits, plogits, 1e-5, "logits vs unsharded")
    assert logits.shape == (8, 10)
    for k, v in r["plain_state"].items():
        close(r["state"][k], v, 1e-5, k)
    jl, ja, jg = (np.asarray(v) for v in runs[0])
    close(loss, jl, 1e-4, "loss vs JAX")
    close(acc, ja, 1e-5, "accuracy vs JAX")
    close(logits, jg, 1e-4, "logits vs JAX")
    for k, v in jstate.items():
        if v.dtype.kind == "f":
            close(r["state"][k], v, 1e-3, k)
    # the batch statistics and the loss were summed over dp; the
    # gloo steps ran uncaptured under their reason
    assert r["calls"]["all_reduce"] > 0
    assert r["uncaptured"].get("gloo", 0) >= 1
    assert r["candidate"] == "dp"


# ---------------------------------------------------------------------------
# The collectives' values and gradients (2 ranks over tp)
# ---------------------------------------------------------------------------
def _x(rank):
    return np.arange(4.0) + 10 * rank


def test_psum_value_and_gradient(world2):
    for rank in (0, 1):
        r = world2["ranks"][rank]["coll"]
        assert r["psum"] == list(_x(0) + _x(1))
        # the sum's gradient is the sum of the members' cotangents (1 + 2)
        assert r["psum_grad"] == [3.0] * 4


def test_all_reduce_ops(world2):
    r = world2["ranks"][0]["coll"]
    assert r["mean"] == list((_x(0) + _x(1)) / 2)
    assert r["max"] == list(_x(1))
    assert r["min"] == list(_x(0))


def test_all_gather_value_and_gradient(world2):
    for rank in (0, 1):
        r = world2["ranks"][rank]["coll"]
        assert r["gather"] == list(np.concatenate([_x(0), _x(1)]))
        assert r["stacked"] == [list(_x(0)), list(_x(1))]
        # each member's cotangent is arange(8); the gathered slice's
        # gradient sums both members'
        assert r["gather_grad"] == list(2.0 * np.arange(8)[rank * 4:
                                                          rank * 4 + 4])


def test_reduce_scatter_ppermute_broadcast_barrier_all_to_all(world2):
    r0, r1 = (world2["ranks"][i]["coll"] for i in (0, 1))
    total = np.arange(4.0) * 1 + np.arange(4.0) * 2
    assert r0["scatter"] == list(total[:2])
    assert r1["scatter"] == list(total[2:])
    assert r0["ppermute"] == list(_x(1)) and r1["ppermute"] == list(_x(0))
    assert r0["broadcast"] == list(_x(1)) == r1["broadcast"]
    assert r0["barrier"] == 2.0
    assert r0["all_to_all"] == [0.0, 1.0, 100.0, 101.0]
    assert r1["all_to_all"] == [2.0, 3.0, 102.0, 103.0]


def test_data_parallel_refuses_an_indivisible_batch(world2):
    r = world2["ranks"][0]["coll"]
    assert "not divisible by dp=2" in r["divisible_error"]
    assert r["shard_batch"] == [[0, 1], [2, 3]]
    assert world2["ranks"][1]["coll"]["shard_batch"] == [[4, 5], [6, 7]]


# ---------------------------------------------------------------------------
# The trainer (train(auto_shard=))
# ---------------------------------------------------------------------------
def test_train_auto_shard_matches_jax_trainer(world2):
    """train(auto_shard='dp=2') from the JAX startup weights: the costs
    of every batch equal the JAX trainer's under the same mesh."""
    jsgd, jfl = sp.build_trainer(pt)
    jsgd.exe = jpar.ShardedExecutor(mesh=jax_mesh(dp=2))
    for k, v in world2["states"]["trainer"].items():
        pt.global_scope().set(k, jnp.asarray(v))
    jsgd._initialized = True
    want = sp.train_costs(jsgd, jfl, auto_shard="dp=2")
    r = world2["ranks"][0]["trainer"]
    assert r["auto_plan"] == "dp"
    close(r["costs"], want, 1e-5, "costs")


def test_train_auto_shard_swaps_the_executor(world2):
    """A fresh trainer's first train(auto_shard={'dp': 2}) runs on a
    ShardedExecutor; its costs equal the one-process trainer's."""
    sgd, fl = sp.build_trainer(ptt, place=CPU)
    want = sp.train_costs(sgd, fl)
    r = world2["ranks"][0]["trainer"]
    assert r["swapped"] == "ShardedExecutor"
    close(r["swapped_costs"], want, 1e-5, "costs")


# ---------------------------------------------------------------------------
# Checkpoints across packages and world sizes
# ---------------------------------------------------------------------------
def test_jax_sharded_checkpoint_restores_onto_two_ranks(world2):
    """A table the JAX package saved in 8 pieces restores in a 2-rank
    world onto each rank's half."""
    for rank in (0, 1):
        r = world2["ranks"][rank]["ckpt"]
        assert r["restored_step"] == 5
        np.testing.assert_array_equal(r["restored_piece"],
                                      TABLE[rank * 8:(rank + 1) * 8])
        assert r["restored_layout"]["index"] == [[rank * 8, rank * 8 + 8],
                                                 [0, 64]]


def test_sharded_restore_onto_existing_sharding(world2):
    """The 2-rank world's own table, restored in the world onto the same
    tp=2 layout: each rank reads back its half."""
    table = np.arange(16 * 64, dtype=np.float32).reshape(16, 64)
    for rank in (0, 1):
        r = world2["ranks"][rank]["ckpt"]
        np.testing.assert_array_equal(r["same_piece"],
                                      table[rank * 8:(rank + 1) * 8])
        assert r["saved_layouts"]["emb.w"]["writer"]


def test_two_rank_checkpoint_restores_in_jax_and_in_one_process(world2):
    """The 2-rank world's save (a table in 2 pieces, each rank's, and a
    replicated counter) restores whole in one port process and onto a
    4-way JAX sharding."""
    import glob
    import os
    from jax.sharding import NamedSharding
    from paddle_tpu.distributed import CheckpointManager as JCM
    from paddle_tpu_torch.distributed import CheckpointManager
    d = world2["port_ckpt"]
    files = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(d, "ckpt-3", "emb.w.*.npy")))
    assert files == ["emb.w.p0s0.npy", "emb.w.p1s0.npy"]
    table = np.arange(16 * 64, dtype=np.float32).reshape(16, 64)
    back = ptt.Scope()
    assert CheckpointManager(d, device="cpu").restore(scope=back) == 3
    np.testing.assert_array_equal(back.numpy("emb.w"), table)
    assert back.get("step_count").tolist() == [7]
    jsc = pt.core.Scope()
    jsc.set("emb.w", jax.device_put(
        jnp.zeros((16, 64), jnp.float32),
        NamedSharding(jpar.make_mesh(MeshConfig_j(tp=4),
                                     devices=jax.devices()[:4]),
                      JP("tp", None))))
    assert JCM(d).restore(scope=jsc) == 3
    np.testing.assert_array_equal(np.asarray(jsc.get("emb.w")), table)


# ---------------------------------------------------------------------------
# One process: the mesh, the executor's keys and refusals
# ---------------------------------------------------------------------------
def test_mesh_layout_and_axes():
    m = make_mesh(MeshConfig(dp=2, tp=2), devices=range(4))
    assert m.axis_names == ("dp", "pp", "sp", "ep", "tp")
    assert dict(m.shape) == {"dp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 2}
    assert m.coords(3) == {"dp": 1, "pp": 0, "sp": 0, "ep": 0, "tp": 1}
    assert m.axis_ranks("tp", 2) == (2, 3)
    assert m.axis_ranks("dp", 1) == (1, 3)
    raw = make_mesh(shape=[2, 2], axis_names=["dp", "tp"], devices=range(4))
    assert raw.extent(["dp", "tp"]) == 4
    with pytest.raises(ValueError, match="mesh size 4"):
        make_mesh(MeshConfig(dp=4), devices=range(2))


def test_mesh_for_axes_names_the_ranks_it_needs():
    with pytest.raises(RuntimeError, match="needs 2 ranks, have 1"):
        parallel.mesh_for_axes({"dp": 2})
    m = parallel.mesh_for_axes({"dp": 1, "tp": 1})
    assert m.axis_names == ("dp", "tp") and m.size == 1


def test_get_mesh_default_and_guard():
    assert parallel.get_mesh().axis_names == ("dp",)
    m = parallel.mesh_for_axes({"tp": 1})
    with parallel.mesh_guard(m):
        assert parallel.get_mesh() is m
    with m:
        assert parallel.get_mesh() is m
    assert parallel.get_mesh().axis_names == ("dp",)
    ns = parallel.named_sharding(m, "tp", None)
    assert ns.mesh is m and ns.spec == parallel.P("tp", None)


def test_hybrid_mesh_puts_the_node_factor_outer(monkeypatch):
    import paddle_tpu_torch.parallel.mesh as pm
    monkeypatch.setattr(pm, "world_size", lambda: 8)
    m = parallel.make_hybrid_mesh(MeshConfig(dp=2, tp=2), dcn_dp=2)
    assert dict(m.shape)["dp"] == 4 and dict(m.shape)["tp"] == 2
    # dp index = node * 2 + local dp; ranks of node 1 are 4..7
    assert m.devices.reshape(4, 2).tolist() == [[0, 1], [2, 3], [4, 5],
                                                [6, 7]]


def test_item_7b_names_and_meshes_raise():
    for name in ("ring_attention", "pipeline", "moe_ffn",
                 "make_local_sgd_step"):
        with pytest.raises(NotImplementedError, match="item 7b"):
            getattr(parallel, name)
    for ax in ("pp", "sp", "ep"):
        with pytest.raises(NotImplementedError, match="item 7b"):
            ShardedExecutor(mesh=make_mesh(shape=[2], axis_names=[ax],
                                           devices=range(2)), place=CPU)


def test_one_rank_sharded_executor_equals_executor():
    """Without a world, a one-rank mesh runs the plain step: the same
    losses bit for bit, a mesh label, the mesh in the key."""
    main, startup, loss = sp.build_mlp(ptt)
    feeds = sp.mlp_feeds()
    a, b = ptt.Scope(), ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=a)
    ptt.Executor(CPU).run(startup, scope=b)
    exe = ShardedExecutor(mesh=parallel.mesh_for_axes({"dp": 1, "tp": 1}),
                          place=CPU)
    got = [exe.run(main, feed=feeds, fetch_list=[loss], scope=a)[0]
           for _ in range(2)]
    want = [ptt.Executor(CPU).run(main, feed=feeds, fetch_list=[loss],
                                  scope=b)[0] for _ in range(2)]
    assert [float(x) for x in got] == [float(x) for x in want]
    assert exe._observe_label() == "mesh=1"
    extras = exe._fingerprint_extras(main)
    assert extras[0] == "mesh" and extras[1] == ("dp", "tp")
    assert exe._validation_context()[0] == {"dp": 1, "tp": 1}


def test_sharded_executor_runs_the_sharding_lints():
    """The mesh and the specs reach the verifier: a spec naming an axis
    the mesh lacks fails validation (PT030) before any step."""
    from paddle_tpu_torch.analysis import ProgramVerificationError
    main, startup, loss = sp.build_mlp(ptt)
    sc = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=sc)
    w = next(p.name for p in main.all_parameters())
    exe = ShardedExecutor(mesh=parallel.mesh_for_axes({"dp": 1}),
                          param_specs={w: ("mp", None)}, validate=True,
                          place=CPU)
    with pytest.raises(ProgramVerificationError, match="PT030"):
        exe.run(main, feed=sp.mlp_feeds(), fetch_list=[loss], scope=sc)


def test_num_microbatches_on_a_pipeline_program_raises():
    main, startup, loss = sp.build_mlp(ptt)
    main.global_block().ops[0].attrs["pipeline_stage"] = 0
    exe = ShardedExecutor(mesh=parallel.mesh_for_axes({"dp": 1}),
                          num_microbatches=2, place=CPU)
    with pytest.raises(NotImplementedError, match="item 7b"):
        exe.run(main, feed=sp.mlp_feeds(), fetch_list=[loss],
                scope=ptt.Scope())


def test_data_parallel_wants_a_sharded_executor():
    with pytest.raises(TypeError, match="ShardedExecutor"):
        parallel.DataParallel(ptt.Executor(CPU),
                              parallel.mesh_for_axes({"dp": 1}))


def test_transpiler_shim():
    from paddle_tpu_torch.distributed import DistributeTranspiler
    main = sp.build_mlp(ptt)[0]
    t = DistributeTranspiler().transpile(trainer_id=1, program=main,
                                         trainers=2)
    assert t.get_trainer_program() is main and t.trainers == 2
    with pytest.raises(RuntimeError, match="DataParallel"):
        t.get_pserver_program("127.0.0.1:6174")
    with pytest.raises(RuntimeError, match="init_distributed"):
        t.get_startup_program()
