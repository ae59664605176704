"""The port's sharded training in a world of 4 gloo ranks (dp2 x tp2 and
dp=4), held to the JAX package's ShardedExecutor on 4 simulated CPU
devices and to the unsharded run; see tests/test_torch_parallel.py for
the 2-rank world, the helpers and the tolerances.  Mirrors
bench.py's planner smoke (``bench.py:311-337``),
tests/test_sharded_amp.py at dp2 x tp2, tests/test_sharded_embedding.py
and tests/test_checkpoint_sharded.py.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import parallel as jpar

import torch_spmd as sp
from test_torch_parallel import (TABLE, _jax_table_checkpoint,
                                 _resnet_check, close, jax_losses, jax_mesh,
                                 jax_sharded, jax_state)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("world4")
    states = {"res": jax_state(sp.build_res),
              "smoke": jax_state(sp.build_smoke_mlp),
              "mlp_tp_mom": jax_state(sp.build_mlp, tp=True, momentum=True),
              "wd": jax_state(sp.build_wide_deep)}
    jax_dir = str(root / "jax_ckpt")
    _jax_table_checkpoint(jax_dir)
    ranks = sp.run_world(4, sp.world_rounds, root / "w", states, jax_dir,
                         str(root / "port_ckpt"))
    return {"ranks": ranks, "states": states,
            "port_ckpt": str(root / "port_ckpt")}


def test_resnet_bn_dp4_first_step_matches_jax_and_unsharded(world4):
    """The reduced bottleneck ResNet at dp=4 (2 rows a rank): batch norm's
    statistics over the global batch."""
    _resnet_check(world4["ranks"], world4["states"]["res"], 4)


def test_planner_smoke_mlp_dp2_tp2_matches_jax_and_unsharded(world4):
    """bench.py's --mesh leg in the port: ShardedExecutor(auto_shard=True)
    on dp2 x tp2 plans Megatron splits (512 columns, then 512 rows), as
    the JAX planner does, and its losses equal the unsharded run's and
    the JAX sharded run's."""
    r = world4["ranks"][0]["smoke"]
    feeds = sp.smoke_feeds()
    mesh = jpar.mesh_for_axes({"dp": 2, "tp": 2})
    runs, jstate, jexe = jax_sharded(sp.build_smoke_mlp,
                                     world4["states"]["smoke"], feeds, 3,
                                     mesh, batch_axis="dp", auto_shard=True)
    assert r["candidate"] == jexe.auto_plan.candidate == "megatron"
    assert r["param_specs"] == {k: [list(e) if e else None for e in v]
                                for k, v in jexe.auto_plan.param_specs.items()}
    assert r["label"] == "mesh=dp2,tp2"
    col, row = sorted(r["param_specs"], key=lambda k: r["param_specs"][k]
                      [0] is not None)
    assert r["local"][col] == (256, 256) and r["local"][row] == (256, 128)
    close(r["losses"], r["plain"], 1e-5, "vs unsharded")
    close(r["losses"], jax_losses(runs), 1e-5, "vs JAX")
    for k, v in jstate.items():
        if k in r["state"]:
            close(r["state"][k], v, 1e-5, k)


def test_sharded_amp_dp2_tp2_matches_unsharded_amp(world4):
    r = world4["ranks"][0]["amp_tp"]
    feeds = sp.mlp_feeds()
    runs, _, _ = jax_sharded(sp.build_mlp, world4["states"]["mlp_tp_mom"],
                             feeds, 4, jax_mesh(dp=2, tp=2), amp=True,
                             place=True,
                             build_kw={"tp": True, "momentum": True})
    assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]
    close(r["losses"], r["plain"], 1e-2, "vs unsharded AMP")
    close(r["losses"], jax_losses(runs), 1e-2, "vs JAX AMP")


def test_wide_deep_dp2_tp2_vocab_sharded(world4):
    r = world4["ranks"][0]["wd"]
    feeds = sp.wide_deep_feeds()
    main = sp.build_wide_deep(pt)[0]
    specs = {k: JP(*v) for k, v in sp.table_specs(main).items()}
    runs, jstate, _ = jax_sharded(sp.build_wide_deep, world4["states"]["wd"],
                                  feeds, 4, jax_mesh(dp=2, tp=2),
                                  param_specs=specs, place=True)
    assert r["tables"] == 4 and r["local"][0] * 2 == r["global"][0]
    close(r["losses"], r["plain"], 1e-5, "vs unsharded")
    close(r["losses"], jax_losses(runs), 1e-5, "vs JAX")
    for k, v in jstate.items():
        if k in r["state"] and v.dtype.kind == "f":
            close(r["state"][k], v, 1e-5, k)


def test_collectives_over_four_members(world4):
    for rank in range(4):
        r = world4["ranks"][rank]["coll"]
        x = [np.arange(4.0) + 10 * i for i in range(4)]
        assert r["psum"] == list(sum(x))
        assert r["psum_grad"] == [10.0] * 4
        assert r["gather"] == list(np.concatenate(x))
        assert r["ppermute"] == list(x[(rank - 1) % 4])
        assert r["broadcast"] == list(x[3])
        assert r["barrier"] == 4.0


def test_sharded_save_writes_per_shard_files(world4):
    """A (dp, tp)-sharded w and a tp-sharded table (replicated over dp:
    only dp index 0 writes) are saved as pieces, never whole; the meta
    holds each piece's window of the global shape."""
    import json
    d = os.path.join(world4["port_ckpt"], "ckpt-3")
    w_files = glob.glob(os.path.join(d, "w.*.npy"))
    assert len(w_files) == 4
    for f in w_files:
        assert np.load(f).shape == (2, 12)
    t_files = sorted(os.path.basename(f)
                     for f in glob.glob(os.path.join(d, "emb.w.*.npy")))
    assert t_files == ["emb.w.p0s0.npy", "emb.w.p1s0.npy"]
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    info = meta["vars"]["w"]
    assert info["shape"] == [8, 12]
    assert sorted(tuple(s["index"][0]) for s in info["shards"]) == \
        [(i * 2, (i + 1) * 2) for i in range(4)]


def test_sharded_restore_onto_different_sharding(world4):
    """Saved on (dp, tp) x None, restored in the same world onto a dp x tp
    grid: each rank's window of the same array."""
    w = np.random.RandomState(1).randn(8, 12).astype(np.float32)
    for rank in range(4):
        r = world4["ranks"][rank]["ckpt"]
        dp, tp = divmod(rank, 2)
        np.testing.assert_array_equal(
            r["w_onto_dp_tp"], w[dp * 4:(dp + 1) * 4, tp * 6:(tp + 1) * 6])
        assert r["w_layout"]["index"] == [[dp * 4, dp * 4 + 4],
                                          [tp * 6, tp * 6 + 6]]


def test_four_rank_checkpoint_restores_in_jax_and_in_one_process(world4):
    from paddle_tpu.distributed import CheckpointManager as JCM
    from paddle_tpu_torch.distributed import CheckpointManager
    w = np.random.RandomState(1).randn(8, 12).astype(np.float32)
    d = world4["port_ckpt"]
    back = ptt.Scope()
    assert CheckpointManager(d, device="cpu").restore(scope=back) == 3
    np.testing.assert_array_equal(back.numpy("w"), w)
    jsc = pt.core.Scope()
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=4))
    jsc.set("w", jax.device_put(jnp.zeros((8, 12), jnp.float32),
                                NamedSharding(mesh, JP("dp", "tp"))))
    JCM(d).restore(scope=jsc)
    got = jsc.get("w")
    assert got.sharding.spec == JP("dp", "tp")
    np.testing.assert_array_equal(np.asarray(got), w)


def test_jax_sharded_checkpoint_restores_onto_four_ranks(world4):
    """The JAX 8-piece table onto tp=2 pieces replicated over dp=2."""
    for rank in range(4):
        r = world4["ranks"][rank]["ckpt"]
        tp = rank % 2
        np.testing.assert_array_equal(r["restored_piece"],
                                      TABLE[tp * 8:(tp + 1) * 8])
        assert r["restored_layout"]["writer"] == (rank // 2 == 0)
