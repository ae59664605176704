"""Multi-rank worlds of the port on the CPU, for the parallel tests
(tests/test_torch_parallel*.py).

A world is ``n`` rank processes from ``torch.multiprocessing`` (spawn)
joined over gloo through a ``FileStore`` under the test's ``tmp_path``
(``launch.init_distributed(init_method="file://...", device="cpu")``).
Each rank runs one function of this module and pickles what it returns;
``run_world`` returns the ranks' results.  Each world runs many checks,
so that few worlds are started.

The functions that build programs take the package (``paddle_tpu`` or
``paddle_tpu_torch``) as their first argument, so both packages build
the same programs with the same names; the JAX side runs in the test
process, on the simulated CPU devices.  This module imports no JAX:
the rank processes load it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------
def run_world(n, fn, root, *args):
    """``fn(rank, n, *args)`` in each of ``n`` gloo rank processes;
    returns their results in rank order."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, "store")
    if os.path.exists(store):
        os.remove(store)
    torch.multiprocessing.start_processes(
        _rank_main, args=(n, fn, root, args), nprocs=n, join=True,
        start_method="spawn")
    out = []
    for r in range(n):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, n, fn, root, args):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import launch
    launch.init_distributed(init_method="file://" + os.path.join(
        root, "store"), num_processes=n, process_id=rank, device="cpu",
        timeout_s=120)
    try:
        out = fn(rank, n, *args)
    finally:
        launch.shutdown()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# Programs (either package)
# ---------------------------------------------------------------------------
def _fresh(pkg, seed=0):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    return main, startup


def build_mlp(pkg, tp=False, momentum=False):
    """tests/test_parallel.py's MLP: 16 -> 32 (relu) -> 10 (softmax), mean
    cross entropy; with ``tp`` the column/row-parallel weights ``w_col``
    (None, 'tp') and ``w_row`` ('tp', None)."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        img = L.data("img", shape=[16], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        hidden = L.fc(img, size=32, act="relu", param_attr=pkg.ParamAttr(
            name="w_col", sharding=(None, "tp")) if tp else None)
        pred = L.fc(hidden, size=10, act="softmax", param_attr=pkg.ParamAttr(
            name="w_row", sharding=("tp", None)) if tp else None)
        loss = L.mean(L.cross_entropy(pred, label))
        opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9) \
            if momentum else pkg.optimizer.SGD(learning_rate=0.1)
        opt.minimize(loss)
    return main, startup, loss


def mlp_feeds(batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 16).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def build_smoke_mlp(pkg):
    """bench.py's planner smoke MLP (``bench.py:311-324``): 256 -> 512
    (relu) -> 128 (softmax), mean cross entropy, SGD 0.1."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", shape=[256], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(x, size=512, act="relu")
        pred = L.fc(h, size=128, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def smoke_feeds(batch=64, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(batch, 256).astype("float32"),
            "label": rng.randint(0, 128, (batch, 1)).astype("int64")}


def build_res(pkg, img=16, classes=10):
    """A reduced bottleneck ResNet with batch norm (``models/resnet.py``'s
    conv_bn_layer and bottleneck_block, one plain and one strided block)
    under the classification head: fc logits, softmax_with_cross_entropy,
    mean, accuracy, Momentum."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L, R = pkg.layers, pkg.models.resnet
        image = L.data("img", [3, img, img])
        label = L.data("label", [1], dtype="int64")
        h = R.conv_bn_layer(image, 8, 3, stride=1, padding=1)
        h = R.bottleneck_block(h, 8, 4, 1)
        h = R.bottleneck_block(h, 16, 8, 2)
        h = L.pool2d(h, pool_type="avg", global_pooling=True)
        logits = L.fc(h, size=classes)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        acc = L.accuracy(logits, label, k=1)
        pkg.optimizer.Momentum(learning_rate=0.01,
                               momentum=0.9).minimize(loss)
    return main, startup, (loss, acc, logits)


def res_feeds(batch=8, img=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 3, img, img).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def build_wide_deep(pkg):
    """tests/test_sharded_embedding.py's wide_deep: two id slots (vocab
    32 and 64), emb 8, one hidden layer of 16, log loss, Adagrad 0.1."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        ids1 = L.data("f1", shape=[1], dtype="int64")
        ids2 = L.data("f2", shape=[1], dtype="int64")
        dense = L.data("dense", shape=[4], dtype="float32")
        label = L.data("ctr", shape=[1], dtype="float32")
        pred = pkg.models.wide_deep([ids1, ids2], dense, vocab_sizes=[32, 64],
                                    emb_dim=8, deep_hidden=(16,))
        loss = L.mean(L.log_loss(pred, label))
        pkg.optimizer.Adagrad(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def wide_deep_feeds(seed=0):
    rng = np.random.RandomState(seed)
    return {"f1": rng.randint(0, 32, (16, 1)).astype("int64"),
            "f2": rng.randint(0, 64, (16, 1)).astype("int64"),
            "dense": rng.rand(16, 4).astype("float32"),
            "ctr": rng.randint(0, 2, (16, 1)).astype("float32")}


def table_specs(main):
    """Every embedding table sharded by vocab rows over tp."""
    return {p.name: ("tp", None) for p in main.all_parameters()
            if "embedding" in p.name}


def trainer_reader(n_batches=6, batch=16):
    def r():
        rng = np.random.RandomState(3)
        for _ in range(n_batches):
            f = mlp_feeds(batch, int(rng.randint(1 << 30)))
            yield list(zip(f["img"], f["label"]))
    return r


def build_trainer(pkg, place=None):
    """A v2 trainer over the MLP in the package's default programs."""
    pkg.core.reset_default_programs()
    pkg.core.reset_global_scope()
    pkg.unique_name.reset()
    pkg.default_startup_program().random_seed = 0
    L = pkg.layers
    img = L.data("img", shape=[16], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    hidden = L.fc(img, size=32, act="relu")
    pred = L.fc(hidden, size=10, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    kw = {} if place is None else {"place": place}
    return pkg.trainer.SGD(cost=loss, update_equation=pkg.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9), **kw), [img, label]


def train_costs(sgd, feed_list, **kw):
    costs = []

    def handler(e):
        if hasattr(e, "cost"):
            costs.append(float(np.asarray(e.cost).reshape(-1)[0]))
    sgd.train(trainer_reader(), num_passes=1, event_handler=handler,
              feed_list=feed_list, **kw)
    return costs


# ---------------------------------------------------------------------------
# Rank work (the port only)
# ---------------------------------------------------------------------------
def _port():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import parallel
    return ptt, parallel


def _scope(ptt, state):
    sc = ptt.Scope()
    ptt.load_numpy_state(sc, state, "cpu")
    return sc


def _losses(exe, main, loss, feeds, scope, steps):
    return [float(exe.run(main, feed=feeds, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)]


def _plain(ptt, main, loss, feeds, state, steps, amp=False):
    sc = _scope(ptt, state)
    exe = ptt.Executor(ptt.CPUPlace(), amp=amp)
    return _losses(exe, main, loss, feeds, sc, steps), \
        {k: sc.numpy(k) for k in sc.keys()}


def dp_tp_round(rank, n, states, mesh_axes):
    """The MLP rounds of one world: dp training (fp32 and AMP), the
    tp-sharded weights, run_steps against per-step runs.  ``mesh_axes``:
    {"dp": .., "tp": ..} of the tp mesh."""
    ptt, par = _port()
    cpu = ptt.CPUPlace()
    out = {}
    feeds = mlp_feeds()
    # dp over the whole world, fp32 (SGD) and AMP (Momentum)
    for tag, mom, amp, steps in (("dp", False, False, 3),
                                 ("dp_amp", True, False, 4),
                                 ("amp", True, True, 4)):
        main, _, loss = build_mlp(ptt, momentum=mom)
        state = states["mlp_mom" if mom else "mlp"]
        exe = par.ShardedExecutor(mesh=par.make_mesh(par.MeshConfig(dp=n)),
                                  place=cpu, amp=amp)
        sc = _scope(ptt, state)
        got = _losses(exe, main, loss, feeds, sc, steps)
        want, want_sc = _plain(ptt, main, loss, feeds, state, steps, amp)
        out[tag] = {"losses": got, "plain": want,
                    "state": exe.global_state(main, sc, names=sc.keys()),
                    "plain_state": want_sc,
                    "dtypes": {k: str(sc.get(k).dtype) for k in sc.keys()}}
    # AMP run_steps window against the unsharded AMP steps
    main, _, loss = build_mlp(ptt, momentum=True)
    exe = par.ShardedExecutor(mesh=par.make_mesh(par.MeshConfig(dp=n)),
                              place=cpu, amp=True)
    sc = _scope(ptt, states["mlp_mom"])
    (lv,) = exe.run_steps(5, main, feed=feeds, fetch_list=[loss], scope=sc)
    out["amp_window"] = {"losses": np.asarray(lv).reshape(-1).tolist(),
                         "plain": _plain(ptt, main, loss, feeds,
                                         states["mlp_mom"], 5, True)[0]}
    # the tp-sharded weights
    main, _, loss = build_mlp(ptt, tp=True)
    mesh = par.make_mesh(shape=list(mesh_axes.values()),
                         axis_names=list(mesh_axes))
    exe = par.ShardedExecutor(mesh=mesh, place=cpu)
    sc = _scope(ptt, states["mlp_tp"])
    exe.place_state(main, sc)
    got = _losses(exe, main, loss, feeds, sc, 3)
    out["tp"] = {"losses": got,
                 "plain": _plain(ptt, main, loss, feeds, states["mlp_tp"],
                                 3)[0],
                 "w_col_local": tuple(sc.get("w_col").shape),
                 "layout": dict(sc.layouts.get("w_col", {})),
                 "state": exe.global_state(main, sc, names=sc.keys())}
    # run_steps == per-step on the tp mesh; stacked feeds
    sc1 = _scope(ptt, states["mlp_tp"])
    exe1 = par.ShardedExecutor(mesh=mesh, place=cpu)
    seq = _losses(exe1, main, loss, feeds, sc1, 4)
    sc2 = _scope(ptt, states["mlp_tp"])
    exe2 = par.ShardedExecutor(mesh=mesh, place=cpu)
    (stacked,) = exe2.run_steps(4, main, feed=feeds, fetch_list=[loss],
                                scope=sc2)
    w_stacked = exe2.global_state(main, sc2, names=["w_col"])["w_col"]
    k_feeds = {k: np.stack([v] * 3) for k, v in feeds.items()}
    (st3,) = exe2.run_steps(3, main, feed=k_feeds, fetch_list=[loss],
                            scope=sc2, feeds_stacked=True)
    out["run_steps"] = {
        "seq": seq, "stacked": np.asarray(stacked).reshape(-1).tolist(),
        "w_seq": exe1.global_state(main, sc1, names=["w_col"])["w_col"],
        "w_stacked": w_stacked,
        "stacked3": np.asarray(st3).reshape(-1).tolist()}
    return out


def res_round(rank, n, state):
    """One fp32 step of the reduced bottleneck ResNet at dp=n from
    ``state``, and the unsharded step."""
    ptt, par = _port()
    cpu = ptt.CPUPlace()
    main, _, (loss, acc, logits) = build_res(ptt)
    feeds = res_feeds()
    exe = par.ShardedExecutor(mesh=par.make_mesh(par.MeshConfig(dp=n)),
                              place=cpu, auto_shard=True)
    par.collective.reset_counts()
    sc = _scope(ptt, state)
    got = exe.run(main, feed=feeds, fetch_list=[loss, acc, logits],
                  scope=sc)
    calls = dict(par.collective.calls)
    ref_sc = _scope(ptt, state)
    ref = ptt.Executor(cpu).run(main, feed=feeds,
                                fetch_list=[loss, acc, logits],
                                scope=ref_sc)
    from paddle_tpu_torch.core import compile_cache
    return {"fetches": got, "plain": ref, "calls": calls,
            "candidate": exe.auto_plan.candidate,
            "uncaptured": dict(compile_cache.stats().uncaptured),
            "state": exe.global_state(main, sc, names=sc.keys()),
            "plain_state": {k: ref_sc.numpy(k) for k in ref_sc.keys()}}


def wide_deep_round(rank, n, state, mesh_axes):
    """wide_deep with every table vocab-sharded over tp, 4 steps, and the
    unsharded run."""
    ptt, par = _port()
    cpu = ptt.CPUPlace()
    main, _, loss = build_wide_deep(ptt)
    feeds = wide_deep_feeds()
    mesh = par.make_mesh(shape=list(mesh_axes.values()),
                         axis_names=list(mesh_axes))
    specs = table_specs(main)
    exe = par.ShardedExecutor(mesh=mesh, param_specs=specs, place=cpu)
    sc = _scope(ptt, state)
    exe.place_state(main, sc)
    got = _losses(exe, main, loss, feeds, sc, 4)
    name = sorted(specs)[0]
    return {"losses": got, "plain": _plain(ptt, main, loss, feeds, state,
                                           4)[0],
            "tables": len(specs), "local": tuple(sc.get(name).shape),
            "global": tuple(exe.global_state(main, sc, [name])[name].shape),
            "state": exe.global_state(main, sc, names=sc.keys())}


def smoke_round(rank, n, state):
    """The planner smoke MLP under ShardedExecutor(auto_shard=True,
    validate=True) on a dp2 x tp2 mesh, 3 steps, and the unsharded
    run."""
    ptt, par = _port()
    cpu = ptt.CPUPlace()
    main, _, loss = build_smoke_mlp(ptt)
    feeds = smoke_feeds()
    mesh = par.mesh_for_axes({"dp": 2, "tp": 2})
    exe = par.ShardedExecutor(mesh=mesh, batch_axis="dp", auto_shard=True,
                              validate=True, place=cpu)
    sc = _scope(ptt, state)
    got = _losses(exe, main, loss, feeds, sc, 3)
    plan = exe.auto_plan
    return {"losses": got,
            "plain": _plain(ptt, main, loss, feeds, state, 3)[0],
            "candidate": plan.candidate,
            "param_specs": {k: [list(e) if e else None for e in v]
                            for k, v in plan.param_specs.items()},
            "local": {k: tuple(sc.get(k).shape) for k in plan.param_specs},
            "label": exe._observe_label(),
            "state": exe.global_state(main, sc, names=sc.keys())}


def amp_tp_round(rank, n, state):
    """AMP on a dp2 x tp2 mesh with the tp-sharded MLP (Momentum), 4
    steps, and the unsharded AMP run."""
    ptt, par = _port()
    cpu = ptt.CPUPlace()
    main, _, loss = build_mlp(ptt, tp=True, momentum=True)
    feeds = mlp_feeds()
    exe = par.ShardedExecutor(mesh=par.make_mesh(par.MeshConfig(dp=2, tp=2)),
                              place=cpu, amp=True)
    sc = _scope(ptt, state)
    exe.place_state(main, sc)
    return {"losses": _losses(exe, main, loss, feeds, sc, 4),
            "plain": _plain(ptt, main, loss, feeds, state, 4, True)[0]}


def collectives_round(rank, n):
    """The collectives' values and gradients over a 1-D 'tp' mesh of the
    world, the manual sharded lookup and its gradient rows, and the
    identity outside spmd."""
    ptt, par = _port()
    col, emb = par.collective, par.embedding
    mesh = par.make_mesh(shape=[n], axis_names=["tp"])
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    out = {"outside": [col.psum(x, "tp").tolist(),
                       col.all_gather(x, "tp").tolist()]}
    with col.spmd(mesh):
        xr = x.clone().requires_grad_(True)
        s = col.psum(xr, "tp")
        (s * (rank + 1)).sum().backward()
        out["psum"] = s.tolist()
        out["psum_grad"] = xr.grad.tolist()
        out["mean"] = col.all_reduce(x, "tp", "mean").tolist()
        out["max"] = col.all_reduce(x, "tp", "max").tolist()
        out["min"] = col.all_reduce(x, "tp", "min").tolist()
        xg = x.clone().requires_grad_(True)
        g = col.all_gather(xg, "tp")
        (g * torch.arange(g.numel(), dtype=torch.float32)).sum().backward()
        out["gather"] = g.tolist()
        out["gather_grad"] = xg.grad.tolist()
        out["stacked"] = col.all_gather(x, "tp", tiled=False).tolist()
        out["scatter"] = col.reduce_scatter(
            torch.arange(2 * n, dtype=torch.float32) * (rank + 1),
            "tp").tolist()
        out["ppermute"] = col.ppermute(
            x, "tp", [(i, (i + 1) % n) for i in range(n)]).tolist()
        out["broadcast"] = col.broadcast(x, "tp", src=n - 1).tolist()
        out["barrier"] = float(col.barrier("tp"))
        out["all_to_all"] = col.all_to_all(
            torch.arange(2 * n, dtype=torch.float32) + 100 * rank, "tp",
            0, 0).tolist()
        V, D = 8 * n, 4
        table = torch.arange(V * D, dtype=torch.float32).reshape(V, D)
        ids = torch.tensor([[0], [V - 1], [3], [V // 2], [3]])
        local = table[rank * 8:(rank + 1) * 8].clone().requires_grad_(True)
        rows = emb.sharded_lookup(local, ids, "tp")
        gout = torch.arange(rows.numel(), dtype=torch.float32).reshape(
            rows.shape)
        (rows * gout).sum().backward()
        out["lookup"] = rows.tolist()
        out["lookup_grad"] = local.grad.tolist()
        out["grad_rows"] = emb.sharded_lookup_grad_rows(
            ids, gout, V, "tp").tolist()
        out["padded"] = emb.sharded_lookup(local.detach(), ids, "tp",
                                           padding_idx=3).tolist()
    # DataParallel's divisibility error and shard_batch
    dp = par.DataParallel(par.ShardedExecutor(
        mesh=par.make_mesh(par.MeshConfig(dp=n)), place=ptt.CPUPlace()))
    main, _, loss = build_mlp(ptt)
    try:
        dp.run(main, feed=mlp_feeds(batch=2 * n + 1), fetch_list=[loss])
        out["divisible_error"] = None
    except ValueError as e:
        out["divisible_error"] = str(e)
    out["shard_batch"] = par.shard_batch(
        {"a": np.arange(4 * n).reshape(2 * n, 2), "s": np.float32(3)},
        dp.mesh)["a"].tolist()
    return out


def checkpoint_round(rank, n, jax_dir, out_dir):
    """A JAX sharded checkpoint restored onto this world's tp pieces, and
    this world's own sharded save (``emb.w`` [16, 64] on tp; ``w``
    [8, 12] on (dp, tp) x None where the world has 4 ranks)."""
    ptt, par = _port()
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.parallel.sharded import place
    mesh = par.make_mesh(par.MeshConfig(tp=n)) if n == 2 else \
        par.make_mesh(par.MeshConfig(dp=2, tp=2))
    out = {}
    fresh = ptt.Scope()
    fresh.set("emb.w", torch.zeros(16, 64))
    prog = _table_program(ptt)
    place(prog, fresh, mesh, {"emb.w": ("tp", None)})
    step = CheckpointManager(jax_dir, device="cpu").restore(scope=fresh)
    out["restored_step"] = step
    out["restored_piece"] = fresh.get("emb.w").numpy().copy()
    out["restored_layout"] = dict(fresh.layouts["emb.w"])
    sc = ptt.Scope()
    table = np.arange(16 * 64, dtype=np.float32).reshape(16, 64)
    sc.set("emb.w", torch.from_numpy(table.copy()))
    sc.set("step_count", torch.tensor([7], dtype=torch.int64))
    specs = {"emb.w": ("tp", None)}
    if n == 4:
        sc.set("w", torch.from_numpy(
            np.random.RandomState(1).randn(8, 12).astype(np.float32)))
        specs["w"] = (("dp", "tp"), None)
    place(prog, sc, mesh, specs)
    cm = CheckpointManager(out_dir, async_save=False, device="cpu")
    cm.save(3, sc)
    out["saved_layouts"] = {k: dict(v) for k, v in sc.layouts.items()}
    # the same commit restored onto the same sharding of the table
    same = ptt.Scope()
    same.set("emb.w", torch.zeros(16, 64))
    place(prog, same, mesh, {"emb.w": ("tp", None)})
    cm.restore(scope=same)
    out["same_piece"] = same.get("emb.w").numpy().copy()
    if n == 4:
        # the same commit restored onto another sharding of w: (dp, tp)
        back = ptt.Scope()
        back.set("w", torch.zeros(8, 12))
        place(prog, back, mesh, {"w": ("dp", "tp")})
        cm.restore(scope=back)
        out["w_onto_dp_tp"] = back.get("w").numpy().copy()
        out["w_layout"] = dict(back.layouts["w"])
    return out


def _table_program(ptt):
    """A program declaring the checkpoint round's vars."""
    main = ptt.Program()
    gb = main.global_block()
    gb.create_var(name="emb.w", shape=[16, 64], dtype="float32",
                  persistable=True)
    gb.create_var(name="w", shape=[8, 12], dtype="float32",
                  persistable=True)
    return main


def trainer_round(rank, n, state):
    """train(auto_shard="dp=2") on a ShardedExecutor from ``state`` (the
    JAX startup's weights), and a fresh trainer whose first train() takes
    the mesh form and swaps its executor."""
    ptt, par = _port()
    cpu = ptt.CPUPlace()
    sgd, fl = build_trainer(ptt, place=cpu)
    sgd.exe = par.ShardedExecutor(mesh=par.mesh_for_axes({"dp": n}),
                                  place=cpu)
    ptt.load_numpy_state(ptt.global_scope(), state, "cpu")
    sgd._initialized = True
    got = train_costs(sgd, fl, auto_shard=f"dp={n}")
    out = {"costs": got, "auto_plan": sgd.exe.auto_plan.candidate}
    sgd2, fl2 = build_trainer(ptt, place=cpu)
    out["swapped_costs"] = train_costs(sgd2, fl2, auto_shard={"dp": n})
    out["swapped"] = type(sgd2.exe).__name__
    return out


def fault_tolerance_round(rank, n, ckpt_dir):
    """tests/test_torch_fault_tolerance.py's classifier (no dropout: the
    ranks' local masks are not the whole batch's) trained under
    auto_shard with checkpoints every 4 steps."""
    ptt, par = _port()
    import test_torch_fault_tolerance as ft
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    tr = ft._build_trainer(dropout=0)
    ev = ft._collect(tr, ft._reader(), num_passes=1,
                     checkpoint_dir=ckpt_dir, save_every_n_steps=4,
                     auto_shard={"dp": n})
    return {"events": ev, "exe": type(tr.exe).__name__}


def world_rounds(rank, n, states, jax_dir, out_dir):
    """Every round of one world (2 or 4 ranks), in one start."""
    out = {"coll": collectives_round(rank, n),
           "res": res_round(rank, n, states["res"]),
           "ckpt": checkpoint_round(rank, n, jax_dir, out_dir)}
    if n == 2:
        out["mlp"] = dp_tp_round(rank, n, states, {"dp": 1, "tp": 2})
        out["wd"] = wide_deep_round(rank, n, states["wd"],
                                    {"dp": 1, "tp": 2})
        out["trainer"] = trainer_round(rank, n, states["trainer"])
    else:
        out["smoke"] = smoke_round(rank, n, states["smoke"])
        out["amp_tp"] = amp_tp_round(rank, n, states["mlp_tp_mom"])
        out["wd"] = wide_deep_round(rank, n, states["wd"],
                                    {"dp": 2, "tp": 2})
    return out


def input_pipeline_round(rank, n, state, cfg):
    """benchmark/input_pipeline.py's wide_deep trainer from ``state`` (the
    JAX startup's weights) under train(auto_shard={'dp': n}) on a
    ShardedExecutor; its events and costs (two passes)."""
    ptt, par = _port()
    from paddle_tpu_torch.benchmark import input_pipeline as tip
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    sgd, fl = tip.build_wide_deep(cfg, place=ptt.CPUPlace())
    ptt.load_numpy_state(ptt.global_scope(), state, "cpu")
    sgd._initialized = True
    sgd.exe = par.ShardedExecutor(mesh=par.mesh_for_axes({"dp": n}),
                                  place=ptt.CPUPlace())
    events, costs = [], []

    def handler(e):
        events.append((type(e).__name__, e.pass_id,
                       getattr(e, "batch_id", None)))
        if hasattr(e, "cost"):
            costs.append(float(np.asarray(e.cost).reshape(-1)[0]))
    sgd.train(tip.make_reader(cfg), num_passes=2, event_handler=handler,
              feed_list=fl, auto_shard={"dp": n})
    return {"events": events, "costs": costs,
            "exe": type(sgd.exe).__name__, "plan": sgd.exe.auto_plan.candidate}
