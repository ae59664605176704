"""The port's sparse wire tier (``paddle_tpu_torch/sparse/{wire,pserver,
client}.py``) with real sockets and frames, the shard servers on
threads of this interpreter as ``tests/test_pserver.py`` runs the JAX
package's:

* a 2-shard fleet driven through :class:`RemoteSparseTable` gives the
  rows, Adagrad moments and exports of ``SparseTable(num_shards=2)``,
  bit for bit, and a ``SparseSession`` trains through it as through the
  in-process table;
* the wire crosses packages: the port's client drives the JAX
  package's ``PServer`` (and holds the JAX table's arithmetic there),
  the JAX client drives the port's;
* the naive per-row JSON arm, exactly-once pushes under a dropped frame
  and a transient refusal, and the chain backup that outlives a shard;
* in a subprocess (``slow``): ``python -m paddle_tpu_torch pserver``
  prints its ready line, makes no CUDA context, and checkpoints and
  exits 75 on SIGTERM; a relaunch restores.

JAX is imported inside the cross-package test only, so the ``cuda``
test runs on a machine without it (``python3 -m pytest --noconftest -m
cuda tests/test_torch_pserver.py``).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.faults import RetryPolicy
from paddle_tpu_torch.sparse import SparseSession, SparseTable
from paddle_tpu_torch.sparse.client import RemoteSparseTable
from paddle_tpu_torch.sparse.pserver import PServer
from paddle_tpu_torch.testing import faultinject

HOST = "127.0.0.1"
IO_TO = 10.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=64, dim=4, optimizer="adagrad", learning_rate=0.1,
          seed=7)


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="pt-pserver-serve")
    t.start()
    return t


def _fleet(cls, n=2, backup=True):
    servers = [cls(k, n, host=HOST, io_timeout_s=IO_TO) for k in range(n)]
    for s in servers:
        s.start()
    if backup:
        for k, s in enumerate(servers):
            s.backup_addr = (HOST, servers[(k + 1) % n].port)
    return servers, [_serve(s) for s in servers]


def _stop(servers, threads):
    for s in servers:
        s.stop()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive()


@pytest.fixture
def fleet2():
    servers, threads = _fleet(PServer)
    try:
        yield servers
    finally:
        _stop(servers, threads)


def _addrs(servers):
    return [(HOST, s.port) for s in servers]


def _rounds(remote, oracle, rounds=5, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        ids = rng.choice(KW["vocab_size"], size=10,
                         replace=False).astype(np.int64)
        g = rng.standard_normal((10, KW["dim"])).astype(np.float32)
        np.testing.assert_array_equal(remote.pull(ids), oracle.pull(ids))
        remote.push(ids, g)
        oracle.push(ids, g)
    return rng


def _same(remote, oracle):
    ids = np.arange(KW["vocab_size"], dtype=np.int64)
    assert remote.pull(ids).tobytes() == oracle.pull(ids).tobytes()
    assert remote.pull_slot("moment", ids).tobytes() == \
        oracle.pull_slot("moment", ids).tobytes()
    got, want = remote.export_state_vars(), oracle.export_state_vars()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_remote_bit_identical_to_in_process(fleet2):
    oracle = SparseTable("t", num_shards=2, **KW)
    with RemoteSparseTable("t", addrs=_addrs(fleet2), io_timeout_s=IO_TO,
                           **KW) as rt:
        _rounds(rt, oracle)
        _same(rt, oracle)
        assert rt.live_rows == oracle.live_rows
        stats = rt.fleet_stats()
        assert all(not st["cuda_initialized"] for st in stats.values())
        # a remote export restores into an in-process table of any width
        local = SparseTable("t", num_shards=3, **KW)
        local.restore_state_vars(rt.export_state_vars())
        ids = np.arange(64, dtype=np.int64)
        assert local.pull(ids).tobytes() == oracle.pull(ids).tobytes()


@pytest.mark.parametrize("client_pkg", ["port", "jax"],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
def test_wire_crosses_packages(client_pkg):
    """The frames are one protocol: either package's client drives
    either package's shards, whose table arithmetic is the server's."""
    from paddle_tpu.sparse import SparseTable as JTable
    from paddle_tpu.sparse.client import RemoteSparseTable as JRemote
    from paddle_tpu.sparse.pserver import PServer as JServer
    client, server, oracle = (RemoteSparseTable, JServer, JTable) \
        if client_pkg == "port" else (JRemote, PServer, SparseTable)
    servers, threads = _fleet(server)
    try:
        want = oracle("t", num_shards=2, **KW)
        with client("t", addrs=_addrs(servers), io_timeout_s=IO_TO,
                    **KW) as rt:
            _rounds(rt, want, seed=3)
            _same(rt, want)
    finally:
        _stop(servers, threads)


def test_naive_json_arm_same_rows(fleet2):
    oracle = SparseTable("t", num_shards=2, **KW)
    with RemoteSparseTable("t", addrs=_addrs(fleet2), io_timeout_s=IO_TO,
                           wire_mode="naive", **KW) as rt:
        _rounds(rt, oracle, rounds=2, seed=5)
        ids = np.arange(64, dtype=np.int64)
        assert rt.pull(ids).tobytes() == oracle.pull(ids).tobytes()


def test_push_retry_dedup_exactly_once():
    s = PServer(0, 1, host=HOST)
    s._op_create({"spec": {"name": "t", "vocab_size": 8, "dim": 2,
                           "learning_rate": 1.0,
                           "init": ["constant", 0.0]}}, ())
    ids = np.array([1, 3], np.int64)
    g = np.ones((2, 2), np.float32)
    hdr = {"op": "push", "table": "t", "cid": "c1", "seq": 0, "lr": None}
    assert s._op_push(dict(hdr), (ids, g))[0]["updated"] == 2
    r2, _ = s._op_push(dict(hdr), (ids, g))      # the client's replay
    assert r2.get("dup") is True and r2["updated"] == 0
    assert s.pushes_applied == 1
    _, (pulled,) = s._op_pull({"op": "pull", "table": "t"}, (ids,))
    np.testing.assert_array_equal(pulled, -np.ones((2, 2), np.float32))
    assert s._op_push({**hdr, "seq": 1}, (ids, g))[0]["updated"] == 2


@pytest.mark.parametrize("spec", ["pserver.rpc@6=drop;pserver.rpc@9=drop",
                                  "pserver.rpc@3=transient"])
def test_faults_retry_exactly_once(fleet2, spec):
    """A dropped frame reconnects and replays the round, a transient
    refusal retries it; the (cid, seq) dedup keeps pushes exactly
    once."""
    oracle = SparseTable("t", num_shards=2, **KW)
    with RemoteSparseTable(
            "t", addrs=_addrs(fleet2), io_timeout_s=IO_TO,
            retry=RetryPolicy(max_attempts=5, backoff_base_s=0.01,
                              jitter=0.0), **KW) as rt:
        faultinject.configure(spec)
        try:
            _rounds(rt, oracle, rounds=4, seed=8)
        finally:
            faultinject.clear()
        _same(rt, oracle)


@pytest.mark.parametrize("spec", ["pserver.rpc@1=transient",
                                  "pserver.rpc@2=transient"],
                         ids=["hello", "create"])
def test_transient_on_handshake_is_retried(spec):
    """A transient answer to the handshake a fresh client sends (its
    first ``hello``, or the ``create`` after it) is retried as a round's
    transient is, not read as a wiring mismatch.  One shard, so the
    shard's first and second requests are the handshake's."""
    servers, threads = _fleet(PServer, n=1, backup=False)
    try:
        oracle = SparseTable("t", num_shards=1, **KW)
        faultinject.configure(spec)
        try:
            with RemoteSparseTable(
                    "t", addrs=_addrs(servers), io_timeout_s=IO_TO,
                    retry=RetryPolicy(max_attempts=3, backoff_base_s=0.01,
                                      jitter=0.0), **KW) as rt:
                _rounds(rt, oracle, rounds=3, seed=4)
                assert faultinject.fired("pserver.rpc") == 1
                assert rt._dials[0] == 2
                _same(rt, oracle)
        finally:
            faultinject.clear()
    finally:
        _stop(servers, threads)


def test_chain_backup_survives_shard_death(fleet2):
    """Shard 0 dies with no checkpoint: its relaunch restores every
    acked push from the copy shard 1 holds, and the same client trains
    on through the relaunch."""
    oracle = SparseTable("t", num_shards=2, **KW)
    s0, s1 = fleet2
    with RemoteSparseTable("t", addrs=_addrs(fleet2), io_timeout_s=IO_TO,
                           **KW) as rt:
        rng = _rounds(rt, oracle, rounds=6, seed=1)
        applied0 = s0.pushes_applied
        assert any(origin == 0 for origin, _ in s1._backups)
        s0.stop()
        deadline = time.monotonic() + 5.0
        while s0._listen is not None and time.monotonic() < deadline:
            time.sleep(0.02)
        s0b = PServer(0, 2, host=HOST, port=s0.port,
                      backup_addr=(HOST, s1.port), io_timeout_s=IO_TO)
        s0b.start()
        assert s0b.pushes_applied == applied0
        t = _serve(s0b)
        try:
            for _ in range(3):
                ids = rng.choice(64, size=10,
                                 replace=False).astype(np.int64)
                g = rng.standard_normal((10, 4)).astype(np.float32)
                rt.push(ids, g)
                oracle.push(ids, g)
            _same(rt, oracle)
        finally:
            _stop([s0b], [t])


def test_session_trains_through_a_remote_table(fleet2):
    """The CTR-style rim over a remote table: the same losses and table
    as over the in-process one."""
    def run(table):
        _reset()
        L = ptt.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        label = L.data("label", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[64, 4], sparse=True, name="t")
        loss = L.mean(L.square(L.fc(emb, size=1) - label))
        ptt.optimizer.Adagrad(learning_rate=0.1).minimize(loss)
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(ptt.default_startup_program())
        sess = SparseSession(table)
        rng = np.random.RandomState(0)
        out = []
        for _ in range(5):
            feed = {"ids": rng.randint(0, 64, (16, 1)),
                    "label": rng.rand(16, 1).astype(np.float32)}
            out.append(float(sess.run(exe, ptt.default_main_program(),
                                      feed, [loss])[0]))
        return out

    local = SparseTable("t", num_shards=2, **KW)
    with RemoteSparseTable("t", addrs=_addrs(fleet2), io_timeout_s=IO_TO,
                           **KW) as rt:
        assert run(rt) == run(local)
        _same(rt, local)


def _reset():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def _free_port():
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "pserver"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    for line in proc.stdout:
        if '"pserver"' in line:
            return proc, json.loads(line)["pserver"]
    proc.wait(timeout=30)
    raise AssertionError(f"pserver exited before its ready line "
                         f"(rc {proc.returncode})")


@pytest.mark.slow
def test_subprocess_sigterm_checkpoints_exits_75_and_restores(tmp_path):
    port = _free_port()
    args = ["--shard", "0/1", "--host", HOST, "--port", str(port),
            "--dir", str(tmp_path)]
    proc, ready = _launch(args)
    try:
        assert ready["port"] == port and not ready["cuda_initialized"]
        oracle = SparseTable("t", num_shards=1, **KW)
        with RemoteSparseTable("t", addrs=[(HOST, port)],
                               io_timeout_s=IO_TO, **KW) as rt:
            _rounds(rt, oracle, rounds=3, seed=2)
            assert not rt.fleet_stats()[0]["cuda_initialized"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 75
        proc, _ = _launch(args)
        with RemoteSparseTable("t", addrs=[(HOST, port)],
                               io_timeout_s=IO_TO, **KW) as rt:
            _same(rt, oracle)
    finally:
        proc.kill()
        proc.wait(timeout=30)


@pytest.mark.slow
def test_other_subcommands_are_refused():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "stats"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "not ported" in out.stderr


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.slow
def test_shard_server_makes_no_cuda_context_beside_a_trainer(card):
    """On a card: a trainer that captured its step talks to a shard
    process, which still holds no CUDA context."""
    port = _free_port()
    proc, ready = _launch(["--shard", "0/1", "--host", HOST, "--port",
                           str(port)])
    try:
        assert not ready["cuda_initialized"]
        _reset()
        L = ptt.layers
        ids = L.data("ids", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[64, 4], sparse=True, name="t")
        loss = L.mean(L.square(emb))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = ptt.Executor()
        exe.run(ptt.default_startup_program())
        with RemoteSparseTable("t", addrs=[(HOST, port)],
                               io_timeout_s=IO_TO, **KW) as rt:
            sess = SparseSession(rt, bucket_floor=8)
            for i in range(4):
                sess.run(exe, ptt.default_main_program(),
                         {"ids": np.arange(8).reshape(8, 1) + i}, [loss])
            assert not rt.fleet_stats()[0]["cuda_initialized"]
    finally:
        proc.kill()
        proc.wait(timeout=30)
