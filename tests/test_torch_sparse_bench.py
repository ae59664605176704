"""The sparse tier's benchmarks in the port
(``paddle_tpu_torch/benchmark/checkpoint.py`` and ``pserver.py``) at
their SMOKE sizes on the CPU:

* checkpoint: ``commit_ab`` (full against delta commits from one base:
  the windows, the bytes ratio, both tips restored bit-equal) and
  ``restore_chain`` (a base and k deltas restore to the full save's
  sha); ``elastic_tasks`` (the elastic worker's task-boundary loop
  through the Checkpointer, full against delta commits);
* pserver, against shards served on threads of this interpreter:
  ``wire_ab`` (binary against naive JSON frames, both arms' rows
  bit-equal), ``remote_pull_latency`` and ``shard_pipelining_ab``;
  ``trace_overhead_ab`` (an observing client against an observe-off
  one: the windows and the overhead against its 5% budget);
* ``benchmark.run --model decode|pserver|checkpoint`` delegates instead
  of refusing; the subprocess fleet's whole run is ``slow``.

Gates and timing are not asserted here.
"""
import importlib
import threading

import numpy as np
import pytest

from paddle_tpu_torch.benchmark import checkpoint, pserver
from paddle_tpu_torch.benchmark import run as zoo_run
from paddle_tpu_torch.sparse.pserver import PServer

HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def fleets():
    """A 1-shard and a 2-shard fleet on threads."""
    servers, threads, out = [], [], {}
    for n in (1, 2):
        ss = [PServer(k, n, host=HOST, io_timeout_s=10.0) for k in range(n)]
        for s in ss:
            s.start()
        ts = [threading.Thread(target=s.serve_forever, daemon=True)
              for s in ss]
        for t in ts:
            t.start()
        servers += ss
        threads += ts
        out[n] = [(HOST, s.port) for s in ss]
    yield out
    for s in servers:
        s.stop()
    for t in threads:
        t.join(timeout=5.0)


def _ab_complete(ab, pairs):
    assert len(ab["pair_ratios"]) == max(2, pairs)
    assert len(ab["default_windows"]) == len(ab["candidate_windows"])
    assert all(w > 0 for w in ab["default_windows"] + ab["candidate_windows"])
    assert ab["accepted"] or ab["refusal_reason"]


def test_checkpoint_smoke_rows_complete():
    row = checkpoint.run_all(smoke=True, quiet=True)
    cfg = checkpoint.SMOKE
    assert row["smoke"] is True and row["device"] == "cpu"
    ab = row["commit_ab"]
    _ab_complete(ab, cfg["ab_pairs"])
    assert ab["min_speedup"] == 5.0 and ab["min_bytes_ratio"] == 10.0
    n = max(2, cfg["ab_pairs"])
    assert len(ab["full_bytes_per_commit"]) == n
    assert len(ab["delta_bytes_per_commit"]) == n
    # a delta holds the touched rows only
    assert ab["bytes_ratio"] > 1 and ab["bytes_accepted"] in (True, False)
    assert ab["restore_bit_identical"] is True
    rc = row["restore_chain"]
    assert rc["chain_len"] == cfg["chain_k"] and rc["bit_identical"] is True
    assert rc["chain_restore_ms"] > 0 and rc["full_restore_ms"] > 0
    _ab_complete(row["elastic_tasks"], cfg["elastic_pairs"])


def test_checkpoint_elastic_arm_refuses(tmp_path):
    """The elastic_tasks arm, which refused until the task-queue master
    was ported, now runs: the full arm commits full checkpoints only, the
    delta arm chains deltas onto its base, each window's tasks."""
    cfg = checkpoint.SMOKE
    ab = checkpoint.run_elastic_tasks(cfg, str(tmp_path), quiet=True)
    _ab_complete(ab, cfg["elastic_pairs"])
    assert ab["tasks_per_window"] == cfg["elastic_tasks_per_window"]
    assert ab["commit_kinds"] == {"full": ["full"],
                                  "delta": ["delta", "full"]}
    assert all(v > 0 for v in ab["tasks_per_s"].values())


def test_pserver_arms_on_thread_shards(fleets):
    cfg = pserver.SMOKE
    ab = pserver.run_wire_ab(cfg, fleets[1], quiet=True)
    _ab_complete(ab, cfg["ab_pairs"])
    assert ab["min_speedup"] == 3.0
    assert ab["arms_bit_identical"] is True
    assert ab["rows_per_window"] == cfg["ab_batch"] * cfg["ab_rounds"]
    lat = pserver.run_remote_pull_latency(cfg, fleets[1], quiet=True)
    assert lat["reps"] == cfg["latency_reps"]
    for k in ("remote_ms", "in_process_ms"):
        assert lat[k]["p99"] >= lat[k]["p50"] > 0
    pipe = pserver.run_shard_pipelining_ab(cfg, fleets, quiet=True)
    _ab_complete(pipe, cfg["pipe_pairs"])
    assert pipe["effective_cores"] >= 1
    tr = pserver.run_trace_overhead_ab(cfg, fleets[1], quiet=True)
    n = max(2, cfg["trace_pairs"])
    assert len(tr["observe_on_windows"]) == len(
        tr["observe_off_windows"]) == len(tr["pair_ratios_on_over_off"]) == n
    assert tr["overhead_budget"] == 0.05
    assert tr["within_budget"] == (tr["overhead_frac"] <= 0.05)


def test_runner_delegates_sparse_and_decode_runners(monkeypatch):
    """``--model decode|pserver|checkpoint|compile_cache`` reach their
    runners."""
    got = []
    names = ("decode", "pserver", "checkpoint", "compile_cache")
    for name in names:
        monkeypatch.setattr(
            importlib.import_module(f"paddle_tpu_torch.benchmark.{name}"),
            "main", lambda argv=None, n=name: got.append((n, argv)))
    for name in names:
        assert zoo_run.main(["--model", name, "--smoke",
                             "--device", "cpu"]) == 0
    assert got == [("decode", ["--smoke", "--device", "cpu"]),
                   ("pserver", ["--smoke"]), ("checkpoint", ["--smoke"]),
                   ("compile_cache", ["--smoke", "--device", "cpu"])]


@pytest.mark.slow
def test_pserver_smoke_on_shard_processes():
    row = pserver.run_all(smoke=True, quiet=True)
    assert row["wire_ab"]["arms_bit_identical"] is True
    assert np.isfinite(row["trace_overhead_ab"]["overhead_frac"])
    assert np.isfinite(row["shard_pipelining_ab"]["speedup"])
