"""The per-op profiler's windows on the card
(``paddle_tpu_torch/observability/opprof.py``): each op and the replay
total are captured as CUDA graphs and timed as replays, the report says
so, and what the walk leaves in its env is what an eager walk leaves.
These need a card and import nothing of the JAX package; the profiler's
rows are held against the JAX package in ``tests/test_torch_opprof.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.observability import opprof


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return ptt.CUDAPlace(0)


def _program(dropout):
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = ptt.layers.data("x", shape=[3, 8, 8], dtype="float32")
        y = ptt.layers.data("y", shape=[4], dtype="float32")
        c = ptt.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                              act="relu")
        p = ptt.layers.pool2d(c, pool_size=2, pool_type="avg",
                              pool_stride=2)
        if dropout:
            p = ptt.layers.dropout(p, dropout_prob=0.3)
        pred = ptt.layers.fc(p, size=4)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.Momentum(learning_rate=0.05,
                               momentum=0.9).minimize(loss)
    return main, start, loss.name


def _profile(card, dropout, measure):
    main, start, loss = _program(dropout)
    scope = ptt.Scope()
    exe = ptt.Executor(card)
    exe.run(start, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(2, 3, 8, 8).astype("f4"),
            "y": rng.rand(2, 4).astype("f4")}
    counts = compile_cache.launch_counters()
    before = [dict(c) for c in counts]
    rep = opprof.profile_program(main, executor=exe, feed=feed, scope=scope,
                                 reps=3, warmup=1, fetch_list=[loss],
                                 measure=measure)
    launched = [{k: v - b.get(k, 0) for k, v in c.items()
                 if v != b.get(k, 0)} for c, b in zip(counts, before)]
    return rep, loss, launched


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [False, True],
                         ids=["conv", "conv_dropout"])
def test_card_windows_replay_captured_graphs(card, dropout):
    """Default windows on the card: every row and the total come from
    graph replays (or, if an op cannot be captured, every one from event
    windows, with the reason), three windows each; the loss the walk
    leaves and the launches it counts equal an eager event-window
    walk's on the same inputs."""
    rep, loss, launched = _profile(card, dropout, None)
    assert rep["timing"] in ("cuda graph replay", "cuda events")
    assert (rep["timing"] == "cuda events") == ("capture_failed" in rep)
    if not dropout:
        assert rep["timing"] == "cuda graph replay", rep.get(
            "capture_failed")
    assert all(r["wall_ms"] > 0 and len(r["windows_ms"]) == 3
               for r in rep["rows"])
    assert rep["eager_total_ms"] > 0
    eager, _, eager_launched = _profile(card, dropout,
                                        opprof.cuda_time_windows)
    assert eager["timing"] == "given"
    assert [r["op_type"] for r in rep["rows"]] == \
        [r["op_type"] for r in eager["rows"]]
    np.testing.assert_array_equal(rep["fetches"][loss],
                                  eager["fetches"][loss])
    assert launched == eager_launched
