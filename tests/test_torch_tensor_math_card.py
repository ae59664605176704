"""The tensor and math ops in a captured step on a CUDA card: the random
ops (``truncated_gaussian_random``, ``sampling_id``, ``shuffle``) draw
anew at every replay, what ``use_jit=False`` draws at the same steps, and
``shape``, ``assign_value`` and ``is_empty``, whose values come from the
host, are held by the graph with no copy from host memory inside it.

Every test needs a card (``cuda`` marker) and skips here; none imports
JAX, so on the card they run with ``python3 -m pytest --noconftest -m
cuda tests/test_torch_tensor_math_card.py``.  Exact comparisons only.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    compile_cache.stats().reset()
    return torch.device("cuda", 0)


def random_program():
    """A program of the three random ops, seed 5: t [64] truncated
    normal, s [16] sampling_id over p [16, 50], sh the rows of rows [8, 2]
    shuffled."""
    ptt.unique_name.reset()
    main = ptt.Program()
    main.random_seed = 5
    gb = main.global_block()
    gb.create_var(name="p", shape=[16, 50], dtype="float32")
    gb.create_var(name="rows", shape=[8, 2], dtype="float32")
    for n, dt in (("t", "float32"), ("s", "int64"), ("sh", "float32")):
        gb.create_var(name=n, dtype=dt)
    gb.append_op("truncated_gaussian_random", {}, {"Out": ["t"]},
                 {"shape": [64], "dtype": "float32", "mean": 0.0,
                  "std": 1.0})
    gb.append_op("sampling_id", {"X": ["p"]}, {"Out": ["s"]}, {})
    gb.append_op("shuffle", {"X": ["rows"]}, {"Out": ["sh"]}, {})
    return main


@pytest.mark.cuda
def test_random_ops_draw_anew_in_every_captured_replay(card):
    """On a card: run_steps(4) captured draws four different sets, the
    ones use_jit=False draws at the same steps."""
    main = random_program()
    feed = {"p": np.full((16, 50), 1 / 50, np.float32),
            "rows": np.arange(16, dtype=np.float32).reshape(8, 2)}
    fetch = ["t", "s", "sh"]
    cap = ptt.Executor().run_steps(4, main, feed=feed, fetch_list=fetch)
    ref = ptt.Executor(use_jit=False).run_steps(4, main, feed=feed,
                                                fetch_list=fetch)
    for a, b in zip(cap, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for f in cap:
        assert len({np.asarray(f)[i].tobytes() for i in range(4)}) == 4


@pytest.mark.cuda
def test_host_valued_constants_are_held_by_a_captured_step(card):
    """shape, assign_value and is_empty in a captured step: the replays
    give the constants (no copy from host memory inside the capture)."""
    ptt.unique_name.reset()
    main = ptt.Program()
    gb = main.global_block()
    gb.create_var(name="x", shape=[3, 5], dtype="float32")
    for n in ("s", "v", "e"):
        gb.create_var(name=n)
    gb.append_op("shape", {"X": ["x"]}, {"Out": ["s"]}, {})
    gb.append_op("assign_value", {}, {"Out": ["v"]},
                 {"values": [1.5, 2.5, -3.0, 4.0], "dtype": "float32",
                  "shape": [2, 2]})
    gb.append_op("is_empty", {"X": ["x"]}, {"Out": ["e"]}, {})
    got = ptt.Executor().run_steps(3, main, feed={
        "x": np.ones((3, 5), np.float32)}, fetch_list=["s", "v", "e"])
    assert compile_cache.stats().snapshot()["replays"] == 2
    for i in range(3):
        assert np.asarray(got[0])[i].tolist() == [3, 5]
        assert np.asarray(got[1])[i].tolist() == [[1.5, 2.5], [-3.0, 4.0]]
        assert not bool(np.asarray(got[2])[i])
