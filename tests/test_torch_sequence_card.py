"""The sequence and embedding ops in a captured step on a CUDA card:
``nce`` draws anew at every replay, what ``use_jit=False`` draws at the
same steps; ``lod_reset``'s ``target_lod`` and ``max_sequence_len``
without lengths, whose values come from the host, are held by the graph
with no copy from host memory inside it.

Every test needs a card (``cuda`` marker) and skips here; none imports
JAX, so on the card they run with ``python3 -m pytest --noconftest -m
cuda tests/test_torch_sequence_card.py``.  Exact comparisons only.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.testing import op_cases as oc


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    compile_cache.stats().reset()
    return torch.device("cuda", 0)


def nce_program():
    """(program, feed) of one ``nce`` op over ``op_cases.nce_case``'s
    operands, seed 7: fetch ``labels`` (SampleLabels) and ``cost``."""
    op, ins, attrs, _ = oc.nce_case()
    ptt.unique_name.reset()
    main = ptt.Program()
    main.random_seed = 7
    gb = main.global_block()
    feed = {}
    for slot, vs in ins.items():
        name = slot.lower()
        gb.create_var(name=name, shape=list(vs[0].shape),
                      dtype=str(vs[0].dtype))
        feed[name] = vs[0]
    for n, dt in (("cost", "float32"), ("logits", "float32"),
                  ("labels", "int64")):
        gb.create_var(name=n, dtype=dt)
    gb.append_op(op, {slot: [slot.lower()] for slot in ins},
                 {"Cost": ["cost"], "SampleLogits": ["logits"],
                  "SampleLabels": ["labels"]}, attrs)
    return main, feed


def lengths_program(T=6):
    """(program, feed): ``lod_reset`` of x [4, T, 2] to the offsets
    [0, 5, 6, 6, 9] (lengths 5, 1, 0, 3), ``sequence_pad``'s Length of
    it (``lens``), ``max_sequence_len`` of it (``top``) and of x, which
    has no lengths (``full``, T)."""
    ptt.unique_name.reset()
    main = ptt.Program()
    gb = main.global_block()
    gb.create_var(name="x", shape=[4, T, 2], dtype="float32")
    for n in ("r", "padded", "lens", "top", "full"):
        gb.create_var(name=n)
    gb.append_op("lod_reset", {"X": ["x"]}, {"Out": ["r"]},
                 {"target_lod": [0, 5, 6, 6, 9]})
    gb.append_op("sequence_pad", {"X": ["r"]},
                 {"Out": ["padded"], "Length": ["lens"]}, {})
    gb.append_op("max_sequence_len", {"X": ["r"]}, {"Out": ["top"]}, {})
    gb.append_op("max_sequence_len", {"X": ["x"]}, {"Out": ["full"]}, {})
    return main, {"x": np.ones((4, T, 2), np.float32)}


@pytest.mark.cuda
def test_nce_draws_anew_in_every_captured_replay(card):
    """run_steps(4) captured draws four different sets of negatives, the
    ones use_jit=False draws at the same steps; each draw's cost is its
    float64 recomputation's."""
    main, feed = nce_program()
    fetch = ["labels", "logits", "cost"]
    cap = ptt.Executor().run_steps(4, main, feed=feed, fetch_list=fetch)
    assert compile_cache.stats().snapshot()["replays"] == 3
    ref = ptt.Executor(use_jit=False).run_steps(4, main, feed=feed,
                                                fetch_list=fetch)
    for a, b in zip(cap, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    labels = np.asarray(cap[0])
    assert len({labels[i].tobytes() for i in range(4)}) == 4
    _, ins, attrs, _ = oc.nce_case()
    for i in range(4):
        oc.check_nce({"SampleLabels": labels[i],
                      "SampleLogits": np.asarray(cap[1])[i],
                      "Cost": np.asarray(cap[2])[i]}, ins, attrs)


@pytest.mark.cuda
def test_host_valued_lengths_are_held_by_a_captured_step(card):
    main, feed = lengths_program()
    got = ptt.Executor().run_steps(3, main, feed=feed,
                                   fetch_list=["lens", "top", "full"])
    assert compile_cache.stats().snapshot()["replays"] == 2
    for i in range(3):
        assert np.asarray(got[0])[i].tolist() == [5, 1, 0, 3]
        assert int(np.asarray(got[1])[i]) == 5
        assert int(np.asarray(got[2])[i]) == 6
