"""The control-flow, io, detection and moe ops on a CUDA card: every
single-op case of ``op_cases.CF_CASES``, ``DET_CASES`` and ``MOE_CASES``
on CUDA tensors against the port's CPU op on the same operands (fp32,
TF32 off, gradients included through the float outputs); a While program
(with a print in its body) run uncaptured on the card and counted under
``while``; the DynamicRNN classifier captured and bit-equal to
``use_jit=False``.

Every test needs a card (``cuda`` marker) and skips here; none imports
JAX, so on the card they run with ``python3 -m pytest --noconftest -m
cuda tests/test_torch_control_flow_card.py``.  Tolerances: float
outputs and gradients within 1e-4 of each output's scale (the orders of
sums differ between the card's and the host's kernels), integer and
index outputs exactly; the programs exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.testing import cf_programs as cf
from paddle_tpu_torch.testing import op_cases as oc

CASES = {**oc.CF_CASES, **oc.DET_CASES, **oc.MOE_CASES}
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    compile_cache.stats().reset()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _with_grads(op, ins, attrs, wrt, lens, device):
    """The op's outputs on ``device`` and, where ``wrt`` names float
    inputs, the gradients of sum(out * 1) over its float outputs."""
    import paddle_tpu_torch.testing.op_cases as m
    leaves = {}
    tins = {}
    for k, vs in ins.items():
        tins[k] = []
        for i, v in enumerate(vs):
            t = torch.from_numpy(np.asarray(v)).to(device)
            if (k, i) in wrt:
                t.requires_grad_(True)
                leaves[(k, i)] = t
            tins[k].append(t)
    with torch.enable_grad():
        out = m.run_port(op, tins, attrs, lens, device)
        floats = [t for ts in out.values() for t in ts
                  if t.is_floating_point() and t.requires_grad]
        grads = torch.autograd.grad(sum(t.sum() for t in floats),
                                    list(leaves.values()),
                                    allow_unused=True) if floats and \
            leaves else []
    res = {k: [t.detach() for t in ts] for k, ts in out.items()}
    for (k, i), g in zip(leaves, grads):
        if g is not None:
            res[f"d{k}.{i}"] = [g]
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_on_the_card_equals_the_cpu_op(card, name):
    op, ins, attrs, wrt, lens = CASES[name](oc.rng(name))
    got = _with_grads(op, ins, attrs, wrt, lens, card)
    want = _with_grads(op, ins, attrs, wrt, lens, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.device.type == "cuda" and g.dtype == w.dtype, k
            g = g.cpu()
            if w.is_floating_point():
                scale = max(float(w.abs().max()) if w.numel() else 0, 1e-6)
                assert float((g - w).abs().max()) <= TOL * scale, k
            else:
                assert torch.equal(g, w), k


@pytest.mark.cuda
def test_while_runs_uncaptured_on_the_card(card, capfd):
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        L = ptt.layers
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 5)
        total = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, limit)
        w = L.While(cond)
        with w.block():
            L.sums([total, L.ones([1], "float32")], out=total)
            ptt.layer_helper.LayerHelper("print").append_op(
                type="print", inputs={"In": [total]}, outputs={},
                attrs={"message": "total"})
            L.increment(i, 1.0)
            L.less_than(i, limit, cond=cond)
    exe = ptt.Executor()
    capfd.readouterr()
    out = exe.run_steps(2, main, fetch_list=[total, i], scope=ptt.Scope())
    lines = capfd.readouterr().out.splitlines()
    snap = compile_cache.stats().snapshot()
    assert snap["uncaptured"] == {"while": 2} and not snap["captures"]
    assert np.asarray(out[0]).reshape(-1).tolist() == [5.0, 5.0]
    assert lines == [f"total [{k}.]" for k in range(1, 6)] * 2


@pytest.mark.cuda
def test_dynamic_rnn_is_captured_and_equals_use_jit_false(card):
    V, E, H, C, B, T = 50, 8, 6, 3, 6, 7
    main, startup, v = cf.build_drnn_classifier(ptt, V, E, H, C, lr=0.1)
    r = np.random.RandomState(1)
    feed = {"words": r.randint(0, V, (B, T)).astype(np.int64),
            "words@LEN": np.array([7, 2, 5, 5, 1, 3], np.int32),
            "label": r.randint(0, C, (B, 1)).astype(np.int64)}
    scopes = []
    outs = []
    for use_jit in (True, False):
        scope = ptt.Scope()
        ptt.Executor().run(startup, scope=scope)
        exe = ptt.Executor(use_jit=use_jit)
        outs.append(exe.run_steps(3, main, feed=feed,
                                  fetch_list=[v["loss"], v["logits"]],
                                  scope=scope))
        scopes.append(scope)
        if use_jit:
            snap = compile_cache.stats().snapshot()
            assert snap["captures"] == 1 and snap["replays"] == 2
            assert not snap["uncaptured"]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for k in scopes[1].keys():
        np.testing.assert_array_equal(scopes[0].numpy(k), scopes[1].numpy(k))


@pytest.mark.cuda
def test_static_ops_capture_and_equal_use_jit_false(card):
    """roi_pool, iou_similarity, the arrays, the rank table and the
    IfElse merge in one step: captured (no step uncaptured), its fetches
    bit-equal to use_jit=False at every step."""
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        L = ptt.layers
        x = L.data("x", shape=[3, 8, 9], dtype="float32")
        rois = L.data("rois", shape=[5], dtype="float32")
        a = L.data("a", shape=[4], dtype="float32")
        seq = L.data("seq", shape=[6, 2], dtype="float32", lod_level=1)
        pooled = L.roi_pool(x, rois, pooled_height=2, pooled_width=3)
        iou = L.iou_similarity(a, a)
        i = L.fill_constant([1], "int64", 2)
        arr = L.array_write(L.reduce_sum(pooled, dim=1), i)
        length = L.array_length(arr)
        back = L.array_read(arr, i)
        rank = L.lod_rank_table(seq)
        ordered = L.reorder_lod_tensor_by_rank(seq, rank)
        cond = L.less_than(L.reduce_sum(a, dim=1, keep_dim=True),
                           L.fill_constant([1], "float32", 2.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(ie.input(iou), scale=2.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(iou), scale=-1.0))
        merged = ie()
    op, ins, attrs, _, _ = oc.DET_CASES["roi_pool"](oc.rng("roi_pool"))
    r = np.random.RandomState(2)
    feed = {"x": ins["X"][0], "rois": ins["ROIs"][0],
            "a": oc._boxes(r, 4), "seq": r.randn(4, 6, 2).astype(np.float32),
            "seq@LEN": np.array([3, 6, 1, 6], np.int32)}
    fetch = [pooled, iou, length, back, rank, ordered, merged]
    outs = []
    for use_jit in (True, False):
        compile_cache.stats().reset()
        outs.append(ptt.Executor(use_jit=use_jit).run_steps(
            3, main, feed=feed, fetch_list=fetch, scope=ptt.Scope()))
        snap = compile_cache.stats().snapshot()
        if use_jit:
            assert snap["captures"] == 1 and snap["replays"] == 2
            assert not snap["uncaptured"]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert int(np.asarray(outs[0][2]).reshape(-1)[0]) == 128
