"""The tensor and math op families in the port against their JAX
lowerings: the 49 op names of ``paddle_tpu/ops/tensor_ops.py`` and
``math_ops.py`` this slice ports, the repaired ``top_k`` and the
executor's parameter order.

* **Parity.** One case or more a name (``paddle_tpu_torch.testing
  .op_cases.CASES``: ties for ``argsort`` and the comparisons, duplicate
  ids for ``scatter``, negative operands for ``elementwise_mod``, a
  symbolic size for ``crop``, an empty tensor for ``is_empty``) through
  ``torch_parity.check_op``: each package's lowering on the same
  numpy-seeded inputs, the outputs and their dtypes, and, where the op is
  differentiable, the gradients against ``jax.vjp``; again in bf16.
* **The random ops** (``truncated_gaussian_random``, ``sampling_id``,
  ``shuffle``) draw other numbers than JAX's, so each package's draw is
  held to the distribution (``op_cases.check_random``: the cut and the
  moments, a chi-square a row, a permutation), ``shuffle``'s positions
  to uniform, and the port's draws differ step to step in a program
  (``tests/test_torch_tensor_math_card.py`` holds them, and the
  host-valued constants, in a captured step on a card).
* **top_k's ties**: ``lax.top_k``'s Indices (the lower index first) in
  fp32, bf16 and int32, through ``layers.accuracy``'s ``Correct`` and
  ``evaluator.Accuracy``.
* **Executor**: the JAX package's positional order, ``auto_layout`` and
  ``compiler_options`` refused with their reason.

Tolerances: fp32 ``rtol=1e-4, atol=1e-5``; bf16 within 2^-7 of the
output's scale; integer, bool and index outputs exactly; the
statistics at a false-alarm rate of 1e-6 (``op_cases``).
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl
from paddle_tpu_torch.testing import op_cases as oc
from test_torch_tensor_math_card import random_program

CPU = ptt.CPUPlace()


@pytest.mark.parametrize("name", sorted(oc.CASES))
def test_op_matches_jax(name):
    """fp32 forward, output dtypes and input gradients."""
    op, ins, attrs, wrt = oc.CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "float32", wrt)


@pytest.mark.parametrize("name", sorted(oc.CASES))
def test_op_matches_jax_in_bf16(name):
    """Float inputs in bf16: the same output dtypes as JAX's, values
    within 2^-7 of each output's scale."""
    op, ins, attrs, _ = oc.CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "bfloat16")


def _family_names():
    names = set()
    for fam in ("tensor_ops", "math_ops"):
        src = open(f"paddle_tpu/ops/{fam}.py").read()
        for m in re.finditer(r"register_op\(([^)]*)\)", src):
            names |= set(re.findall(r'"([a-z0-9_]+)"', m.group(1)))
    return names


# the two families' names ported by earlier slices (their cases are in
# tests/test_torch_ops.py, test_torch_dense_ops.py and the slices' tests)
EARLIER = {
    "fill_constant", "fill_constant_batch_size_like", "gaussian_random",
    "uniform_random", "reshape", "squeeze", "unsqueeze", "transpose",
    "concat", "split", "gather", "top_k", "argmax", "arg_max", "max_ids",
    "one_hot", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "mul",
    "matmul", "sum", "scale", "cast", "clip", "clip_by_norm", "sign", "pow",
    "less_than", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "mean", "increment"}


def test_every_name_of_the_two_families_is_ported_and_has_a_case():
    """No op name of the JAX ``tensor_ops``/``math_ops`` modules is
    missing from the port's registry; the 49 of this slice each have a
    case here."""
    from paddle_tpu_torch.core import registry
    names = _family_names()
    assert not names - set(registry.registered_ops()), \
        sorted(names - set(registry.registered_ops()))
    new = names - EARLIER
    assert len(new) == 49, sorted(new)
    covered = {n.split("[")[0] for n in oc.CASES} | set(oc.RANDOM_CASES)
    assert new == covered, (sorted(new - covered), sorted(covered - new))


# ---------------------------------------------------------------------------
# the random ops
# ---------------------------------------------------------------------------
def _port_op(op, ins, attrs, device="cpu", ctx=None):
    ctx = ctx or ptt.core.ExecContext(ptt.Program(), torch.device(device),
                                      0)
    out = torch_impl(op)(ctx, {k: [torch.from_numpy(np.asarray(v))
                                   .to(device) for v in vs]
                               for k, vs in ins.items()}, dict(attrs))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _jax_op(op, ins, attrs, seed=0):
    ctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(seed))
    out = jax_impl(op)(ctx, {k: [jnp.asarray(v) for v in vs]
                             for k, vs in ins.items()}, dict(attrs))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(oc.RANDOM_CASES))
def test_random_op_draws_its_distribution(name, pkg):
    """Each package's draw passes the same test: the numbers differ, the
    distribution does not."""
    op, ins, attrs = oc.RANDOM_CASES[name]
    outs = _port_op(op, ins, attrs) if pkg == "port" else \
        _jax_op(op, ins, attrs)
    assert outs["Out"].dtype == {
        "truncated_gaussian_random": np.float32, "shuffle": np.float32,
        "sampling_id": np.int64 if pkg == "port" else np.int32}[name]
    oc.check_random(name, outs, ins, attrs)


def test_random_ops_keep_dtype_and_shape_in_bf16():
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0)
    t = torch_impl("truncated_gaussian_random")(
        ctx, {}, {"shape": [64, 8], "dtype": "bfloat16"})["Out"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (64, 8)
    assert t.float().abs().max().item() <= 2.0
    x = torch.tensor([[0.1, 0.7, 0.2]], dtype=torch.bfloat16)
    ids = torch_impl("sampling_id")(ctx, {"X": [x]}, {})["Out"]
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (1,)


def test_shuffle_puts_a_row_at_each_position_uniformly():
    """2000 shuffles of 16 rows on one stream: row 0's position is
    uniform (chi-square, 15 degrees of freedom)."""
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0)
    x = torch.arange(16, dtype=torch.float32).reshape(16, 1)
    perms = [torch_impl("shuffle")(ctx, {"X": [x]}, {})["Out"][:, 0]
             .long().numpy() for _ in range(2000)]
    stat, limit = oc.shuffle_positions(perms)
    assert stat < limit, (stat, limit)
    assert len({p.tobytes() for p in perms}) > 1990


def test_random_ops_are_the_executors_random_ops_and_draw_anew():
    """The three ops are among the executor's random ops (a capture
    registers their generators with the graph), and a program of them
    draws other numbers at every step."""
    assert {"truncated_gaussian_random", "sampling_id",
            "shuffle"} <= set(texecutor.RANDOM_OPS)
    main = random_program()
    assert len(texecutor._random_streams(main, False)) == 3
    feed = {"p": np.full((16, 50), 1 / 50, np.float32),
            "rows": np.arange(16, dtype=np.float32).reshape(8, 2)}
    runs = ptt.Executor(CPU).run_steps(3, main, feed=feed,
                                       fetch_list=["t", "s", "sh"])
    for i in range(3):
        draws = [np.asarray(f)[i] for f in runs]
        others = [[np.asarray(f)[j] for f in runs] for j in range(3)
                  if j != i]
        assert all(not np.array_equal(draws[0], o[0]) for o in others)
        assert np.abs(draws[0]).max() < 2.0
        assert sorted(draws[2][:, 0].tolist()) == list(range(0, 16, 2))
    assert len({np.asarray(runs[1])[i].tobytes() for i in range(3)}) > 1


def test_constants_and_shapes_stay_on_the_tensors_device():
    """The creation ops make their results on the operand's (or the
    context's) device with no host read: a meta tensor flows through."""
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("meta"), 0)
    x = torch.empty((0, 5), device="meta")
    for op, ins, attrs, shape, dtype in (
            ("shape", {"X": [x]}, {}, (2,), torch.int64),
            ("is_empty", {"X": [x]}, {}, (), torch.bool),
            ("isfinite", {"X": [x]}, {}, (), torch.bool),
            ("range", {}, {"start": 0, "end": 10, "step": 2}, (5,),
             torch.int64),
            ("fill_any_like", {"X": [x]}, {"value": 3.0}, (0, 5),
             torch.float32)):
        out = torch_impl(op)(ctx, ins, attrs)["Out"]
        assert out.device.type == "meta" and tuple(out.shape) == shape \
            and out.dtype == dtype, op


# ---------------------------------------------------------------------------
# top_k's ties
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(oc.TIED_TOP_K)))
def test_top_k_indices_equal_lax_top_k_on_ties(case, dtype):
    """The port's Indices are lax.top_k's on tied rows (an all-zero row
    at k = 1 among them), and the values are gathered in the input's
    dtype."""
    x, k, want = oc.TIED_TOP_K[case]
    j = jax.lax.top_k(jnp.asarray(x, tp.JDT[dtype]), k)
    np.testing.assert_array_equal(np.asarray(j[1]), want)
    t = torch_impl("top_k")(None, {"X": [torch.from_numpy(x).to(
        tp.TDT[dtype])]}, {"k": k})
    np.testing.assert_array_equal(t["Indices"].numpy(), want)
    assert t["Out"].dtype == tp.TDT[dtype]
    np.testing.assert_array_equal(t["Out"].float().numpy(),
                                  np.asarray(j[0], np.float32))


def _accuracy_program(pkg):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [6])
        y = pkg.layers.data("y", [1], dtype="int64")
        acc = pkg.layers.accuracy(x, y, k=1)
        ev = pkg.evaluator.Accuracy(x, y, k=1)
    correct = next(op.output("Correct")[0] for op in main.global_block().ops
                   if op.type == "accuracy")
    return main, startup, acc, correct, ev


def test_accuracy_counts_tied_scores_as_jax_does():
    """Scores tied between the label and another class: the first-ranked
    index is the lower one in both packages, so Correct,
    the accuracy and evaluator.Accuracy agree exactly."""
    x = np.array([[1, 1, 0, 0, 0, 0], [0, 2, 2, 0, 0, 0],
                  [0, 0, 0, 0, 0, 0], [3, 0, 0, 0, 0, 3]], np.float32)
    y = np.array([[0], [2], [0], [5]], np.int64)
    feed = {"x": x, "y": y}
    jm, js, jacc, jcorrect, jev = _accuracy_program(pt)
    tm, ts, tacc, tcorrect, tev = _accuracy_program(ptt)
    jscope, tscope = pt.core.Scope(), ptt.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    ptt.Executor(CPU).run(ts, scope=tscope)
    want = pt.Executor(pt.CPUPlace()).run(
        jm, feed=feed, fetch_list=[jacc.name, jcorrect], scope=jscope)
    got = ptt.Executor(CPU).run(tm, feed=feed,
                                fetch_list=[tacc.name, tcorrect],
                                scope=tscope)
    assert np.asarray(want[1]).tolist() == [2]    # rows 0 and 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tev.eval(None, scope=tscope),
                                  jev.eval(None, scope=jscope))


# ---------------------------------------------------------------------------
# Executor's signature
# ---------------------------------------------------------------------------
def test_executor_takes_the_jax_packages_positional_order():
    """The same parameter names in the same order, so Executor(place,
    True) is a captured (jitted) run in both packages, not an AMP one."""
    jp = list(inspect.signature(pt.Executor).parameters)
    tp_ = list(inspect.signature(ptt.Executor).parameters)
    assert tp_ == jp
    assert tp_[:6] == ["place", "use_jit", "check_nan_inf", "amp",
                       "auto_layout", "compiler_options"]
    for exe in (pt.Executor(pt.CPUPlace(), True), ptt.Executor(CPU, True)):
        assert exe.use_jit is True and exe.amp is False
    exe = ptt.Executor(CPU, False, True, True)
    assert (exe.use_jit, exe.check_nan_inf, exe.amp) == (False, True, True)


@pytest.mark.parametrize("kw", [{"auto_layout": True},
                                {"compiler_options": {
                                    "xla_tpu_scoped_vmem_limit_kib": 1}}])
def test_xla_options_are_refused_with_their_reason(kw):
    with pytest.raises(ValueError, match="XLA"):
        ptt.Executor(CPU, **kw)
    exe = ptt.Executor(CPU, auto_layout=False, compiler_options={})
    assert exe.use_jit


def test_fc_accepts_use_mkldnn():
    """layers.fc(use_mkldnn=False) builds the JAX package's program."""
    tp.reset_both()
    progs = []
    for pkg in (pt, ptt):
        pkg.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            pkg.layers.fc(pkg.layers.data("x", [4]), 3, use_mkldnn=False)
        progs.append((main.to_dict(), startup.to_dict()))
    assert progs[0] == progs[1]
