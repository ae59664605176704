"""The CRF and embedding families in the port against their JAX
lowerings: ``linear_chain_crf``, ``crf_decoding``, ``warpctc``,
``edit_distance``, ``chunk_eval`` (``paddle_tpu/ops/crf_ops.py``),
``nce`` and ``hierarchical_sigmoid``/``hsigmoid``
(``embedding_ops.py``).

* **Parity.** One case or more a name
  (``paddle_tpu_torch.testing.op_cases.SEQ_CASES``: lengths 0, 1 and T,
  tied Viterbi scores, T = 1, a CTC label that cannot fit, label and no
  label lengths, hsigmoid at 6 and 11 classes and at 8) through
  ``torch_parity.check_op``, fp32 with the gradients of the
  differentiable ones against ``jax.vjp`` (the CRF's into Emission and
  Transition, the CTC's into the logits, the unfit row's included), then
  bf16.
* **The recursions' edges**: the unfit CTC row near 1e30 in both
  packages; Viterbi on all-tied rows; the edit distance against a
  numpy Levenshtein.
* **nce** draws other numbers than JAX's: each package's draw is held to
  its bounds and to its cost recomputed in float64 from the drawn
  ``SampleLabels``, the negatives to uniform (chi-square), and the port
  draws anew at every step of a program (``tests/test_torch_sequence_card
  .py`` holds the replays of a captured step on a card).

Tolerances: fp32 ``rtol=1e-4, atol=1e-5``; bf16 within 2^-7 of the
output's scale; integer and index outputs exactly; nce's cost 1e-5 of
scale of float64; the chi-square at a false-alarm rate of 1e-6.
"""
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

CPU = ptt.CPUPlace()


def _names(module):
    src = open(f"paddle_tpu/ops/{module}.py").read()
    names = set()
    for m in re.finditer(r"register_op\(([^)]*)\)", src):
        names |= set(re.findall(r'"([a-z0-9_]+)"', m.group(1)))
    return names


FAMILY = _names("crf_ops") | _names("embedding_ops")
CASES = sorted(n for n in oc.SEQ_CASES if n.split("[")[0] in FAMILY)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name):
    op, ins, attrs, wrt, lens = oc.SEQ_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "float32", wrt, lens=lens)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax_in_bf16(name):
    op, ins, attrs, _, lens = oc.SEQ_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "bfloat16", lens=lens)


def test_every_name_of_the_two_families_is_ported_and_has_a_case():
    """No op name of the JAX ``crf_ops``/``embedding_ops`` modules is
    missing from the port; the 8 of this slice each have a case."""
    from paddle_tpu_torch.core import registry
    assert not FAMILY - set(registry.registered_ops())
    new = FAMILY - {"copy_len", "lookup_table", "lookup_table_sparse"}
    assert len(new) == 8, sorted(new)
    assert new == {n.split("[")[0] for n in CASES} | {"nce"}


def test_a_ctc_label_that_cannot_fit_reads_about_1e30():
    op, ins, attrs, wrt, lens = oc.SEQ_CASES["warpctc"](oc.rng("warpctc"))
    j, t, _, _ = tp.run_op(op, ins, attrs, lens=lens)
    for loss in (np.asarray(j[("Loss", 0)]), t[("Loss", 0)].numpy()):
        assert 0.99e30 <= loss[2, 0] <= 1.01e30
        assert np.isfinite(loss).all() and (loss[[0, 1, 3]] < 100).all()


def _levenshtein(a, b):
    d = np.arange(len(b) + 1)
    for i, x in enumerate(a):
        prev, d[0] = d[0], i + 1
        for jj, y in enumerate(b):
            prev, d[jj + 1] = d[jj + 1], min(d[jj + 1] + 1, d[jj] + 1,
                                              prev + (x != y))
    return d[len(b)]


def test_edit_distance_is_levenshtein():
    r = np.random.RandomState(3)
    hyp = r.randint(0, 3, (16, 9)).astype(np.int64)
    ref = r.randint(0, 3, (16, 7)).astype(np.int64)
    hl = r.randint(0, 10, 16).astype(np.int32)
    rl = r.randint(0, 8, 16).astype(np.int32)
    _, t, _, _ = tp.run_op("edit_distance", {"Hyps": [hyp], "Refs": [ref]},
                           {"normalized": False},
                           lens={("Hyps", 0): hl, ("Refs", 0): rl})
    want = [_levenshtein(hyp[b, :hl[b]], ref[b, :rl[b]]) for b in range(16)]
    assert t[("Out", 0)][:, 0].tolist() == want


# ---------------------------------------------------------------------------
# nce
# ---------------------------------------------------------------------------
def _nce_port(ins, attrs, ctx=None):
    one = tp.OneOp("nce", ins, attrs)
    if ctx is None:
        ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0)
    ctx.op = one
    out = torch_impl("nce")(ctx, {
        k: [torch.from_numpy(np.asarray(v)) for v in vs]
        for k, vs in ins.items()}, dict(attrs))
    return {k: v.numpy() for k, v in out.items()}


def _nce_jax(ins, attrs, seed=0):
    ctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(seed))
    ctx.op = tp.OneOp("nce", ins, attrs)
    out = jax_impl("nce")(ctx, {k: [jnp.asarray(v) for v in vs]
                                for k, vs in ins.items()}, dict(attrs))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_nce_draw_holds_its_bounds_cost_and_uniformity(pkg):
    """2000 rows x 10 negatives over 50 classes: the label first, the
    cost its float64 recomputation's from the drawn samples, the
    negatives uniform (chi-square, 49 degrees of freedom)."""
    _, ins, attrs, _ = oc.nce_case(rows=2000)
    outs = _nce_port(ins, attrs) if pkg == "port" else _nce_jax(ins, attrs)
    outs["SampleLabels"] = outs["SampleLabels"].astype(np.int64)
    oc.check_nce(outs, ins, attrs)
    stat, limit = oc.nce_uniformity(outs["SampleLabels"])
    assert stat < limit, (stat, limit)


def test_nce_gradients_follow_the_drawn_samples():
    """The port's gradients equal JAX's vjp of the cost with the port's
    draw in place of JAX's (the cost is a function of the samples)."""
    op, ins, attrs, wrt = oc.nce_case()
    leaves = {k: torch.from_numpy(ins[k][0]).requires_grad_(True)
              for k, _ in wrt}
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0)
    ctx.op = tp.OneOp("nce", ins, attrs)
    with torch.enable_grad():
        out = torch_impl("nce")(ctx, {
            "Input": [leaves["Input"]], "Weight": [leaves["Weight"]],
            "Bias": [leaves["Bias"]],
            "Label": [torch.from_numpy(ins["Label"][0])]}, dict(attrs))
        got = torch.autograd.grad(out["Cost"].sum(),
                                     [leaves[k] for k, _ in wrt])
    samples = jnp.asarray(out["SampleLabels"].numpy())
    k, V = attrs["num_neg_samples"], attrs["num_total_classes"]

    def cost(x, w, b):
        z = jnp.einsum("bd,bkd->bk", x, w[samples]) + b[samples] \
            - jnp.log(k / V)
        y = jnp.zeros_like(z).at[:, 0].set(1.0)
        return jnp.sum(jnp.maximum(z, 0) - z * y
                       + jnp.log1p(jnp.exp(-jnp.abs(z))))

    want = jax.grad(cost, argnums=(0, 1, 2))(
        *(jnp.asarray(ins[k_][0]) for k_, _ in wrt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_nce_is_a_random_op_that_draws_anew_each_step():
    """nce is among the executor's random ops (a capture registers its
    generator), and a program of it draws other negatives at each
    step."""
    from test_torch_sequence_card import nce_program
    assert "nce" in texecutor.RANDOM_OPS
    main, feed = nce_program()
    assert len(texecutor._random_streams(main, False)) == 1
    runs = ptt.Executor(CPU).run_steps(3, main, feed=feed,
                                       fetch_list=["labels", "cost"])
    labels = np.asarray(runs[0])
    assert len({labels[i].tobytes() for i in range(3)}) == 3
    _, ins, attrs, _ = oc.nce_case()
    for i in range(3):
        oc.check_nce({"SampleLabels": labels[i], "Cost": np.asarray(
            runs[1])[i], "SampleLogits": oc.nce_cost(
                ins, attrs, labels[i])[0]}, ins, attrs)
