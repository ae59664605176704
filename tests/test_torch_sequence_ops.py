"""The sequence family in the port against its JAX lowerings: the 17 op
names of ``paddle_tpu/ops/sequence_ops.py`` the port lacked
(``sequence_softmax``, ``sequence_expand``/``_as``, ``sequence_concat``,
``sequence_context``, ``sub_nested_seq``, ``conv2d_dynamic_filter``,
``sequence_slice``, ``sequence_reverse``, ``sequence_reshape``,
``sequence_pad``, ``sequence_unpad``, ``lod_reset``, ``row_conv``,
``max_sequence_len``, ``lstm_unit``, ``kmax_seq_score``).

* **Parity.** One case or more a name
  (``paddle_tpu_torch.testing.op_cases.SEQ_CASES``: lengths 0, 1 and T,
  ties for ``kmax_seq_score``, k above T, ``sequence_context`` with and
  without PadW, a nested input with invalid selections, per-sample and
  shared dynamic filters) through ``torch_parity.check_op``: each
  package's lowering on the same numpy-seeded inputs and ``@LEN``
  companions, the outputs, their dtypes and the lengths each op sets on
  its outputs, and, where the op is differentiable, the gradients
  against ``jax.vjp``; again in bf16.
* **The bf16 row of length 0**: ``sequence_softmax`` gives zeros in the
  port where the JAX package gives NaN (its -3.4e38 fill is -inf in
  bf16, ROADMAP Queue C); each package's bf16 run is held to its own
  fp32 run there.
* **Host constants**: ``lod_reset``'s ``target_lod`` and
  ``max_sequence_len`` without lengths make their values on the
  context's device (``tests/test_torch_sequence_card.py`` holds them in
  a captured step on a card).

Tolerances: fp32 ``rtol=1e-4, atol=1e-5``; bf16 within 2^-7 of the
output's scale; integer, bool, index and length outputs exactly.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl
from paddle_tpu_torch.testing import op_cases as oc


def _names(module):
    src = open(f"paddle_tpu/ops/{module}.py").read()
    names = set()
    for m in re.finditer(r"register_op\(([^)]*)\)", src):
        names |= set(re.findall(r'"([a-z0-9_]+)"', m.group(1)))
    return names


SEQ = _names("sequence_ops")
CASES = sorted(n for n in oc.SEQ_CASES if n.split("[")[0] in SEQ)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name):
    """fp32 forward, output dtypes, output lengths and input
    gradients."""
    op, ins, attrs, wrt, lens = oc.SEQ_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "float32", wrt, lens=lens)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax_in_bf16(name):
    """Float inputs in bf16: the same output dtypes as JAX's, values
    within 2^-7 of each output's scale (a case of ``BF16_OWN_FP32``: each
    package's bf16 run against its own fp32 run)."""
    op, ins, attrs, _, lens = oc.SEQ_CASES[name](oc.rng(name))
    if name not in oc.BF16_OWN_FP32:
        tp.check_op(op, ins, attrs, "bfloat16", lens=lens)
        return
    j16, t16, _, _ = tp.run_op(op, ins, attrs, "bfloat16", lens=lens)
    j32, t32, _, _ = tp.run_op(op, ins, attrs, "float32", lens=lens)
    for s in t32:
        assert t16[s].dtype == (torch.bfloat16 if t32[s].is_floating_point()
                                else t32[s].dtype)
        tp.close_to(t16[s], t32[s].numpy(), "bfloat16", f"port {s}")
    # the JAX bf16 run: its fp32 answer but on the rows of length 0
    empty = lens[("X", 0)] == 0
    out16 = np.asarray(j16[("Out", 0)], np.float32)
    out32 = np.asarray(j32[("Out", 0)], np.float32)
    assert np.isnan(out16[empty]).all() and not np.isnan(out16[~empty]).any()
    tp.close_to(out16[~empty], out32[~empty], "bfloat16", "jax Out")
    assert (t16[("Out", 0)].float().numpy()[empty] == 0).all()


def test_every_name_of_the_family_is_ported_and_has_a_case():
    """No op name of the JAX ``sequence_ops`` module is missing from the
    port's registry; the 17 of this slice each have a case here."""
    from paddle_tpu_torch.core import registry
    assert not SEQ - set(registry.registered_ops()), \
        sorted(SEQ - set(registry.registered_ops()))
    new = SEQ - {"sequence_pool", "sequence_conv", "lstm", "gru",
                 "gru_unit"}
    assert len(new) == 17, sorted(new)
    assert new == {n.split("[")[0] for n in CASES}


def test_sequence_softmax_of_an_empty_row_is_zeros_in_every_dtype():
    """Lengths [2, 0] in bf16: the port's second row is zeros, where the
    JAX package's is NaN (ROADMAP Queue C)."""
    x = np.array([[0.5, 1.5, -1.0], [1.0, 2.0, 3.0]], np.float32)
    lens = {("X", 0): np.array([2, 0], np.int32)}
    for dtype in ("float32", "bfloat16"):
        j, t, _, _ = tp.run_op("sequence_softmax", {"X": [x]}, {}, dtype,
                               lens=lens)
        out = t[("Out", 0)].float().numpy()
        assert (out[1] == 0).all() and abs(out[0].sum() - 1) < 1e-2
        assert np.isnan(np.asarray(j[("Out", 0)], np.float32)[1]).all() \
            == (dtype == "bfloat16")


def test_kmax_seq_score_ranks_ties_as_lax_top_k():
    """[1, 2, 2, 1] with k 3 gives [1, 2, 0] (the lower index first among
    equal scores) in fp32 and bf16, -1 past a short sequence."""
    x = np.array([[1, 2, 2, 1], [5, 5, 5, 5]], np.float32)
    lens = {("X", 0): np.array([4, 2], np.int32)}
    for dtype in ("float32", "bfloat16"):
        j, t, _, _ = tp.run_op("kmax_seq_score", {"X": [x]},
                               {"beam_size": 3}, dtype, lens=lens)
        want = [[1, 2, 0], [0, 1, -1]]
        assert np.asarray(j[("Out", 0)]).tolist() == want
        assert t[("Out", 0)].tolist() == want
        assert t[("Out", 0)].dtype == torch.int64


def test_host_constants_stay_on_the_contexts_device():
    """lod_reset's target_lod and max_sequence_len without lengths make
    their values with no host read of a device tensor: a meta tensor
    flows through."""
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("meta"), 0)
    x = torch.empty((4, 6, 2), device="meta")
    ctx.op = tp.OneOp("max_sequence_len", {"X": [x]}, {})
    ctx.env = tp.seq_env(ptt, {}, None)
    out = torch_impl("max_sequence_len")(ctx, {"X": [x]}, {})["Out"]
    assert out.device.type == "meta" and out.dtype == torch.int64 \
        and tuple(out.shape) == ()
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0)
    ctx.op = tp.OneOp("lod_reset", {"X": [x]}, {})
    ctx.env = tp.seq_env(ptt, {}, None)
    torch_impl("lod_reset")(ctx, {"X": [torch.zeros(4, 6)]},
                            {"target_lod": [0, 6, 7, 7, 11]})
    lens = ctx.env.local["Out.out@LEN"]
    assert lens.dtype == torch.int32 and lens.tolist() == [6, 1, 0, 4]


def test_sequence_reshape_scales_lengths_down():
    """(lens * D) // new_dim, as the JAX package: lengths 5 and 1 at D 4
    to new_dim 8 give 2 and 0."""
    j, t, _, _ = tp.run_op("sequence_reshape",
                           {"X": [np.ones((2, 6, 4), np.float32)]},
                           {"new_dim": 8},
                           lens={("X", 0): np.array([5, 1], np.int32)})
    key = ("Out.out@LEN", 0)
    assert t[key].tolist() == np.asarray(j[key]).tolist() == [2, 0]
    assert tuple(t[("Out", 0)].shape) == (2, 3, 8)


def test_sequence_expand_passes_a_same_rank_input_through():
    """An X of Y's rank is not broadcast, only masked by Y's lengths (the
    JAX package's reading, ROADMAP Queue C)."""
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    lens = {("Y", 0): np.array([4, 2], np.int32)}
    j, t, _, _ = tp.run_op("sequence_expand", {"X": [x], "Y": [x]}, {},
                           lens=lens)
    want = x * (np.arange(4)[None, :, None] < np.array([4, 2])[:, None,
                                                                 None])
    np.testing.assert_array_equal(t[("Out", 0)].numpy(), want)
    np.testing.assert_array_equal(np.asarray(j[("Out", 0)]), want)
    assert jnp.asarray(j[("Out.out@LEN", 0)]).tolist() == [4, 2]
