"""The mixture-of-experts op in the port against the JAX package: ``moe``
(``paddle_tpu/ops/moe_ops.py``), its routing (``parallel/moe.py``'s
``moe_dispatch`` and ``load_balancing_loss``, one-card copies in
``paddle_tpu_torch/parallel/moe.py``) and ``layers.moe``.

* **The op** (``op_cases.MOE_CASES``: top-1, top-2 and top-3, capacity
  factors that drop tokens, each activation): fp32 with the gradients of
  X and the three weights against ``jax.vjp``, then bf16.
* **The bf16 slot positions.** A slot position is a ``cumsum`` in the
  gates' dtype in both packages, so in bf16 an expert past 256 tokens
  puts two tokens in one slot (ROADMAP Queue C).  At 1024 tokens over 4
  experts the port's routing equals the JAX package's bit for bit (eager
  and jitted), in bf16 with shared slots and in fp32 without; the op
  there in bf16 equals the JAX op run eagerly, bit for bit.
* **``layers.moe`` in a program** (as ``tests/test_pipeline_program.py``
  trains it, on one device): 3 SGD steps with the aux loss in the total,
  the losses and every parameter against the JAX package's.

Tolerances: fp32 ``rtol=1e-4, atol=1e-5`` (the program: ``rtol=2e-5,
atol=1e-6``), bf16 within 2^-7 of the output's scale, the routing tensors
and the eager bf16 op exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.testing import op_cases as oc

CASES = sorted(oc.MOE_CASES)
PROG_TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name):
    op, ins, attrs, wrt, lens = oc.MOE_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "float32", wrt, lens=lens)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax_in_bf16(name):
    op, ins, attrs, _, lens = oc.MOE_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "bfloat16", lens=lens)


def _gates(T, E, seed=0):
    """Softmax gate probabilities [T, E] whose first expert is the most
    probable for most tokens (so it takes far more than 256)."""
    r = np.random.RandomState(seed)
    logits = r.randn(T, E).astype(np.float32)
    logits[:, 0] += 1.5
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routing_equals_the_references_past_256_tokens(dtype):
    """1024 tokens, 4 experts, top-2, capacity 640: the dispatch and
    combine tensors of both packages are equal (the JAX ones eager and
    jitted), the aux losses within the dtype's tolerance; in bf16
    some slots hold two tokens (positions above 256 round), in fp32
    none."""
    T, E, k = 1024, 4, 2
    cap = int(1.25 * k * T / E)
    g = _gates(T, E)
    jg = jnp.asarray(g, tp.JDT[dtype])
    tg = torch.from_numpy(g).to(tp.TDT[dtype])
    jd, jc = jmoe.moe_dispatch(jg, cap, k)
    jit_d = jax.jit(lambda v: jmoe.moe_dispatch(v, cap, k)[0])(jg)
    np.testing.assert_array_equal(np.asarray(jit_d, np.float32),
                                  np.asarray(jd, np.float32))
    td, tc = tmoe.moe_dispatch(tg, cap, k)
    assert td.dtype == tg.dtype and td.shape == (T, E, cap)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd, np.float32))
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc, np.float32))
    ja = np.asarray(jmoe.load_balancing_loss(jg, jd), np.float32)
    tp.close_to(tmoe.load_balancing_loss(tg, td), ja, dtype, "aux loss")
    per_slot = td.float().sum(0)
    assert int(per_slot[0].sum()) > 256
    shared = int((per_slot > 1).sum())
    if dtype == "bfloat16":
        assert shared > 0
    else:
        assert shared == 0 and int(per_slot.max()) == 1


def test_op_in_bf16_past_256_tokens():
    """The whole op at 1024 tokens in bf16 (the quirk live) equals the
    JAX op run eagerly, bit for bit.  Jitted, XLA feeds the gate's
    product to the softmax in fp32 without the bf16 rounding the op
    writes (``(x @ gate_w).astype(float32)``), which moves some gates by
    an ulp and so some tokens' experts: that run is not the op's
    arithmetic, and the port (which rounds as written) is held to the
    eager one."""
    import jax
    T, D, E, H = 1024, 8, 4, 16
    r = np.random.RandomState(3)
    gate = r.randn(D, E).astype(np.float32)
    gate[:, 0] += 0.5
    ins = {"X": [r.randn(T, D).astype(np.float32)], "GateW": [gate],
           "W1": [(r.randn(E, D, H) * 0.5).astype(np.float32)],
           "W2": [(r.randn(E, H, D) * 0.5).astype(np.float32)]}
    attrs = {"top_k": 2, "capacity_factor": 1.25, "activation": "relu"}
    ctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0),
                                  is_test=True)
    ctx.op = tp.OneOp("moe", ins, attrs)
    with jax.disable_jit():
        want = tp.jax_impl("moe")(ctx, {k: [jnp.asarray(v[0], jnp.bfloat16)]
                                        for k, v in ins.items()}, attrs)
    _, got, _, _ = tp.run_op("moe", ins, attrs, "bfloat16")
    assert got[("Out", 0)].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[("Out", 0)].float().numpy(),
                                  np.asarray(want["Out"], np.float32))
    assert float(got[("AuxLoss", 0)]) == float(want["AuxLoss"])


def _moe_program(pkg, width=16, experts=8, hidden=32):
    """``tests/test_pipeline_program.py``'s MoE program: layers.moe,
    square error against y, 0.01 of the aux loss added, SGD(0.05)."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", shape=[width], dtype="float32")
        y = L.data("y", shape=[width], dtype="float32")
        out, aux = L.moe(x, num_experts=experts, expert_hidden=hidden,
                         top_k=2, capacity_factor=4.0)
        loss = L.mean(L.square_error_cost(out, y))
        total = L.elementwise_add(loss, L.scale(aux, scale=0.01))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(total)
    return main, startup, {"total": total, "aux": aux}


def test_layer_trains_as_the_reference():
    m = tp.both_built(_moe_program)
    r = np.random.RandomState(0)
    feed = {"x": r.randn(32, 16).astype(np.float32),
            "y": r.randn(32, 16).astype(np.float32)}
    (jm, jv, js), (tm, tv, ts) = m["jax"], m["torch"]
    w = [p for p in tm.all_parameters() if len(p.shape) == 3]
    assert len(w) == 2 and all(p.sharding == ("ep", None, None) for p in w)
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    losses = []
    for _ in range(3):
        jo = jexe.run(jm, feed=feed, fetch_list=[jv["total"], jv["aux"]],
                      scope=js)
        to = texe.run(tm, feed=feed, fetch_list=[tv["total"], tv["aux"]],
                      scope=ts)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a, np.asarray(b), **PROG_TOL)
        losses.append(float(to[0]))
    assert losses[-1] < losses[0]
    for k in js.keys():
        np.testing.assert_allclose(ts.numpy(k), js.numpy(k), err_msg=k,
                                   **PROG_TOL)
