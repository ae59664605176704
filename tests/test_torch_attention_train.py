"""The attention training slice in the port against the JAX package on
the CPU: ``benchmark/longctx.py``'s framework program (three parameters,
``layers.flash_attention``, ``scale(mean(o * o))``, SGD) built by both
packages and through JSON, trained with ``run_steps`` in fp32 and under
AMP; the projection-attention program of tests/test_sp_program.py on one
device through both attention entry points; and the slice's other ops:
``matmul``, ``mse_loss``, ``dropout`` and the 4-D and dropout routes of
``nets.scaled_dot_product_attention``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl
from paddle_tpu_torch.ops import flash_attention as fa
from torch_parity import build_longctx, jax_state, reset_both

R = np.random.RandomState(23)
GRADS = ["lc_q@GRAD", "lc_k@GRAD", "lc_v@GRAD"]


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    fa.reset_counts()
    yield


def _jax_start(startup):
    scope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return scope


def _port_scope(jscope):
    scope = ptt.Scope()
    ptt.load_numpy_state(scope, jax_state(jscope), "cpu")
    return scope


def _close_to_scale(got, want, rtol, err_msg=""):
    """Elementwise, with atol ``rtol`` times the reference's scale."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# the long-context step (benchmark/longctx.py --framework, reduced)
# ---------------------------------------------------------------------------
H, T, DIM, BLOCK = 2, 256, 64, 64
LR = 1e6


def test_longctx_program_matches_jax_and_survives_json():
    jm, _, jl = build_longctx(pt, T, H, DIM, block=BLOCK, interpret=True)
    tm, _, tl = build_longctx(ptt, T, H, DIM, block=BLOCK, interpret=True)
    assert tm.to_dict() == jm.to_dict()
    assert tl.name == jl.name
    ops = [op.type for op in tm.global_block().ops]
    assert ops.count("flash_attention") == 1 and "backward" in ops
    loaded = ptt.Program.from_json(jm.to_json())
    assert loaded.to_json() == jm.to_json()
    attn = next(op for op in loaded.global_block().ops
                if op.type == "flash_attention")
    assert attn.attrs["causal"] is True and attn.attrs["interpret"] is True
    assert attn.attrs["block_q"] == attn.attrs["block_k"] == BLOCK


@pytest.mark.parametrize("via_json", [False, True])
@pytest.mark.parametrize("amp", [False, True])
def test_longctx_trains_like_jax(amp, via_json):
    """run_steps(3) of the JAX program (the op's Pallas kernels in
    interpret mode) and of the port's (the plain versions on CPU tensors),
    from the JAX startup scope: per-step losses and q/k/v gradients.
    fp32: the same fp32 math in another summation order.  AMP: bf16
    q, k, v and out on both sides, fp32 softmax math, so the two differ
    by bf16 roundings (a few 2^-8).  The loss is ~1e-9 at Xavier init, so
    the learning rate is large enough for the updates to move it."""
    jm, js, jl = build_longctx(pt, T, H, DIM, block=BLOCK, lr=LR,
                               interpret=True)
    if via_json:
        tm = ptt.Program.from_json(jm.to_json())
        tl = tm.global_block().var(jl.name)
    else:
        tm, _, tl = build_longctx(ptt, T, H, DIM, block=BLOCK, lr=LR,
                                  interpret=True)
    jscope = _jax_start(js)
    tscope = _port_scope(jscope)
    fetch = [jl.name] + GRADS
    jout = pt.Executor(pt.CPUPlace(), amp=amp).run_steps(
        3, jm, feed={}, fetch_list=fetch, scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace(), amp=amp).run_steps(
        3, tm, feed={}, fetch_list=[tl] + GRADS, scope=tscope)
    assert not fa.reference_route and not fa.launches   # plain, no launch
    rtol = 2e-2 if amp else 1e-4
    for name, j, t in zip(fetch, jout, tout):
        assert t.shape == np.shape(j), name
        assert np.isfinite(t).all(), name
        _close_to_scale(t, j, rtol, name)
    # the updates moved the parameters the same way, and lowered the loss
    for n in ("lc_q", "lc_k", "lc_v"):
        _close_to_scale(tscope.numpy(n), jscope.numpy(n),
                        1e-3 if amp else 1e-5, n)
    assert tout[0][-1] < tout[0][0] * (1 - 1e-3)


def test_longctx_under_amp_computes_bf16_and_returns_fp32_grads():
    """Under AMP the fp32 leaves reach the op as bf16 copies, the
    attention runs in bf16, and the gradients come back fp32 through the
    casts."""
    seen = []
    op_impl = torch_impl("flash_attention")

    def spy(ctx, ins, attrs):
        seen.append([ins[s][0].dtype for s in ("Q", "K", "V")])
        out = op_impl(ctx, ins, attrs)
        seen.append([out["Out"].dtype])
        return out

    tm, ts, tl = build_longctx(ptt, 128, H, DIM, block=BLOCK)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), amp=True)
    exe.run(ts, scope=scope)
    from paddle_tpu_torch.core import registry
    registry._OP_IMPLS["flash_attention"] = spy
    try:
        out = exe.run(tm, fetch_list=[tl] + GRADS, scope=scope,
                      return_numpy=False)
    finally:
        registry._OP_IMPLS["flash_attention"] = op_impl
    assert seen == [[torch.bfloat16] * 3, [torch.bfloat16]]
    assert out[0].dtype == torch.float32
    for g in out[1:]:
        assert g.dtype == torch.float32 and g.shape == (H, 128, DIM)
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# projection attention on one device (tests/test_sp_program.py:20-40)
# ---------------------------------------------------------------------------
PT_, PD = 16, 16


def _proj_attention(pkg, causal, via_nets):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [PT_, PD])
        y = pkg.layers.data("y", [PT_, PD])
        q = pkg.layers.fc(x, size=PD, num_flatten_dims=2)
        k = pkg.layers.fc(x, size=PD, num_flatten_dims=2)
        v = pkg.layers.fc(x, size=PD, num_flatten_dims=2)
        if via_nets:
            att = pkg.nets.scaled_dot_product_attention(q, k, v)
        else:
            att = pkg.layers.flash_attention(q, k, v, causal=causal)
        out = pkg.layers.fc(att, size=PD, num_flatten_dims=2)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(out, y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("causal,via_nets", [(True, False), (False, False),
                                             (False, True)])
def test_projection_attention_trains_like_jax(causal, via_nets):
    jm, js, jl = _proj_attention(pt, causal, via_nets)
    tm, _, tl = _proj_attention(ptt, causal, via_nets)
    assert tm.to_dict() == jm.to_dict()
    jscope = _jax_start(js)
    tscope = _port_scope(jscope)
    feeds = {"x": R.randn(4, PT_, PD).astype("float32"),
             "y": R.randn(4, PT_, PD).astype("float32")}
    je = pt.Executor(pt.CPUPlace())
    te = ptt.Executor(ptt.CPUPlace())
    jloss = [float(je.run(jm, feed=feeds, fetch_list=[jl],
                          scope=jscope)[0]) for _ in range(3)]
    tloss = [float(te.run(tm, feed=feeds, fetch_list=[tl],
                          scope=tscope)[0]) for _ in range(3)]
    assert fa.launches == {} and fa.reference_route == {}
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tloss[-1] < tloss[0]
    # the key projection's bias has an exactly zero gradient (a shift of
    # every key moves a row's scores by one constant), so it holds
    # rounding noise of ~1e-10 on both sides: atol has a floor of 1e-9
    for n in jscope.keys():
        want = jscope.numpy(n)
        np.testing.assert_allclose(
            tscope.numpy(n), want, rtol=1e-4,
            atol=1e-4 * max(np.abs(want).max(), 1e-5), err_msg=n)


# ---------------------------------------------------------------------------
# matmul, mse_loss, dropout, and the other nets routes
# ---------------------------------------------------------------------------
def _ctxs(is_test=False):
    jctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0),
                                   is_test=is_test)
    tctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                                is_test=is_test)
    return jctx, tctx


def _op_and_grads(op, ins, attrs, out_slot="Out"):
    """Forward of ``op`` in both packages and the gradients of
    sum(out * w) with respect to every input (first tensor per slot)."""
    jctx, tctx = _ctxs()
    slots = list(ins)

    def jfun(*vals):
        return jax_impl(op)(jctx, {s: [v] for s, v in zip(slots, vals)},
                            dict(attrs))[out_slot]

    jvals = [jnp.asarray(ins[s]) for s in slots]
    jout = jfun(*jvals)
    w = R.randn(*np.shape(jout)).astype("float32")
    jg = jax.grad(lambda *v: jnp.sum(jfun(*v) * w),
                  argnums=tuple(range(len(slots))))(*jvals)
    leaves = [torch.from_numpy(np.array(ins[s])).requires_grad_(True)
              for s in slots]
    tout = torch_impl(op)(tctx, {s: [t] for s, t in zip(slots, leaves)},
                          dict(attrs))[out_slot]
    (tout * torch.from_numpy(w)).sum().backward()
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("xs,ys,tx,ty,alpha", [
    ((5, 4), (4, 3), False, False, 1.0),
    ((4, 5), (4, 3), True, False, 1.0),
    ((5, 4), (3, 4), False, True, 0.5),
    ((2, 6, 4), (2, 6, 3), True, False, 1.0),
    ((2, 3, 5, 4), (2, 3, 6, 4), False, True, 2.0),
])
def test_matmul_matches_jax(xs, ys, tx, ty, alpha):
    ins = {"X": R.randn(*xs).astype("float32"),
           "Y": R.randn(*ys).astype("float32")}
    attrs = {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha}
    j, t, jg, tg = _op_and_grads("matmul", ins, attrs)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_mse_loss_matches_jax():
    ins = {"X": R.randn(6, 4).astype("float32"),
           "Y": R.randn(6, 4).astype("float32")}
    j, t, jg, tg = _op_and_grads("mse_loss", ins, {})
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_test_mode_matches_jax(impl):
    x = R.randn(8, 16).astype("float32")
    attrs = {"dropout_prob": 0.3, "is_test": True,
             "dropout_implementation": impl}
    jctx, tctx = _ctxs(is_test=True)
    j = jax_impl("dropout")(jctx, {"X": [jnp.asarray(x)]}, attrs)
    t = torch_impl("dropout")(tctx, {"X": [torch.from_numpy(x)]}, attrs)
    for slot in ("Out", "Mask"):
        np.testing.assert_allclose(t[slot].numpy(), np.asarray(j[slot]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_train_mask_statistics(impl):
    """The mask is Bernoulli(1 - p): its mean lies within 5 sigma of
    1 - p, Out is x * mask (/ (1 - p) when upscaling), the same draws
    repeat for the same (program seed, step, op) and differ across
    steps; the gradient is the mask."""
    p, n = 0.3, 200 * 200
    x = torch.from_numpy(R.rand(200, 200).astype("float32") + 0.5)
    attrs = {"dropout_prob": p, "is_test": False,
             "dropout_implementation": impl}
    impl_fn = torch_impl("dropout")
    xs = x.clone().requires_grad_(True)
    out = impl_fn(_ctxs()[1], {"X": [xs]}, attrs)
    mask = out["Mask"]
    assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(mask.mean().item() - (1 - p)) < 5 * sigma
    want = x * mask / ((1 - p) if impl == "upscale_in_train" else 1.0)
    torch.testing.assert_close(out["Out"].detach(), want)
    out["Out"].sum().backward()
    torch.testing.assert_close(
        xs.grad, mask / ((1 - p) if impl == "upscale_in_train" else 1.0))
    again = impl_fn(_ctxs()[1], {"X": [x]}, attrs)["Mask"]
    assert torch.equal(again, mask)
    other = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 1)
    assert not torch.equal(impl_fn(other, {"X": [x]}, attrs)["Mask"], mask)


def _nets_program(pkg, shape, dropout_rate=0.0):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        q = pkg.layers.data("q", list(shape))
        k = pkg.layers.data("k", list(shape))
        v = pkg.layers.data("v", list(shape))
        out = pkg.nets.scaled_dot_product_attention(
            q, k, v, dropout_rate=dropout_rate)
    return main, out


def test_nets_4d_route_matches_jax():
    """[B, H, T, D] inputs go through scale, matmul and softmax in both
    packages, not through the kernels."""
    shape = (2, 12, 8)
    feeds = {n: R.randn(3, *shape).astype("float32") for n in "qkv"}
    jm, jo = _nets_program(pt, shape)
    tm, to = _nets_program(ptt, shape)
    assert tm.to_dict() == jm.to_dict()
    assert "flash_attention" not in [op.type for op in tm.global_block().ops]
    j = pt.Executor(pt.CPUPlace()).run(jm, feed=feeds, fetch_list=[jo])[0]
    t = ptt.Executor(ptt.CPUPlace()).run(tm, feed=feeds, fetch_list=[to])[0]
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_nets_dropout_route():
    """With attention-weight dropout, 3-D inputs take the matmul route
    with a dropout op on the softmax weights: in test mode the weights
    are scaled by 1 - p and match JAX; in training each output row is
    (softmax * mask) @ v with a Bernoulli(1 - p) mask."""
    shape, p = (12, 8), 0.5
    feeds = {n: R.randn(4, *shape).astype("float32") for n in "qkv"}
    jm, jo = _nets_program(pt, shape, dropout_rate=p)
    tm, to = _nets_program(ptt, shape, dropout_rate=p)
    assert tm.to_dict() == jm.to_dict()
    gb = tm.global_block()
    drop = next(op for op in gb.ops if op.type == "dropout")
    soft = next(op for op in gb.ops if op.type == "softmax")
    j = pt.Executor(pt.CPUPlace()).run(jm, feed=feeds, fetch_list=[jo],
                                       is_test=True)[0]
    t = ptt.Executor(ptt.CPUPlace()).run(tm, feed=feeds, fetch_list=[to],
                                         is_test=True)[0]
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    out, weights, mask = ptt.Executor(ptt.CPUPlace()).run(
        tm, feed=feeds, fetch_list=[to, soft.output("Out")[0],
                                    drop.output("Mask")[0]])
    n = mask.size
    assert abs(mask.mean() - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    np.testing.assert_allclose(out, (weights * mask) @ feeds["v"],
                               rtol=1e-5, atol=1e-6)
