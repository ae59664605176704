"""The seq2seq slice's ops in the port against their JAX lowerings, on
the same numpy-seeded inputs: forward values and output dtypes in fp32
and bf16, and the gradients of the differentiable ones against
``jax.grad`` (fp32).

Each case is a small program built with the JAX package (``Block
.append_op``, sub-block for ``rnn``) and loaded into the port through
its JSON form; both packages interpret it with their own ``run_op``
from the same env, sequence lengths given as ``name@LEN`` entries.

Tolerances: fp32 ``rtol=atol=1e-5`` (both compute exact fp32, only the
order of the sums differs); bf16 ``rtol=atol=3e-2``, a few bf16 ulps
(2^-8 relative each): XLA may keep a fused chain in fp32 where torch
rounds every op to bf16, and a recurrence carries the difference over
its steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt

R = np.random.RandomState(10)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _x(*shape):
    return R.randn(*shape).astype(np.float32)


def _lens(B, T):
    """Ragged lengths in 1..T with both ends present."""
    lens = R.randint(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T, 1
    return lens


class Case:
    """A JAX program of ops appended to block 0 (and, with ``sub``,
    to a step sub-block), run in both packages from one feed dict."""

    def __init__(self):
        self.prog = pt.Program()
        self.gb = self.prog.global_block()

    def var(self, name, lod_level=0, block=None):
        (block or self.gb).create_var(name=name, lod_level=lod_level)
        return name

    def op(self, type, inputs, outputs, attrs=None, block=None):
        for ns in outputs.values():
            for n in ns:
                if not (block or self.gb).has_var(n):
                    self.var(n, block=block)
        (block or self.gb).append_op(type, inputs, outputs, attrs or {})

    def run(self, feeds, outs, dtype="float32", wrt=(), float_feeds=None):
        """(jax env, torch env, jax grads, torch grads).  ``float_feeds``
        (default: every float feed) are cast to ``dtype``; the grads are
        of sum(out * cotangent) over ``outs`` wrt the ``wrt`` feeds."""
        float_feeds = [k for k, v in feeds.items() if v.dtype == np.float32] \
            if float_feeds is None else float_feeds
        tprog = ptt.Program.from_json(self.prog.to_json())
        jf = {k: jnp.asarray(v, JDT[dtype] if k in float_feeds else None)
              for k, v in feeds.items()}
        tf = {k: torch.from_numpy(np.array(v)).to(TDT[dtype])
              if k in float_feeds else torch.from_numpy(np.array(v))
              for k, v in feeds.items()}

        def jax_env(wvals):
            env = pt.core.Env(self.gb)
            env.local.update(jf)
            env.local.update(zip(wrt, wvals))
            ctx = pt.core.LoweringContext(self.prog, jax.random.PRNGKey(0))
            pt.core.interpret_ops(self.gb.ops, env, ctx)
            return env

        jenv = jax_env([jf[n] for n in wrt])
        leaves = [tf[n].clone().requires_grad_(True) for n in wrt]
        tenv = ptt.core.Env(tprog.global_block())
        tenv.local.update(tf)
        tenv.local.update(zip(wrt, leaves))
        ctx = ptt.core.ExecContext(tprog, torch.device("cpu"), 0)
        with torch.enable_grad():
            ptt.core.interpret_ops(tprog.global_block().ops, tenv, ctx)
        jg, tg = [], []
        if wrt:
            cot = {n: R.randn(*jenv.get(n).shape).astype(np.float32)
                   for n in outs}

            def loss(*wvals):
                env = jax_env(wvals)
                return sum(jnp.sum(env.get(n).astype(jnp.float32) * cot[n])
                           for n in outs)

            jg = [np.asarray(g, np.float32) for g in
                  jax.grad(loss, argnums=tuple(range(len(wrt))))(
                      *[jf[n] for n in wrt])]
            tl = sum((tenv.get(n).float() * torch.from_numpy(cot[n])).sum()
                     for n in outs)
            tg = [g.float().numpy() for g in torch.autograd.grad(tl, leaves)]
        return jenv, tenv, jg, tg


def _same(jenv, tenv, names, dtype):
    """Values within TOL[dtype] and equal dtypes."""
    for n in names:
        j, t = jenv.get(n), tenv.get(n)
        assert str(jnp.dtype(j.dtype)) == str(t.dtype).replace("torch.", ""), \
            (n, j.dtype, t.dtype)
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), err_msg=n,
                                   **TOL[dtype])


def _same_grads(jg, tg, wrt):
    for n, a, b in zip(wrt, jg, tg):
        np.testing.assert_allclose(b, a, err_msg=f"d/d{n}",
                                   **TOL["float32"])


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad", [None, 3])
@pytest.mark.parametrize("ids_shape", [(4, 6), (4, 6, 1)])
def test_lookup_table_matches_jax(ids_shape, pad, dtype):
    """Rows of W by int64 ids, [..., 1] ids squeezed, padding_idx rows
    zero (and no gradient into W's row 3 from them)."""
    c = Case()
    c.op("lookup_table", {"W": ["w"], "Ids": ["ids"]}, {"Out": ["out"]},
         {"is_sparse": False, "padding_idx": -1 if pad is None else pad})
    ids = R.randint(0, 10, ids_shape).astype(np.int64)
    ids.reshape(-1)[:3] = 3
    feeds = {"w": _x(10, 5), "ids": ids}
    j, t, jg, tg = c.run(feeds, ["out"], dtype,
                         wrt=("w",) if dtype == "float32" else ())
    _same(j, t, ["out"], dtype)
    assert t.get("out").shape == ids_shape[:2] + (5,)
    if pad is not None:
        assert not t.get("out")[torch.from_numpy(ids.reshape(4, 6) == 3)].any()
    _same_grads(jg, tg, ["w"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse,h0", [(False, False), (True, False),
                                        (False, True)])
def test_gru_matches_jax(reverse, h0, dtype):
    """The GRU recurrence over ragged lengths: masked, reversed within
    each row's length, from an optional H0; Hidden gets the input's
    @LEN."""
    B, T, H = 4, 6, 5
    c = Case()
    c.var("x", lod_level=1)
    ins = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"]}
    if h0:
        ins["H0"] = ["h0"]
    c.op("gru", ins, {"Hidden": ["hid"]},
         {"is_reverse": reverse, "gate_activation": "sigmoid",
          "activation": "tanh"})
    lens = _lens(B, T)
    feeds = {"x": _x(B, T, 3 * H), "x@LEN": lens, "w": _x(H, 3 * H) * 0.5,
             "b": _x(1, 3 * H)}
    if h0:
        feeds["h0"] = _x(B, H)
    wrt = tuple(k for k in feeds if k != "x@LEN") \
        if dtype == "float32" else ()
    j, t, jg, tg = c.run(feeds, ["hid"], dtype, wrt=wrt)
    _same(j, t, ["hid"], dtype)
    _same_grads(jg, tg, wrt)
    np.testing.assert_array_equal(t.get("hid@LEN").numpy(), lens)
    np.testing.assert_array_equal(np.asarray(j.get("hid@LEN")), lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    assert not t.get("hid").detach()[torch.from_numpy(~mask)].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_gru_unit_matches_jax(dtype):
    """One GRU step: Hidden, Gate [u | r] and ResetHiddenPrev."""
    B, H = 4, 5
    c = Case()
    c.op("gru_unit", {"Input": ["x"], "HiddenPrev": ["h"], "Weight": ["w"],
                      "Bias": ["b"]},
         {"Hidden": ["hid"], "Gate": ["gate"], "ResetHiddenPrev": ["rh"]},
         {"activation": "tanh", "gate_activation": "sigmoid"})
    feeds = {"x": _x(B, 3 * H), "h": _x(B, H), "w": _x(H, 3 * H) * 0.5,
             "b": _x(1, 3 * H)}
    outs = ["hid", "gate", "rh"]
    wrt = tuple(feeds) if dtype == "float32" else ()
    j, t, jg, tg = c.run(feeds, outs, dtype, wrt=wrt)
    _same(j, t, outs, dtype)
    _same_grads(jg, tg, wrt)


POOLS = ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pooltype", POOLS)
def test_sequence_pool_matches_jax(pooltype, dtype):
    """Every pool type over ragged lengths [B, T, F] -> [B, F]."""
    c = Case()
    c.var("x", lod_level=1)
    c.op("sequence_pool", {"X": ["x"]}, {"Out": ["out"]},
         {"pooltype": pooltype})
    feeds = {"x": _x(5, 7, 3), "x@LEN": _lens(5, 7)}
    wrt = ("x",) if dtype == "float32" else ()
    j, t, jg, tg = c.run(feeds, ["out"], dtype, wrt=wrt)
    _same(j, t, ["out"], dtype)
    _same_grads(jg, tg, wrt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pooltype", ["LAST", "FIRST"])
def test_sequence_pool_nested_matches_jax(pooltype, dtype):
    """A nested sequence [B, S, T, F] with @LEN [B] and @LEN2 [B, S]:
    the last token of the last subsequence, or the very first."""
    B, S, T = 4, 3, 5
    c = Case()
    c.var("x", lod_level=2)
    c.op("sequence_pool", {"X": ["x"]}, {"Out": ["out"]},
         {"pooltype": pooltype})
    feeds = {"x": _x(B, S, T, 2), "x@LEN": _lens(B, S),
             "x@LEN2": R.randint(1, T + 1, (B, S)).astype(np.int32)}
    wrt = ("x",) if dtype == "float32" else ()
    j, t, jg, tg = c.run(feeds, ["out"], dtype, wrt=wrt)
    _same(j, t, ["out"], dtype)
    _same_grads(jg, tg, wrt)


SHAPE_OPS = [
    ("reshape", {"shape": [-1, 6]}, (2, 3, 4, 1)),
    ("reshape", {"shape": [0, -1]}, (2, 3, 4, 1)),
    ("reshape", {"shape": [2, 0, 4]}, (2, 3, 4, 1)),
    ("squeeze", {"axes": [3]}, (2, 3, 4, 1)),
    ("squeeze", {"axes": [-1]}, (2, 3, 4, 1)),
    ("squeeze", {"axes": []}, (2, 1, 4, 1)),
    ("unsqueeze", {"axes": [1]}, (2, 3, 4)),
    ("unsqueeze", {"axes": [0, 2]}, (2, 3, 4)),
    ("unsqueeze", {"axes": [-1]}, (2, 3, 4)),
    ("tanh", {}, (3, 4)),
    ("sigmoid", {}, (3, 4)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,attrs,shape", SHAPE_OPS,
                         ids=[f"{o}-{a}" for o, a, _ in SHAPE_OPS])
def test_shape_and_activation_ops_match_jax(op, attrs, shape, dtype):
    """reshape (0 copies a dim, -1 is inferred), squeeze, unsqueeze
    (negative axes too), tanh, sigmoid: values, shapes, dtypes."""
    c = Case()
    c.op(op, {"X": ["x"]}, {"Out": ["out"]}, attrs)
    wrt = ("x",) if dtype == "float32" else ()
    j, t, jg, tg = c.run({"x": _x(*shape)}, ["out"], dtype, wrt=wrt)
    _same(j, t, ["out"], dtype)
    assert tuple(t.get("out").shape) == tuple(j.get("out").shape)
    _same_grads(jg, tg, wrt)


def test_squeeze_of_a_wide_axis_raises_in_both():
    c = Case()
    c.op("squeeze", {"X": ["x"]}, {"Out": ["out"]}, {"axes": [1]})
    with pytest.raises(ValueError):
        c.run({"x": _x(2, 3)}, ["out"])


@pytest.mark.parametrize("mix", ["fp32", "amp"])
def test_adam_three_steps_match_jax(mix):
    """Three Adam steps, each output fed back, in fp32 and in the AMP
    executor's mix (fp32 param and grad; bf16 moments, beta pows and
    learning rate): param, moments, beta pows, dtypes.  Under the mix
    bf16(0.999) is 1.0, so the step is zero in both packages."""
    c = Case()
    names = {"Param": "p", "Grad": "g", "Moment1": "m1", "Moment2": "m2",
             "Beta1Pow": "b1p", "Beta2Pow": "b2p", "LearningRate": "lr"}
    outs = {"ParamOut": "p", "Moment1Out": "m1", "Moment2Out": "m2",
            "Beta1PowOut": "b1p", "Beta2PowOut": "b2p"}
    for _ in range(3):
        c.op("adam", {k: [v] for k, v in names.items()},
             {k: [v] for k, v in outs.items()},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    feeds = {"p": _x(6, 4), "g": _x(6, 4) * 1e-2, "m1": np.zeros((6, 4),
                                                                np.float32),
             "m2": np.zeros((6, 4), np.float32),
             "b1p": np.full(1, 0.9, np.float32),
             "b2p": np.full(1, 0.999, np.float32),
             "lr": np.full(1, 1e-2, np.float32)}
    low = ["m1", "m2", "b1p", "b2p", "lr"] if mix == "amp" else []
    j, t, _, _ = c.run(feeds, [], "bfloat16", float_feeds=low)
    _same(j, t, ["p", "m1", "m2", "b1p", "b2p"],
          "bfloat16" if mix == "amp" else "float32")
    moved = np.abs(t.get("p").numpy() - feeds["p"]).max()
    if mix == "amp":
        assert moved == 0.0
        assert float(t.get("b2p")) == 1.0 and float(j.get("b2p")[0]) == 1.0
    else:
        assert 0.02 < moved < 0.04           # 3 steps of about lr each
        np.testing.assert_allclose(t.get("b1p").numpy(), [0.9 ** 4],
                                   rtol=1e-6)


def test_copy_len_forwards_both_companions():
    """copy_len hands X's @LEN and @LEN2 to Out, in both packages, and
    nothing when X has none."""
    c = Case()
    c.var("x", lod_level=2)
    c.op("copy_len", {"X": ["x"]}, {"Out": ["y"]})
    c.op("copy_len", {"X": ["z"]}, {"Out": ["w"]})
    lens = _lens(3, 4)
    lens2 = R.randint(1, 5, (3, 4)).astype(np.int32)
    j, t, _, _ = c.run({"x": _x(3, 4, 5), "x@LEN": lens, "x@LEN2": lens2,
                        "z": _x(3)}, [])
    for env in (j, t):
        np.testing.assert_array_equal(np.asarray(env.get("y@LEN")), lens)
        np.testing.assert_array_equal(np.asarray(env.get("y@LEN2")), lens2)
        assert not env.has("w@LEN") and not env.has("w@LEN2")


def _rnn_case(two_inputs=False):
    """h_t = tanh(x_t W + h_{t-1} U) over the steps, outputs h_t (with
    ``two_inputs``, x_t + y_t in place of x_t); a second op after the
    loop reads the init state h0 again."""
    c = Case()
    c.var("x", lod_level=1)
    sub = c.prog.create_block()
    step_in = ["x_t"] + (["y_t"] if two_inputs else [])
    for n in step_in + ["mem"]:
        c.var(n, block=sub)
    xin = "x_t"
    if two_inputs:
        c.op("elementwise_add", {"X": ["x_t"], "Y": ["y_t"]},
             {"Out": ["xy_t"]}, {"axis": -1}, block=sub)
        xin = "xy_t"
    c.op("mul", {"X": [xin], "Y": ["w"]}, {"Out": ["xw"]},
         {"x_num_col_dims": 1, "y_num_col_dims": 1}, block=sub)
    c.op("mul", {"X": ["mem"], "Y": ["u"]}, {"Out": ["hu"]},
         {"x_num_col_dims": 1, "y_num_col_dims": 1}, block=sub)
    c.op("elementwise_add", {"X": ["xw"], "Y": ["hu"]}, {"Out": ["pre"]},
         {"axis": -1}, block=sub)
    c.op("tanh", {"X": ["pre"]}, {"Out": ["h_new"]}, block=sub)
    c.prog.rollback()
    c.var("out", lod_level=1)
    c.op("rnn", {"Inputs": ["x"] + (["y"] if two_inputs else []),
                 "InitStates": ["h0"]},
         {"Outputs": ["out"]},
         {"sub_block": sub.idx, "step_inputs": step_in,
          "mem_step_names": ["mem"], "mem_update_names": ["h_new"],
          "step_output_names": ["h_new"]})
    c.op("elementwise_add", {"X": ["h0"], "Y": ["h0"]}, {"Out": ["h0x2"]},
         {"axis": -1})
    return c


def _rnn_reference(x, h0, w, u, lens):
    """The recurrence in numpy float64, rows frozen past their length."""
    B, T = x.shape[:2]
    h = h0.astype(np.float64)
    out = np.zeros((B, T, h.shape[1]))
    for t in range(T):
        new = np.tanh(x[:, t] @ w + h @ u)
        live = (t < lens)[:, None]
        h = np.where(live, new, h)
        out[:, t] = np.where(live, new, 0.0)
    return out, h


@pytest.mark.parametrize("dtype", DTYPES)
def test_rnn_matches_jax_with_ragged_lengths(dtype):
    """The rnn op over ragged lengths: outputs zeroed past each length
    and each row's memory frozen there (the numpy recurrence freezes it;
    no output shows a frozen memory, since all of a finished row's
    outputs are zero), Outputs@LEN set to the input's lengths, the init
    state read after the loop unchanged, no step var leaked into the
    parent env; gradients of x, h0, W and U."""
    B, T, D, H = 4, 6, 3, 5
    c = _rnn_case()
    lens = _lens(B, T)
    feeds = {"x": _x(B, T, D), "x@LEN": lens, "h0": _x(B, H),
             "w": _x(D, H) * 0.5, "u": _x(H, H) * 0.5}
    wrt = ("x", "h0", "w", "u") if dtype == "float32" else ()
    j, t, jg, tg = c.run(feeds, ["out"], dtype, wrt=wrt)
    _same(j, t, ["out", "h0x2"], dtype)
    _same_grads(jg, tg, wrt)
    want, _ = _rnn_reference(feeds["x"], feeds["h0"], feeds["w"],
                             feeds["u"], lens)
    np.testing.assert_allclose(t.get("out").detach().float().numpy(), want,
                               **TOL[dtype])
    for env in (j, t):
        np.testing.assert_array_equal(np.asarray(env.get("out@LEN")), lens)
        assert not any(env.has(n) for n in ("x_t", "mem", "h_new", "pre"))
    np.testing.assert_array_equal(t.get("h0").detach().float().numpy(),
                                  torch.from_numpy(feeds["h0"])
                                  .to(TDT[dtype]).float().numpy())


def test_rnn_without_lengths_steps_every_input_to_the_end():
    """No input has an @LEN: every row runs all T steps, each step input
    is sliced (x_t + y_t feeds the step), Outputs@LEN is T."""
    B, T, D, H = 4, 6, 3, 5
    c = _rnn_case(two_inputs=True)
    feeds = {"x": _x(B, T, D), "y": _x(B, T, D), "h0": _x(B, H),
             "w": _x(D, H) * 0.5, "u": _x(H, H) * 0.5}
    wrt = ("x", "y", "h0")
    j, t, jg, tg = c.run(feeds, ["out"], wrt=wrt)
    _same(j, t, ["out"], "float32")
    _same_grads(jg, tg, wrt)
    want, _ = _rnn_reference(feeds["x"] + feeds["y"], feeds["h0"],
                             feeds["w"], feeds["u"], np.full(B, T))
    np.testing.assert_allclose(t.get("out").detach().numpy(), want, **TOL["float32"])
    np.testing.assert_array_equal(t.get("out@LEN").numpy(), np.full(B, T))


def test_rnn_nested_input_hands_inner_lengths_to_the_step():
    """A nested input [B, S, T, F] with @LEN2: each step's slice gets its
    inner lengths as @LEN (pooled by the step's LAST), and the stacked
    per-step vectors carry @LEN but no @LEN2."""
    B, S, T, F = 3, 4, 5, 2
    c = Case()
    c.var("x", lod_level=2)
    sub = c.prog.create_block()
    c.var("x_t", lod_level=1, block=sub)
    c.var("mem", block=sub)
    c.op("sequence_pool", {"X": ["x_t"]}, {"Out": ["last"]},
         {"pooltype": "LAST"}, block=sub)
    c.op("elementwise_add", {"X": ["last"], "Y": ["mem"]}, {"Out": ["acc"]},
         {"axis": -1}, block=sub)
    c.prog.rollback()
    c.var("out", lod_level=1)
    c.op("rnn", {"Inputs": ["x"], "InitStates": ["h0"]},
         {"Outputs": ["out"]},
         {"sub_block": sub.idx, "step_inputs": ["x_t"],
          "mem_step_names": ["mem"], "mem_update_names": ["acc"],
          "step_output_names": ["acc"]})
    lens2 = R.randint(1, T + 1, (B, S)).astype(np.int32)
    feeds = {"x": _x(B, S, T, F), "x@LEN": _lens(B, S), "x@LEN2": lens2,
             "h0": np.zeros((B, F), np.float32)}
    j, t, _, _ = c.run(feeds, ["out"])
    _same(j, t, ["out"], "float32")
    x = feeds["x"]
    lasts = x[np.arange(B)[:, None], np.arange(S)[None, :], lens2 - 1]
    mask = (np.arange(S)[None, :] < feeds["x@LEN"][:, None])[..., None]
    np.testing.assert_allclose(t.get("out").detach().numpy(),
                               np.cumsum(lasts * mask, axis=1) * mask,
                               **TOL["float32"])
    for env in (j, t):
        assert env.has("out@LEN") and not env.has("out@LEN2")


def test_fill_constant_batch_size_like_matches_jax():
    c = Case()
    c.op("fill_constant_batch_size_like", {"Input": ["x"]}, {"Out": ["out"]},
         {"shape": [-1, 3], "dtype": "float32", "value": 0.5,
          "input_dim_idx": 0, "output_dim_idx": 0})
    j, t, _, _ = c.run({"x": _x(4, 7)}, [])
    _same(j, t, ["out"], "float32")
    assert tuple(t.get("out").shape) == (4, 3)


def test_env_lookup_and_write_through_match_jax():
    """A step env reads through to its parent; ``set`` binds where the
    name is already bound, else in the env whose block declares it (the
    parent's var: write-through), else locally; ``snapshot`` lets the
    nearer binding win.  The same bindings in both packages."""
    prog = pt.Program()
    prog.global_block().create_var(name="a")
    sub = prog.create_block()
    sub.create_var(name="b")
    prog.rollback()
    tprog = ptt.Program.from_json(prog.to_json())
    placed = []
    for pkg, p in ((pt, prog), (ptt, tprog)):
        parent = pkg.core.Env(p.global_block())
        parent.local.update({"a": 0, "m": 0})
        child = pkg.core.Env(p.blocks[1], parent=parent)
        child.local["m"] = 1            # a step's own memory binding
        for n in ("a", "b", "c", "m"):
            child.set(n, 2)
        assert child.get("a") == 2 and child.has("a")
        assert not parent.has("b") and not child.has("z")
        with pytest.raises(KeyError):
            child.get("z")
        placed.append((sorted(parent.local.items()),
                       sorted(child.local.items()),
                       sorted(child.snapshot().items())))
    assert placed[0] == placed[1]
    assert placed[1][0] == [("a", 2), ("m", 0)]
    assert placed[1][1] == [("b", 2), ("c", 2), ("m", 2)]
