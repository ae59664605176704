"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
build the same model in the JAX package and in paddle_tpu_torch, move a
JAX scope's persistables into a port scope, and run one op through both
packages' lowerings (``run_op``, ``check_op``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl
from paddle_tpu_torch.testing.op_cases import OneOp, seq_env  # noqa: F401
from paddle_tpu_torch.testing.seq_programs import (  # noqa: F401
    build_crf_tagger, build_ctc_head)


def reset_both():
    """Fresh default programs, scopes and name counters in both packages
    (the name counters must start equal for the programs to match)."""
    pt.core.reset_default_programs()
    pt.core.reset_global_scope()
    pt.unique_name.reset()
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def build(pkg, model, shape, seed=0, **kwargs):
    """(main, startup, pred) of ``pkg.models.<model>`` on an ``img`` feed
    of per-example ``shape``, with fresh name counters."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", list(shape))
        pred = getattr(pkg.models, model)(img, **kwargs)
    return main, startup, pred


def jax_state(scope):
    """{name: numpy array} of every value in a JAX scope."""
    return {k: scope.numpy(k) for k in scope.keys()}


def both(model, shape, **kwargs):
    """The same model built by both packages, JAX startup run on the CPU,
    its weights carried into a port scope.  Returns a dict of the
    programs (inference clones), fetch vars and scopes."""
    jm, js, jp = build(pt, model, shape, **kwargs)
    tm, ts, tp = build(ptt, model, shape, **kwargs)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    return {"jax": (jm.clone(for_test=True), jp, jscope),
            "torch": (tm.clone(for_test=True), tp, tscope)}


def both_built(builder):
    """``builder(pkg)`` -> (main, startup, vars) in both packages, the JAX
    startup run on the CPU and its scope carried into a port scope.
    Returns {"jax": (main, vars, scope), "torch": (main, vars, scope)}."""
    jm, js, jv = builder(pt)
    tm, ts, tv = builder(ptt)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    return {"jax": (jm, jv, jscope), "torch": (tm, tv, tscope)}


def build_train(pkg, model, shape, seed=0, lr=0.01, momentum=0.9,
                **kwargs):
    """(main, startup, pred, loss) of ``bench.py``'s training recipe on
    ``pkg.models.<model>``: mean cross entropy against an int64 ``label``
    feed, minimized by Momentum."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", list(shape))
        label = pkg.layers.data("label", [1], dtype="int64")
        pred = getattr(pkg.models, model)(img, **kwargs)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(loss)
    return main, startup, pred, loss


def both_train(model, shape, via_json=False, **kwargs):
    """The same training program in both packages (built by each, or with
    ``via_json`` the JAX one loaded into the port through its JSON form),
    the JAX startup run on the CPU, and its whole scope (params, BN
    statistics, velocities, learning rate) carried into a port scope.
    Returns {"jax": (main, loss, scope), "torch": (main, loss, scope)}."""
    jm, js, _, jl = build_train(pt, model, shape, **kwargs)
    if via_json:
        tm = ptt.Program.from_json(jm.to_json())
        tl = tm.global_block().var(jl.name)
    else:
        tm, _, _, tl = build_train(ptt, model, shape, **kwargs)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    return {"jax": (jm, jl, jscope), "torch": (tm, tl, tscope)}


def build_longctx(pkg, T, heads, dim, block=1024, causal=True, lr=1e-6,
                  interpret=False, seed=0):
    """(main, startup, loss) of ``benchmark/longctx.py``'s framework step
    (``:210-228``) in ``pkg``: three [heads, T, dim] parameters lc_q,
    lc_k, lc_v, ``layers.flash_attention`` over them, the loss
    ``scale(mean(o * o), 1e-3)`` and SGD.  ``interpret`` is the JAX
    op's Pallas-interpreter switch (the port records and ignores it)."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        helper = pkg.layer_helper.LayerHelper("lc")
        q, k, v = (helper.create_parameter(pkg.ParamAttr(name=f"lc_{n}"),
                                           shape=[heads, T, dim],
                                           dtype="float32")
                   for n in "qkv")
        o = pkg.layers.flash_attention(q, k, v, causal=causal,
                                       block_q=block, block_k=block,
                                       interpret=interpret)
        loss = pkg.layers.scale(
            pkg.layers.mean(pkg.layers.elementwise_mul(o, o)), 1e-3)
        pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss


def build_seq2seq(pkg, vocab, dim, lr=1e-2, seed=0):
    """(main, startup, loss) of ``bench.py``'s seq2seq leg (``:230-268``)
    in ``pkg``: ``models.seq2seq_attention`` over int64 ``src``/``tgt``
    sequences, reshape + cross entropy against ``lbl``, mean, Adam."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        L = pkg.layers
        src = L.data("src", shape=[], dtype="int64", lod_level=1)
        tgt = L.data("tgt", shape=[], dtype="int64", lod_level=1)
        lbl = L.data("lbl", shape=[], dtype="int64", lod_level=1)
        probs = pkg.models.seq2seq_attention(src, tgt, vocab, vocab,
                                             emb_dim=dim, hidden_dim=dim)
        flat = L.reshape(probs, [-1, vocab])
        loss = L.mean(L.cross_entropy(flat, L.reshape(lbl, [-1, 1])))
        pkg.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss


def build_resnet_cls(pkg, img, classes, counts=(3, 4, 6, 3),
                     filters=(64, 128, 256, 512), k=5, lr=0.01,
                     momentum=0.9, seed=0):
    """(main, startup, vars) of ResNet's bottleneck body
    (``models/resnet.py``'s ``conv_bn_layer`` and ``bottleneck_block``,
    ResNet-50 at the defaults) under the fluid classification head:
    ``fc`` logits, ``softmax_with_cross_entropy``, ``mean``, accuracy at
    k=1 and k through ``topk``, ``evaluator.Accuracy``, Momentum.
    ``vars``: loss, logits, acc1, acck, the top-k values and indices,
    and the evaluator."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        L, R = pkg.layers, pkg.models.resnet
        image = L.data("img", [3, img, img])
        label = L.data("label", [1], dtype="int64")
        h = R.conv_bn_layer(image, filters[0], 7, stride=2, padding=3)
        h = L.pool2d(h, pool_size=3, pool_stride=2, pool_padding=1,
                     pool_type="max")
        ch_in = filters[0]
        for stage, (nf, n) in enumerate(zip(filters, counts)):
            for i in range(n):
                h = R.bottleneck_block(h, ch_in, nf,
                                       2 if i == 0 and stage > 0 else 1)
                ch_in = nf * 4
        h = L.pool2d(h, pool_type="avg", global_pooling=True)
        logits = L.fc(h, size=classes)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        acc1 = L.accuracy(logits, label, k=1)
        acck = L.accuracy(logits, label, k=k)
        vals, idx = L.topk(logits, k)
        ev = pkg.evaluator.Accuracy(logits, label, k=1)
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(loss)
    return main, startup, {"loss": loss, "logits": logits, "acc1": acc1,
                           "acck": acck, "vals": vals, "idx": idx,
                           "evaluator": ev}


def build_decoder(pkg, vocab, T, d, heads, n_layers, ffn, block=1024,
                  lr=0.01, momentum=0.9, interpret=False, seed=0):
    """(main, startup, loss) of a GPT-style decoder in ``pkg``'s layers:
    token and position ``embedding``; each layer pre-``layer_norm``
    (eps 1e-5), ``fc`` Q/K/V reshaped to [B, T, heads, d / heads],
    causal ``flash_attention``, the output ``fc``, ``dropout`` 0 and the
    residual ``elementwise_add``, then a ``gelu`` FFN and its residual; a
    final ``layer_norm``, the vocabulary ``fc``,
    ``softmax_with_cross_entropy`` against ``tgt`` [B, T, 1] and
    ``mean``; Momentum.  ``interpret`` is the JAX attention op's
    Pallas-interpreter switch (the port records and ignores it)."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        L = pkg.layers
        tok = L.data("tok", [T], dtype="int64")
        pos = L.data("pos", [T], dtype="int64")
        tgt = L.data("tgt", [T, 1], dtype="int64")
        h = L.elementwise_add(L.embedding(tok, size=[vocab, d]),
                              L.embedding(pos, size=[T, d]))
        for _ in range(n_layers):
            x = L.layer_norm(h, begin_norm_axis=2, epsilon=1e-5)
            q, k, v = (L.reshape(L.fc(x, d, num_flatten_dims=2),
                                 [0, 0, heads, d // heads])
                       for _ in range(3))
            a = L.flash_attention(q, k, v, causal=True, block_q=block,
                                  block_k=block, interpret=interpret)
            a = L.fc(L.reshape(a, [0, 0, d]), d, num_flatten_dims=2)
            h = L.elementwise_add(h, L.dropout(a, dropout_prob=0.0))
            x = L.layer_norm(h, begin_norm_axis=2, epsilon=1e-5)
            f = L.fc(x, ffn, num_flatten_dims=2, act="gelu")
            h = L.elementwise_add(h, L.fc(f, d, num_flatten_dims=2))
        x = L.layer_norm(h, begin_norm_axis=2, epsilon=1e-5)
        logits = L.fc(x, vocab, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, tgt))
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(loss)
    return main, startup, loss


def _append(helper, op_type, inputs, dtype, shape, attrs=None,
            slots=("Out",)):
    """One op of a type with no layer of its own; returns its output
    vars of ``shape``, one a slot (an argsort's Indices int64)."""
    outs = {s: helper.create_variable_for_type_inference(
        "int64" if s == "Indices" else dtype, shape) for s in slots}
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [v] for s, v in outs.items()},
                     attrs=attrs or {})
    return [outs[s] for s in slots]


def build_sampler(pkg, vocab, T, d, heads, n_layers, ffn, batch,
                  top_p=0.9, block=1024, interpret=False, seed=0):
    """(main, startup, vars) of a GPT-style decoder's first sampled token
    under a top-p filter, in ``pkg``: token ``embedding`` plus a position
    ``embedding`` of ``range(0, T)`` reshaped to [1, T] and ``expand``-ed
    to [batch, T]; the layers of :func:`build_decoder` (no dropout); the
    vocabulary ``fc``; the last position's logits (``slice``), cast to
    fp32, and their ``softmax``; then the filter: ``argsort`` descending,
    ``cumsum``, the mass before each position (``elementwise_sub``)
    ``greater_equal`` ``top_p`` marks the tail, ``where`` zeroes it,
    ``sampling_id`` draws a sorted position over the kept mass, and
    ``one_hot`` x the sort's Indices, ``reduce_sum`` maps it back to a
    vocabulary id.  ``vars``: logits, probs, sorted, order, cum, before,
    tail, kept, pos (the sampled sorted position) and ids."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        L = pkg.layers
        tok = L.data("tok", [T], dtype="int64")
        pos = L.expand(L.reshape(L.range(0, T, 1), [1, T]), [batch, 1])
        h = L.elementwise_add(L.embedding(tok, size=[vocab, d]),
                              L.embedding(pos, size=[T, d]))
        for _ in range(n_layers):
            x = L.layer_norm(h, begin_norm_axis=2, epsilon=1e-5)
            q, k, v = (L.reshape(L.fc(x, d, num_flatten_dims=2),
                                 [0, 0, heads, d // heads])
                       for _ in range(3))
            a = L.flash_attention(q, k, v, causal=True, block_q=block,
                                  block_k=block, interpret=interpret)
            h = L.elementwise_add(h, L.fc(L.reshape(a, [0, 0, d]), d,
                                          num_flatten_dims=2))
            x = L.layer_norm(h, begin_norm_axis=2, epsilon=1e-5)
            f = L.fc(x, ffn, num_flatten_dims=2, act="gelu")
            h = L.elementwise_add(h, L.fc(f, d, num_flatten_dims=2))
        x = L.layer_norm(h, begin_norm_axis=2, epsilon=1e-5)
        logits = L.fc(x, vocab, num_flatten_dims=2)
        last = L.slice(logits, axes=[1], starts=[T - 1], ends=[T])
        probs = L.softmax(L.cast(L.reshape(last, [batch, vocab]),
                                 "float32"))
        helper = pkg.layer_helper.LayerHelper("top_p")
        bv = (batch, vocab)
        srt, order = _append(helper, "argsort", {"X": [probs]}, "float32",
                             bv, {"axis": -1, "descending": True},
                             ("Out", "Indices"))
        cum, = _append(helper, "cumsum", {"X": [srt]}, "float32", bv,
                       {"axis": -1})
        before = L.elementwise_sub(cum, srt)
        tail, = _append(helper, "greater_equal", {
            "X": [before], "Y": [L.fill_constant([1], "float32", top_p)]},
            "bool", bv)
        kept, = _append(helper, "where", {
            "Condition": [tail], "X": [L.zeros_like(srt)], "Y": [srt]},
            "float32", bv)
        s = L.sampling_id(kept)
        hot = L.cast(L.one_hot(L.reshape(s, [batch, 1]), vocab), "int64")
        ids = L.reduce_sum(L.elementwise_mul(hot, order), dim=1)
    return main, startup, {"logits": logits, "probs": probs, "sorted": srt,
                           "order": order, "cum": cum, "before": before,
                           "tail": tail, "kept": kept, "pos": s,
                           "ids": ids}


# ---------------------------------------------------------------------------
# One op through both packages' lowerings
# ---------------------------------------------------------------------------
# fp32: both compute in fp32, only the order of sums differs; bf16: within
# 2^-7 of the output's scale (its largest magnitude), a rounding or two
OP_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_SCALE = 2.0 ** -7
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _is_float(v):
    return np.asarray(v).dtype == np.float32


def _to_jax(v, dtype):
    return jnp.asarray(v, JDT[dtype]) if _is_float(v) else jnp.asarray(v)


def _to_torch(v, dtype):
    t = torch.from_numpy(np.array(v))
    return t.to(TDT[dtype]) if _is_float(v) else t


def _flat(outs):
    """[(slot, i, array)] of an op's outputs (a slot holds one array or a
    list)."""
    res = []
    for k in sorted(outs):
        vs = outs[k] if isinstance(outs[k], (list, tuple)) else [outs[k]]
        res += [(k, i, v) for i, v in enumerate(vs)]
    return res


def _lens_out(env):
    """The length companions an op set on its outputs, as outputs."""
    return {(k, 0): v for k, v in env.local.items()
            if k.endswith(("@LEN", "@LEN2")) and ".out@" in k}


def run_op(op, ins, attrs, dtype="float32", wrt=(), is_test=True,
           lens=None):
    """Run ``op`` through both packages: ({(slot, i): jax array},
    {(slot, i): torch tensor}, jax grads, torch grads).  The grads are of
    sum(out * cotangent) over the float outputs with respect to the
    inputs ``wrt`` ((slot, i) pairs).  ``lens`` gives the inputs' length
    companions (``seq_env``); the lengths the op sets on its outputs are
    among its outputs, keyed (``<slot>.out@LEN``, 0)."""
    one = OneOp(op, ins, attrs)
    jctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0),
                                   is_test=is_test)
    tctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                                is_test=is_test)
    jctx.op = tctx.op = one
    tctx.env = seq_env(ptt, lens, lambda v: torch.from_numpy(np.array(v)))
    jins = {k: [_to_jax(v, dtype) for v in vs] for k, vs in ins.items()}
    tins = {k: [_to_torch(v, dtype) for v in vs] for k, vs in ins.items()}

    @jax.jit
    def jrun(wvals):
        # one compiled function a case, in place of a compile for each
        # primitive's shapes
        d = {k: list(vs) for k, vs in jins.items()}
        for (k, i), w in zip(wrt, wvals):
            d[k][i] = w
        jctx.env = seq_env(pt, lens, jnp.asarray)
        out = {(k, i): v for k, i, v in
               _flat(jax_impl(op)(jctx, d, dict(attrs)))}
        out.update(_lens_out(jctx.env))
        return out

    if wrt:
        jout, pullback = jax.vjp(jrun, [jins[k][i] for k, i in wrt])
    else:
        jout = jrun([])
    leaves = [tins[k][i].clone().requires_grad_(True) for k, i in wrt]
    for (k, i), leaf in zip(wrt, leaves):
        tins[k][i] = leaf
    with torch.enable_grad():
        tout = {(k, i): v for k, i, v in
                _flat(torch_impl(op)(tctx, tins, dict(attrs)))}
    tout.update(_lens_out(tctx.env))
    jg, tg = [], []
    if wrt:
        r = np.random.RandomState(sum(map(ord, op + "cot")) % 1000)
        floats = [s for s, v in jout.items()
                  if jnp.issubdtype(v.dtype, jnp.floating)]
        cot = {s: np.asarray(r.randn(*jout[s].shape), np.float32)
               for s in floats}
        jcot = {s: jnp.asarray(cot[s], v.dtype) if s in cot else
                np.zeros(v.shape, jax.dtypes.float0)
                for s, v in jout.items()}
        jg = [np.asarray(g, np.float32) for g in pullback(jcot)[0]]
        tl = sum((tout[s].float() * torch.from_numpy(cot[s])).sum()
                 for s in floats)
        tg = [g.float().numpy() for g in
              torch.autograd.grad(tl, leaves, allow_unused=True)]
    return jout, tout, jg, tg


def close_to(t, j, dtype, what):
    """fp32 within ``OP_TOL``; bf16 within 2^-7 of the scale."""
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if dtype == "float32":
        np.testing.assert_allclose(t, j, err_msg=what, **OP_TOL)
    else:
        # infinities (a window wholly in padding) equal; the rest within
        # 2^-7 of the largest finite magnitude
        fin = np.isfinite(j)
        np.testing.assert_array_equal(t[~fin], j[~fin], err_msg=what)
        t, j = t[fin], j[fin]
        scale = max(float(np.max(np.abs(j))) if j.size else 0.0, 1e-6)
        err = float(np.max(np.abs(t - j))) if j.size else 0.0
        assert err <= BF16_SCALE * scale, (what, err, scale)


# outputs the JAX ops make int64, which JAX keeps as int32 without x64
# (ROADMAP Queue C); the port keeps int64
INT64_OUTS = {("top_k", "Indices"), ("argmax", "Out"), ("arg_max", "Out"),
              ("max_ids", "Out"), ("max_pool2d_with_index", "Mask"),
              ("pool2d_with_index", "Mask"), ("shape", "Out"),
              ("range", "Out"), ("argsort", "Indices"),
              ("sampling_id", "Out"), ("kmax_seq_score", "Out"),
              ("max_sequence_len", "Out"), ("crf_decoding", "ViterbiPath"),
              ("edit_distance", "SequenceNum"),
              ("chunk_eval", "NumInferChunks"),
              ("chunk_eval", "NumLabelChunks"),
              ("chunk_eval", "NumCorrectChunks"), ("nce", "SampleLabels"),
              ("roi_pool", "Argmax"), ("lod_array_length", "Out")}


def check_op(op, ins, attrs, dtype, wrt=(), **kw):
    """``run_op`` in ``dtype``: the same output slots and dtypes (int64
    in the port where JAX's int64 is int32), float outputs
    ``close_to``, the others exactly; in fp32 the gradients too."""
    jout, tout, jg, tg = run_op(op, ins, attrs, dtype,
                                wrt if dtype == "float32" else (), **kw)
    assert sorted(jout) == sorted(tout), (sorted(jout), sorted(tout))
    for s, j in jout.items():
        t = tout[s]
        want = "int64" if (op, s[0]) in INT64_OUTS and \
            j.dtype == jnp.int32 else str(jnp.dtype(j.dtype))
        assert want == str(t.dtype).replace("torch.", ""), \
            (op, s, j.dtype, t.dtype)
        if jnp.issubdtype(j.dtype, jnp.floating):
            close_to(t, j, dtype, f"{op} {s}")
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{op} {s}")
    for (k, i), j, t in zip(wrt, jg, tg):
        close_to(t, j, "float32", f"{op} d{k}[{i}]")


# ---------------------------------------------------------------------------
# Programs (d) and (e): a CRF tagger and a CTC head on one encoder
# (paddle_tpu_torch/testing/seq_programs.py, built in either package)
# ---------------------------------------------------------------------------
def seq_feed(r, batch, T, vocab, lo, hi, label_of=None):
    """``words`` [batch, T] int64 with ragged lengths in [lo, hi] and
    their ``@LEN`` (int32); ``label_of(r, lens)`` adds the labels."""
    lens = r.randint(lo, hi + 1, batch).astype(np.int32)
    words = r.randint(0, vocab, (batch, T)).astype(np.int64)
    feed = {"words": words, "words@LEN": lens}
    if label_of is not None:
        feed.update(label_of(r, lens))
    return feed
