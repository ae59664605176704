"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
build the same model in the JAX package and in paddle_tpu_torch, and
move a JAX scope's persistables into a port scope."""
from __future__ import annotations

import paddle_tpu as pt
import paddle_tpu_torch as ptt


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
