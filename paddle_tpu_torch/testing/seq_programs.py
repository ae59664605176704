"""Programs (d) and (e) of ``chip_smoke.py``'s ``[dense]``: a CRF tagger
and a CTC head on one bidirectional GRU encoder, built with the layers
of ``pkg``, a package with the fluid layer API (this one, or the JAX
package its tests hold it against).  Parameter names come from
``pkg.unique_name``, reset here, so a decode program built after a
training program names its weights alike."""
from __future__ import annotations


def encoder(pkg, words, vocab, emb, hidden):
    """``embedding``, a forward ``dynamic_gru`` over ``fc(3H)``, the
    backward one between two ``sequence_reverse``, ``concat`` on the
    features and ``row_conv(future_context_size=2)``."""
    L = pkg.layers
    e = L.embedding(words, size=[vocab, emb])
    fwd = L.dynamic_gru(L.fc(e, 3 * hidden, num_flatten_dims=2), hidden)
    rev = L.sequence_reverse(e)
    bwd = L.sequence_reverse(L.dynamic_gru(
        L.fc(rev, 3 * hidden, num_flatten_dims=2), hidden))
    return L.row_conv(L.concat([fwd, bwd], axis=2), future_context_size=2)


def build_crf_tagger(pkg, vocab, emb, hidden, n_types, decode=False,
                     lr=1e-3, momentum=0.9, seed=0):
    """(main, startup, vars) of program (d): the encoder over int64
    ``words`` (lod 1), ``fc`` to 2 n_types + 1 IOB tags, then
    ``linear_chain_crf`` against ``target`` with Transition ``crfw``,
    ``mean``, Momentum; or, with ``decode``, ``crf_decoding`` under
    ``crfw`` and ``evaluator.ChunkEvaluator`` over the path and
    ``target``.  ``vars``: emission, cost and loss, or path and the
    evaluator."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        L = pkg.layers
        words = L.data("words", shape=[], dtype="int64", lod_level=1)
        target = L.data("target", shape=[], dtype="int64", lod_level=1)
        em = L.fc(encoder(pkg, words, vocab, emb, hidden), 2 * n_types + 1,
                  num_flatten_dims=2)
        crfw = pkg.ParamAttr(name="crfw")
        if decode:
            path = L.crf_decoding(em, param_attr=crfw)
            ev = pkg.evaluator.ChunkEvaluator(path, target, "IOB", n_types)
            return main, startup, {"emission": em, "path": path,
                                   "evaluator": ev}
        cost = L.linear_chain_crf(em, target, param_attr=crfw)
        loss = L.mean(cost)
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(loss)
    return main, startup, {"emission": em, "cost": cost, "loss": loss}


def build_ctc_head(pkg, vocab, emb, hidden, lr=1e-3, momentum=0.9, seed=0):
    """(main, startup, vars) of program (e): the encoder of (d), ``fc``
    to the vocabulary, ``warpctc(blank=0)`` against ``lbl`` (lod 1),
    ``mean``, Momentum; and the decode: the per-position ``argmax``
    path, given the logits' lengths (``sequence_pad``'s Length through
    ``lod_reset``), and its ``edit_distance`` to ``lbl``.  ``vars``:
    logits, ctc (the per-row loss), loss, path, dist."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        L = pkg.layers
        words = L.data("words", shape=[], dtype="int64", lod_level=1)
        lbl = L.data("lbl", shape=[], dtype="int64", lod_level=1)
        logits = L.fc(encoder(pkg, words, vocab, emb, hidden), vocab,
                      num_flatten_dims=2)
        ctc = L.warpctc(logits, lbl, blank=0)
        loss = L.mean(ctc)
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(loss)
        helper = pkg.layer_helper.LayerHelper("ctc_decode")
        new = helper.create_variable_for_type_inference
        padded, length = new(logits.dtype), new("int32")
        helper.append_op(type="sequence_pad", inputs={"X": [logits]},
                         outputs={"Out": [padded], "Length": [length]})
        path = L.lod_reset(L.argmax(logits, axis=2), y=length)
        dist, num = new("float32"), new("int64")
        helper.append_op(type="edit_distance",
                         inputs={"Hyps": [path], "Refs": [lbl]},
                         outputs={"Out": [dist], "SequenceNum": [num]},
                         attrs={"normalized": False})
    return main, startup, {"logits": logits, "ctc": ctc, "loss": loss,
                           "path": path, "dist": dist}
