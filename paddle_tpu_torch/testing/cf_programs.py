"""Programs (f) and (g) of ``chip_smoke.py``'s ``[dense]``: a greedy
decoder looped by ``While``, a ``DynamicRNN`` classifier over a rank
table with an ``IfElse`` head, and SSD's multibox head, built with the
layers of ``pkg``, a package with the fluid layer API (this one, or the
JAX package its tests hold it against).  Parameter names come from
``pkg.unique_name``, reset here, so a decode program built after a
training program names its weights alike."""
from __future__ import annotations

# SSD300's six source maps (Liu et al. 2016, VOC 300x300): (side,
# channels, min size, max size, aspect ratios); 4/6/6/6/4/4 boxes a cell
# with flip, 8732 priors
SSD300 = ((38, 512, 30.0, 60.0, (2.0,)), (19, 1024, 60.0, 111.0, (2.0, 3.0)),
          (10, 512, 111.0, 162.0, (2.0, 3.0)),
          (5, 256, 162.0, 213.0, (2.0, 3.0)), (3, 256, 213.0, 264.0, (2.0,)),
          (1, 256, 264.0, 315.0, (2.0,)))


def _fresh(pkg, seed):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    return main, startup


def build_greedy_decoder(pkg, vocab, dim, bos=0, seed=0):
    """(main, startup, vars) of (f)'s greedy decoder: the seq2seq model's
    encoder head (``models/seq2seq.py``) over ``src`` (int64, lod 1),
    then a ``While`` over ``limit`` (an int64 [1] feed) steps of its
    ``_decoder_step`` from ``bos``, each feeding back the argmax token,
    writing it into the array ``ids`` at the step and the step's top-2
    probabilities into the array ``tops``.  ``vars``: ids, tops (both
    ``[capacity, B, ...]``), steps (the counter), length
    (``array_length(ids)``)."""
    S = pkg.models.seq2seq
    main, startup = _fresh(pkg, seed)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        src = L.data("src", shape=[], dtype="int64", lod_level=1)
        limit = L.data("limit", shape=[1], dtype="int64",
                       append_batch_size=False)
        enc_out, enc_proj, state = S._encoder_head(src, vocab, dim, dim,
                                                   "s2s")
        i = L.fill_constant([1], "int64", 0)
        tok = L.fill_constant_batch_size_like(state, [-1], "int64", bos)
        ids = L.array_write(tok, i)
        tops = L.array_write(L.fill_constant_batch_size_like(
            state, [-1, 2], "float32", 0.0), i)
        cond = L.less_than(i, limit)
        loop = L.While(cond)
        with loop.block():
            emb = L.embedding(tok, size=[vocab, dim],
                              param_attr=pkg.ParamAttr(name="s2s.tgt_emb"))
            new_state, probs = S._decoder_step(emb, state, enc_out,
                                               enc_proj, dim, vocab, "s2s")
            top2, _ = L.topk(probs, 2)
            nxt = L.argmax(probs, axis=1)
            L.increment(i, 1.0)
            L.array_write(nxt, i, array=ids)
            L.array_write(top2, i, array=tops)
            L.assign(new_state, output=state)
            L.assign(nxt, output=tok)
            L.less_than(i, limit, cond=cond)
        length = L.array_length(ids)
    return main, startup, {"ids": ids, "tops": tops, "steps": i,
                           "length": length}


def build_drnn_classifier(pkg, vocab, emb, hidden, classes, lr=1e-3,
                          momentum=0.9, seed=0):
    """(main, startup, vars) of (f)'s classifier: ``words`` (int64, lod 1)
    embedded, their rows put in descending order of length by
    ``lod_rank_table`` and ``reorder_lod_tensor_by_rank`` (the labels
    too), a ``DynamicRNN`` of ``gru_unit`` over ``fc(3H)``, the last
    step, and an ``IfElse`` head: rows whose state sums below 0 take one
    fc, the others another; softmax_with_cross_entropy, mean, Momentum.
    ``vars``: loss, rank, logits."""
    main, startup = _fresh(pkg, seed)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        words = L.data("words", shape=[], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        e = L.embedding(words, size=[vocab, emb])
        rank = L.lod_rank_table(e)
        e = L.reorder_lod_tensor_by_rank(e, rank)
        label = L.reorder_lod_tensor_by_rank(label, rank)
        proj = L.fc(e, 3 * hidden, num_flatten_dims=2)
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(proj)
            h = drnn.memory(shape=[hidden])
            h_new, _, _ = L.gru_unit(x_t, h, size=3 * hidden)
            drnn.update_memory(h, h_new)
            drnn.output(h_new)
        last = L.sequence_last_step(drnn())
        cond = L.less_than(L.reduce_sum(last, dim=1, keep_dim=True),
                           L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(ie.input(last), classes))
        with ie.false_block():
            ie.output(L.fc(ie.input(last), classes, act="tanh"))
        logits = ie()
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(loss)
    return main, startup, {"loss": loss, "rank": rank, "logits": logits}


def ssd_boxes_per_cell(ars):
    """Priors a cell of a map with aspect ratios ``ars`` (flipped) and one
    min and one max size."""
    return 2 + 2 * len([a for a in ars if a != 1.0])


def build_ssd_head(pkg, maps, classes, gt_rows, image, batch=None,
                   decode=False, lr=1e-3, momentum=0.9, seed=0, nms=None):
    """(main, startup, vars) of (g): SSD's multibox head over fed source
    maps ``map<i>`` ([channels, side, side] each, ``maps`` as
    ``SSD300``), priors from each map against ``image`` ([3, image,
    image], only its shape is read); a 3x3 conv each for the boxes'
    encodings and the classes' logits, transposed to [N, priors, 4] and
    [N, priors, classes] and concatenated over the maps.  Training:
    ``ssd_loss`` against padded ground truth ``gtb`` [gt_rows, 4] and
    ``gtl`` [gt_rows] (-1 on pad rows), mean, Momentum.  ``decode``:
    the softmax of the logits, ``box_coder`` of the encodings against
    the priors (tiled over ``batch`` images) and ``detection_output``
    with ``nms`` (its keyword arguments).  ``vars``: loss, loc, conf,
    prior, pvar; decode: scores, boxes, det."""
    main, startup = _fresh(pkg, seed)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        img = L.data("image", shape=[3, image, image])
        locs, confs, priors, pvars = [], [], [], []
        for i, (side, ch, mn, mx, ars) in enumerate(maps):
            fm = L.data(f"map{i}", shape=[ch, side, side])
            nb = ssd_boxes_per_cell(ars)
            boxes, var = L.prior_box(fm, img, min_sizes=[mn], max_sizes=[mx],
                                     aspect_ratios=list(ars), flip=True,
                                     clip=True)
            loc = L.conv2d(fm, nb * 4, 3, padding=1)
            conf = L.conv2d(fm, nb * classes, 3, padding=1)
            locs.append(L.reshape(L.transpose(loc, [0, 2, 3, 1]),
                                  [0, -1, 4]))
            confs.append(L.reshape(L.transpose(conf, [0, 2, 3, 1]),
                                   [0, -1, classes]))
            priors.append(L.reshape(boxes, [-1, 4]))
            pvars.append(L.reshape(var, [-1, 4]))
        loc = L.concat(locs, axis=1)
        conf = L.concat(confs, axis=1)
        prior = L.concat(priors, axis=0)
        pvar = L.concat(pvars, axis=0)
        out = {"loc": loc, "conf": conf, "prior": prior, "pvar": pvar}
        if decode:
            scores = L.softmax(conf)
            tile = [batch, 1, 1]
            boxes = L.box_coder(L.expand(L.unsqueeze(prior, [0]), tile),
                                L.expand(L.unsqueeze(pvar, [0]), tile), loc)
            det = L.detection_output(scores, boxes, **(nms or {}))
            out.update(scores=scores, boxes=boxes, det=det)
            return main, startup, out
        gtb = L.data("gtb", shape=[gt_rows, 4])
        gtl = L.data("gtl", shape=[gt_rows], dtype="int64")
        out["loss"] = L.mean(L.ssd_loss(loc, conf, gtb, gtl, prior,
                                        prior_box_var=pvar))
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=momentum).minimize(out["loss"])
    return main, startup, out


def ssd_ground_truth(rng, batch, gt_rows, classes=21):
    """Padded ground truth made from ``rng``: image i holds 1 + i %
    gt_rows boxes (corner form, sides 0.1-0.6 of the image) with labels
    in 1 to classes - 1 (0 is the background); the rest are pad rows
    (label -1, box 0)."""
    import numpy as np
    lo = rng.uniform(0.0, 0.4, (batch, gt_rows, 2))
    side = rng.uniform(0.1, 0.6, (batch, gt_rows, 2))
    hi = np.minimum(lo + side, 1.0)
    gtb = np.concatenate([lo, hi], axis=2).astype(np.float32)
    gtl = rng.randint(1, classes, (batch, gt_rows)).astype(np.int64)
    pad = np.arange(gt_rows)[None, :] >= 1 + np.arange(batch)[:, None] \
        % gt_rows
    gtl[pad] = -1
    gtb[pad] = 0.0
    return gtb, gtl
