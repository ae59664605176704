"""Float64 numpy oracles of the sequence family's recursions, written
from their definitions, for holding the port's ops on fetched operands
(``chip_smoke.py``'s ``[dense]`` (d) and (e), the CPU tests):

* :func:`crf_nll`: the linear-chain CRF's negative log-likelihood by the
  forward algorithm over each row's length;
* :func:`viterbi`: the best tag path and each row's smallest margin
  between a chosen and a rival score (a near-tie where it is small);
* :func:`ctc_nll`: the CTC loss by its alpha recursion in log space with
  -1e30 for log 0, so a label that cannot fit reads about 1e30;
* :func:`levenshtein`: the edit distance;
* :func:`chunk_counts`: the JAX package's simplified IOB chunk counts.

Transition is [D + 2, D]: row 0 the start scores, row 1 the end scores,
rows 2.. the score of tag j after tag i.
"""
from __future__ import annotations

import numpy as np

NEG = -1e30


def _lse(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(x - m), axis=axis,
                              keepdims=True))).squeeze(axis)


def crf_nll(em, trans, label, lens):
    """[B] float64: log Z - the gold path's score, each row over its
    first ``lens[b]`` >= 1 steps."""
    em, trans = np.asarray(em, np.float64), np.asarray(trans, np.float64)
    start, end, w = trans[0], trans[1], trans[2:]
    out = []
    for b in range(em.shape[0]):
        n = max(int(lens[b]), 1)
        e, y = em[b, :n], np.asarray(label[b, :n], np.int64)
        alpha = start + e[0]
        for t in range(1, n):
            alpha = _lse(alpha[:, None] + w, 0) + e[t]
        log_z = _lse(alpha + end, 0)
        gold = start[y[0]] + e[np.arange(n), y].sum() + end[y[-1]] \
            + w[y[:-1], y[1:]].sum()
        out.append(log_z - gold)
    return np.array(out)


def viterbi(em, trans, lens):
    """(paths [B, T] int64 with 0 past each length, margins [B]): each
    row's best path under the CRF scores, and the smallest gap between
    the best and the second-best candidate over its back pointers on
    the path and its last tag."""
    em, trans = np.asarray(em, np.float64), np.asarray(trans, np.float64)
    start, end, w = trans[0], trans[1], trans[2:]
    B, T, _ = em.shape
    paths = np.zeros((B, T), np.int64)
    margins = np.full(B, np.inf)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            continue
        score = start + em[b, 0]
        back, gaps = [], []
        for t in range(1, n):
            cand = score[:, None] + w
            back.append(np.argmax(cand, axis=0))
            top2 = np.sort(cand, axis=0)[-2:]
            gaps.append(top2[1] - top2[0])
            score = cand.max(axis=0) + em[b, t]
        final = score + end
        tag = int(np.argmax(final))
        top2 = np.sort(final)[-2:]
        gap = top2[1] - top2[0]
        paths[b, n - 1] = tag
        for t in range(n - 2, -1, -1):
            gap = min(gap, gaps[t][tag])
            tag = int(back[t][tag])
            paths[b, t] = tag
        margins[b] = gap
    return paths, margins


def ctc_nll(logits, label, in_lens, lab_lens, blank=0):
    """[B] float64: -log p(label | logits) by the CTC alpha recursion
    over each row's ``in_lens[b]`` steps, log 0 as -1e30."""
    out = []
    for b in range(len(in_lens)):
        n = int(in_lens[b])
        lp = np.asarray(logits[b, :max(n, 1)], np.float64)
        lp = lp - _lse(lp, -1)[:, None]
        lab = np.asarray(label[b, :int(lab_lens[b])], np.int64)
        ext = np.full(2 * len(lab) + 1, blank, np.int64)
        ext[1::2] = lab
        S = len(ext)
        skip = np.zeros(S, bool)
        skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
        alpha = np.full(S, NEG)
        alpha[:2] = lp[0, ext[:2]]
        for t in range(1, n):
            a1 = np.concatenate([[NEG], alpha[:-1]])
            a2 = np.where(skip, np.concatenate([[NEG, NEG], alpha[:-2]]),
                          NEG)
            alpha = _lse(np.stack([alpha, a1, a2]), 0) + lp[t, ext]
        out.append(-_lse(alpha[max(S - 2, 0):], 0))
    return np.array(out)


def levenshtein(hyp, ref):
    """The edit distance of two id sequences."""
    d = np.arange(len(ref) + 1)
    for i, x in enumerate(hyp):
        prev, d[0] = d[0], i + 1
        for j, y in enumerate(ref):
            prev, d[j + 1] = d[j + 1], min(d[j + 1] + 1, d[j] + 1,
                                           prev + (x != y))
    return int(d[len(ref)])


def chunk_counts(inf, label, lens, num_chunk_types):
    """(inferred, labelled, correct) chunk counts by the JAX package's
    simplified IOB rule: a chunk starts at an even tag below
    2 * num_chunk_types within the length; a correct chunk is a label
    start whose inferred tag is equal."""
    inf, label = np.asarray(inf), np.asarray(label)
    m = np.arange(label.shape[1])[None, :] < np.asarray(lens)[:, None]

    def starts(t):
        return (t % 2 == 0) & (t < 2 * num_chunk_types) & m

    return (int(starts(inf).sum()), int(starts(label).sum()),
            int((starts(label) & (inf == label)).sum()))
