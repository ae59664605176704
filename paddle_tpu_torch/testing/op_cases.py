"""Operands of the tensor, math, sequence, CRF and embedding op
families, made with numpy from a seed, for holding an op against another
implementation of it: the JAX lowering on the CPU
(``tests/test_torch_tensor_math_ops.py``, ``test_torch_sequence_ops.py``,
``test_torch_crf_ops.py``) or the port's own op on another device
(``chip_smoke.py``'s ``[dense]``).

* :data:`CASES` maps a case name (the op name, or ``op[variant]``) to a
  function of a ``numpy.random.RandomState`` giving ``(op, ins, attrs,
  wrt)``: the input slots as lists of numpy arrays, the attrs, and the
  (slot, index) pairs of the float inputs the op is differentiable in.
  The cases hold the ties and edges the ops must get right: equal values
  for ``argsort`` and the comparisons, duplicate ids for ``scatter``,
  negative operands for ``elementwise_mod``, a symbolic (-1) size for
  ``crop``, an empty tensor for ``is_empty``.
* :data:`RANDOM_CASES` maps each random op to ``(op, ins, attrs)`` sized
  for a statistic, and :func:`check_random` holds a draw to its
  distribution: the bounds and moments of ``truncated_gaussian_random``,
  a chi-square of ``sampling_id``'s draws against the row's
  probabilities, ``shuffle``'s output a permutation of its rows with
  each row's position uniform.
* :data:`TIED_TOP_K` is ``top_k`` on tied rows with ``lax.top_k``'s
  ``Indices`` (the lower index first among equal values).
* :data:`SEQ_CASES` holds the sequence, CRF and embedding families' ops
  with their ``@LEN`` companions (lengths 0, 1 and T, ties for
  ``kmax_seq_score`` and ``crf_decoding``, a CTC label that cannot fit),
  which :func:`run_port` runs through the port's op; ``nce`` draws, so
  :func:`nce_case` and :func:`check_nce` hold a draw to its bounds and
  to its cost recomputed from the drawn samples.
"""
from __future__ import annotations

import math

import numpy as np


def rng(name: str) -> np.random.RandomState:
    """The case's own seed."""
    return np.random.RandomState(sum(map(ord, name)) % 1000)


def _f(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


def _away_from_int(v, gap=0.05):
    """v with every value within ``gap`` of an integer moved off it."""
    near = np.abs(v - np.round(v)) < gap
    return np.where(near, v + 2 * gap, v).astype(np.float32)


X = [("X", 0)]
XY = [("X", 0), ("Y", 0)]


def _unary(op, shape=(3, 4, 5), attrs=None, wrt=True):
    def case(r):
        return op, {"X": [_f(r, *shape)]}, dict(attrs or {}), \
            X if wrt else []
    return case


def _binary(op, x, y, attrs=None, wrt=XY):
    def case(r):
        return op, {"X": [x(r)], "Y": [y(r)]}, dict(attrs or {}), wrt
    return case


def _tied(r, *shape):
    """Floats with many ties: a few values, half-integers, shuffled."""
    return (r.randint(-3, 4, shape) * 0.5).astype(np.float32)


def _assign_value(r):
    return "assign_value", {}, {"values": [1.5, -2.0, 3.25, 0.5, 7.0, -1.0],
                                "dtype": "float32", "shape": [2, 3]}, []


def _assign_value_int(r):
    return "assign_value", {}, {"values": [3, 1, 2, 9], "dtype": "int32"}, []


def _scatter(overwrite):
    def case(r):
        # row 1 written twice: an overwrite keeps the later update
        return "scatter", {"X": [_f(r, 6, 3)],
                           "Ids": [np.array([1, 4, 1, 0], np.int64)],
                           "Updates": [_f(r, 4, 3)]}, \
            {"overwrite": overwrite}, [("X", 0), ("Updates", 0)]
    return case


def _multiplex(r):
    return "multiplex", {"X": [_f(r, 5, 3) for _ in range(3)],
                         "Ids": [np.array([[2], [0], [1], [1], [0]],
                                          np.int64)]}, {}, \
        [("X", 0), ("X", 1), ("X", 2)]


def _argsort(descending):
    def case(r):
        return "argsort", {"X": [_tied(r, 3, 9)]}, \
            {"axis": -1, "descending": descending}, X
    return case


def _where(op):
    def case(r):
        return op, {"Condition": [r.rand(3, 4) > 0.5], "X": [_f(r, 3, 4)],
                    "Y": [_f(r, 3, 4)]}, {}, XY
    return case


def _mod_ints(r):
    return "elementwise_mod", {
        "X": [r.randint(-9, 10, (3, 5)).astype(np.int32)],
        "Y": [(np.where(r.rand(3, 5) > 0.5, 1, -1)
               * r.randint(1, 5, (3, 5))).astype(np.int32)]}, {}, []


def _mod(r):
    x = _f(r, 3, 5, scale=4.0)
    y = (np.where(r.rand(3, 5) > 0.5, 1.0, -1.0)
         * (r.rand(3, 5) + 0.5)).astype(np.float32)
    # away from the steps of floor(x / y)
    x = (_away_from_int(x / y) * y).astype(np.float32)
    return "elementwise_mod", {"X": [x], "Y": [y]}, {}, XY


def _compare(op):
    def case(r):
        return op, {"X": [_tied(r, 3, 4)], "Y": [_tied(r, 3, 4)]}, {}, []
    return case


def _compare_axis(op):
    def case(r):
        return op, {"X": [r.randint(0, 3, (2, 3, 4)).astype(np.int64)],
                    "Y": [r.randint(0, 3, (3,)).astype(np.int64)]}, \
            {"axis": 1}, []
    return case


def _logical(op, unary=False):
    def case(r):
        ins = {"X": [r.rand(3, 5) > 0.5]}
        if not unary:
            ins["Y"] = [r.rand(3, 5) > 0.5]
        return op, ins, {}, []
    return case


def _isfinite(bad):
    def case(r):
        x = _f(r, 3, 4)
        if bad is not None:
            x[1, 2] = bad
        return "isfinite", {"X": [x]}, {}, []
    return case


def _conv_shift(r):
    return "conv_shift", {"X": [_f(r, 3, 7)], "Y": [_f(r, 3, 3)]}, {}, XY


def _interpolation(r):
    return "interpolation", {"W": [r.rand(4, 1).astype(np.float32)],
                             "X": [_f(r, 4, 5)], "Y": [_f(r, 4, 5)]}, {}, \
        [("W", 0), ("X", 0), ("Y", 0)]


def _fm(r):
    return "factorization_machine", {"X": [_f(r, 4, 6)],
                                     "V": [_f(r, 6, 3, scale=0.5)]}, {}, \
        [("X", 0), ("V", 0)]


def _scale_sub_region(r):
    return "scale_sub_region", {
        "X": [_f(r, 2, 3, 5, 6)],
        "Indices": [np.array([[1, 2, 2, 4, 1, 3], [2, 3, 1, 5, 4, 6]],
                             np.int32)]}, {"value": 2.5}, X


def _positive(r, *shape):
    return (r.rand(*shape) + 0.5).astype(np.float32)


CASES = {
    # tensor_ops.py
    "feed": _unary("feed", (3, 4)),
    "fetch": _unary("fetch", (3, 4)),
    "assign": _unary("assign"),
    "assign_value": _assign_value,
    "assign_value[int32]": _assign_value_int,
    "shape": _unary("shape", (2, 3, 5), wrt=False),
    "fill_zeros_like": _unary("fill_zeros_like", wrt=False),
    "fill_any_like": _unary("fill_any_like", attrs={"value": 2.5},
                            wrt=False),
    "pad": lambda r: ("pad", {"X": [_f(r, 2, 3, 4)]},
                      {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5}, X),
    # a -1 size is a symbolic dim: to the end of the axis
    "crop": lambda r: ("crop", {"X": [_f(r, 4, 5, 6)]},
                       {"shape": [-1, 3, 4], "offsets": [1, 1, 2]}, X),
    "expand": lambda r: ("expand", {"X": [_f(r, 2, 1, 3)]},
                         {"expand_times": [2, 3, 1]}, X),
    "tile": lambda r: ("tile", {"X": [_f(r, 2, 3)]},
                       {"repeat_times": [2, 1, 2]}, X),
    "slice": lambda r: ("slice", {"Input": [_f(r, 4, 6, 5)]},
                        {"axes": [1, 2], "starts": [1, -3],
                         "ends": [4, 100]}, [("Input", 0)]),
    "slice[X]": lambda r: ("slice", {"X": [_f(r, 4, 6)]},
                           {"axes": [0], "starts": [2], "ends": [-1]}, X),
    "scatter": _scatter(True),
    "scatter[accumulate]": _scatter(False),
    "multiplex": _multiplex,
    "argsort": _argsort(False),
    "argsort[descending]": _argsort(True),
    "range": lambda r: ("range", {}, {"start": 2, "end": 11, "step": 3},
                        []),
    "range[float32]": lambda r: ("range", {}, {"start": 0.5, "end": 2.0,
                                               "step": 0.25,
                                               "dtype": "float32"}, []),
    "flatten": _unary("flatten", (2, 3, 4), {"axis": 2}),
    "stack": lambda r: ("stack", {"X": [_f(r, 3, 4), _f(r, 3, 4)]},
                        {"axis": 1}, [("X", 0), ("X", 1)]),
    "unstack": _unary("unstack", (3, 2, 4), {"axis": 1}),
    "where": _where("where"),
    "select": _where("select"),
    "is_empty": lambda r: ("is_empty", {"X": [np.zeros((0, 3),
                                                      np.float32)]}, {}, []),
    "is_empty[full]": _unary("is_empty", (2, 3), wrt=False),
    "reverse": _unary("reverse", attrs={"axis": [0, 2]}),
    # math_ops.py
    "elementwise_pow": _binary("elementwise_pow", lambda r: _positive(r, 3, 4),
                               lambda r: _f(r, 3, 4)),
    "elementwise_pow[axis]": _binary(
        "elementwise_pow", lambda r: _positive(r, 2, 3, 4),
        lambda r: _f(r, 3), {"axis": 1}),
    "elementwise_mod": _mod,
    "elementwise_mod[int32]": _mod_ints,
    "minus": _binary("minus", lambda r: _f(r, 3, 4), lambda r: _f(r, 3, 4)),
    "equal": _compare("equal"),
    "equal[axis]": _compare_axis("equal"),
    "not_equal": _compare("not_equal"),
    "greater_than": _compare("greater_than"),
    "greater_equal": _compare("greater_equal"),
    "less_equal": _compare("less_equal"),
    "logical_and": _logical("logical_and"),
    "logical_or": _logical("logical_or"),
    "logical_xor": _logical("logical_xor"),
    "logical_not": _logical("logical_not", unary=True),
    "abs_diff": _binary("abs_diff", lambda r: _f(r, 3, 4),
                        lambda r: _f(r, 3, 4)),
    "squared_difference": _binary("squared_difference",
                                  lambda r: _f(r, 3, 4),
                                  lambda r: _f(r, 4)),
    "cumsum": _unary("cumsum", (3, 6), {"axis": 1}),
    "cumsum[int32]": lambda r: ("cumsum", {"X": [r.randint(
        -5, 6, (3, 6)).astype(np.int32)]}, {"axis": 0}, []),
    "isfinite": _isfinite(None),
    "isfinite[inf]": _isfinite(np.inf),
    "isfinite[nan]": _isfinite(np.nan),
    "l2_normalize": _unary("l2_normalize", (3, 5), {"axis": 1,
                                                    "epsilon": 1e-12}),
    "norm": _unary("norm", (3, 4, 2), {"axis": 1, "epsilon": 1e-10}),
    "conv_shift": _conv_shift,
    "interpolation": _interpolation,
    "outer_prod": _binary("outer_prod", lambda r: _f(r, 3, 4),
                          lambda r: _f(r, 3, 5)),
    "factorization_machine": _fm,
    "scale_sub_region": _scale_sub_region,
}


# ---------------------------------------------------------------------------
# The random ops: a draw against its distribution
# ---------------------------------------------------------------------------
def _sampling_probs():
    """8 rows over 6 classes, one with a zero-probability class."""
    r = np.random.RandomState(7)
    p = r.rand(8, 6) + 0.05
    p[3, 2] = 0.0
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


RANDOM_CASES = {
    "truncated_gaussian_random": ("truncated_gaussian_random", {},
                                  {"shape": [256, 512], "mean": 0.5,
                                   "std": 2.0, "dtype": "float32"}),
    # each row drawn 4096 times: the rows repeated
    "sampling_id": ("sampling_id",
                    {"X": [np.repeat(_sampling_probs(), 4096, axis=0)]}, {}),
    "shuffle": ("shuffle", {"X": [np.arange(16 * 3, dtype=np.float32)
                                  .reshape(16, 3)]}, {}),
}

# the truncated standard normal's moments: the cut at +-2 std
_PDF2 = math.exp(-2.0) / math.sqrt(2.0 * math.pi)
_MASS2 = math.erf(2.0 / math.sqrt(2.0))
TRUNC_STD = math.sqrt(1.0 - 4.0 * _PDF2 / _MASS2)
# chi-square limits at p = 1e-6 (a false alarm in a million runs), by
# degrees of freedom: 6 classes, 5 live classes, 16 positions
CHI2_LIMIT = {5: 35.89, 4: 33.38, 15: 56.49}


def check_random(name, outs, ins, attrs):
    """Hold one draw of ``RANDOM_CASES[name]`` (``outs``: the op's
    outputs, numpy) to its distribution; returns a line of the
    statistics, raises ``ValueError`` outside the limits."""
    if name == "truncated_gaussian_random":
        out = outs["Out"].astype(np.float64)
        mean, std = attrs["mean"], attrs["std"]
        z = (out - mean) / std
        n = z.size
        # the sample mean and std within 6 standard errors
        m_lim = 6 * TRUNC_STD / math.sqrt(n)
        s_lim = 6 * TRUNC_STD / math.sqrt(2 * n) * 1.5
        stats = (f"|z| max {np.abs(z).max():.6f} (< 2), mean "
                 f"{z.mean():+.5f} (limit {m_lim:.5f}), std {z.std():.5f} "
                 f"(want {TRUNC_STD:.5f} +- {s_lim:.5f})")
        if outs["Out"].shape != tuple(attrs["shape"]) or \
                not np.abs(z).max() < 2.0 or abs(z.mean()) > m_lim or \
                abs(z.std() - TRUNC_STD) > s_lim:
            raise ValueError(f"truncated_gaussian_random: {stats}")
        return stats
    if name == "sampling_id":
        ids = outs["Out"]
        p = _sampling_probs()
        rows, draws = p.shape[0], ids.size // p.shape[0]
        ids = ids.reshape(rows, draws)
        counts = np.stack([np.bincount(ids[i], minlength=p.shape[1])
                           for i in range(rows)])
        live = p > 0
        expect = p * draws
        chi2 = ((counts - expect) ** 2 / np.where(live, expect, 1))[live]
        per_row = [float(((counts[i] - expect[i]) ** 2
                          / np.where(live[i], expect[i], 1))[live[i]].sum())
                   for i in range(rows)]
        stats = (f"{rows} rows x {draws} draws, chi-square a row "
                 f"{[round(c, 2) for c in per_row]}, zero-probability "
                 f"draws {int(counts[~live].sum())}")
        bad = any(c > CHI2_LIMIT[int(live[i].sum()) - 1]
                  for i, c in enumerate(per_row))
        if bad or counts[~live].any() or ids.min() < 0 or \
                ids.max() >= p.shape[1] or not np.isfinite(chi2).all():
            raise ValueError(f"sampling_id: {stats}")
        return stats
    if name == "shuffle":
        out, x = outs["Out"], ins["X"][0]
        rows = x.shape[0]
        src = (out[:, 0] // x.shape[1]).astype(np.int64)
        if sorted(src.tolist()) != list(range(rows)) or \
                not np.array_equal(out, x[src]):
            raise ValueError(f"shuffle: the output is not a permutation "
                             f"of X's rows: {src.tolist()}")
        return f"a permutation of the {rows} rows: {src.tolist()}"
    raise KeyError(name)


def shuffle_positions(perms):
    """Chi-square of the position of row 0 over many ``shuffle`` draws
    (a list of permutations): uniform over the positions.  Returns (the
    statistic, its limit)."""
    perms = np.asarray(perms)
    n = perms.shape[1]
    pos = np.argmax(perms == 0, axis=1)
    counts = np.bincount(pos, minlength=n)
    expect = len(perms) / n
    return float(((counts - expect) ** 2 / expect).sum()), \
        CHI2_LIMIT[n - 1]


# ---------------------------------------------------------------------------
# top_k on tied rows, with lax.top_k's Indices
# ---------------------------------------------------------------------------
TIED_TOP_K = [
    # (X, k, the JAX Indices)
    (np.array([[1, 2, 2, 1, 0, 2], [0, 0, 0, 0, 0, 0]], np.float32), 3,
     np.array([[1, 2, 5], [0, 1, 2]], np.int64)),
    (np.zeros((1, 7), np.float32), 1, np.array([[0]], np.int64)),
    (np.array([[-1.5, 3.0, -1.5, 3.0, 3.0, -0.0, 0.0, 2.0]], np.float32), 5,
     np.array([[1, 3, 4, 7, 6]], np.int64)),   # +0.0 above -0.0
]


# ---------------------------------------------------------------------------
# The sequence, CRF and embedding families: cases with length companions
# ---------------------------------------------------------------------------
class _Outputs(dict):
    """An op's output names: ``<slot>.out`` for any slot asked for."""

    def __missing__(self, slot):
        return [f"{slot}.out"]


class OneOp:
    """The op a case runs as (``ctx.op``): input ``slot``[i] is named
    ``<slot>.<i>``, and any output slot it asks for exists."""

    def __init__(self, op, ins, attrs):
        self.type = op
        self.inputs = {k: [f"{k}.{i}" for i in range(len(vs))]
                       for k, vs in ins.items()}
        self.outputs = _Outputs()
        self.attrs = dict(attrs)


def seq_env(pkg, lens, to):
    """An env of ``pkg`` (either package) holding the sequence lengths
    ``lens``: {(slot, i): [B] lengths, (slot, i, 2): [B, S] nested
    lengths} as the ``@LEN``/``@LEN2`` companions of input ``slot``[i],
    each made by ``to``."""
    env = pkg.core.Env(pkg.Program().global_block())
    for key, v in (lens or {}).items():
        env.local[f"{key[0]}.{key[1]}@LEN" + ("2" if len(key) == 3
                                              else "")] = to(v)
    return env


def run_port(op, ins, attrs, lens=None, device="cpu"):
    """The port's ``op`` on numpy (or CPU tensor) operands and lengths on
    ``device``: {slot: [tensors]}, the lengths it sets on its outputs
    among them as ``<slot>.out@LEN``."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core.registry import get_op_impl

    def to(v):
        return (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)

    ctx = ptt.core.ExecContext(ptt.Program(), torch.device(device), 0)
    ctx.op = OneOp(op, ins, attrs)
    ctx.env = seq_env(ptt, lens, to)
    out = get_op_impl(op)(ctx, {k: [to(x) for x in xs]
                                for k, xs in ins.items()}, dict(attrs))
    out = {k: (list(x) if isinstance(x, (list, tuple)) else [x])
           for k, x in out.items()}
    out.update({k: [v] for k, v in ctx.env.local.items()
                if ".out@LEN" in k})
    return out


# lengths 0, 1 and T among ragged ones (T = 6)
LENS = np.array([6, 1, 0, 4], np.int32)
LENS_NONEMPTY = np.array([6, 1, 3, 4], np.int32)


def _half(r, *shape, lo=-4, hi=4):
    """Half-integers in [lo, hi]: every sum of a few of them is exact in
    bf16, so a max or an argmax over them is the same in any order."""
    return (r.randint(2 * lo, 2 * hi + 1, shape) * 0.5).astype(np.float32)


def _seq(op, shape=(4, 6, 3), attrs=None, lens=LENS, slot="X"):
    def case(r):
        return op, {slot: [_f(r, *shape)]}, dict(attrs or {}), \
            [(slot, 0)], {(slot, 0): lens}
    return case


def _softmax(lens, shape=(4, 6)):
    def case(r):
        return "sequence_softmax", {"X": [_f(r, *shape)]}, {}, X, \
            {("X", 0): lens}
    return case


def _expand(op, x_shape, y_shape):
    def case(r):
        return op, {"X": [_f(r, *x_shape)], "Y": [_f(r, *y_shape)]}, {}, \
            X, {("Y", 0): LENS}
    return case


def _concat(r):
    return "sequence_concat", {"X": [_f(r, 4, 5, 3), _f(r, 4, 4, 3)]}, \
        {"axis": 0}, [("X", 0), ("X", 1)], \
        {("X", 0): np.array([5, 1, 0, 3], np.int32),
         ("X", 1): np.array([2, 4, 3, 0], np.int32)}


def _context(pad_w):
    def case(r):
        ins = {"X": [_f(r, 4, 6, 3)]}
        wrt = [("X", 0)]
        if pad_w:
            # begin_pad 2 (contextStart -2) + end_pad 1
            ins["PadW"] = [_f(r, 3, 3)]
            wrt.append(("PadW", 0))
        return "sequence_context", ins, {"contextLength": 4,
                                         "contextStart": -2}, wrt, \
            {("X", 0): LENS}
    return case


def _sub_nested(r):
    # [B=3, S=4, T=5, D=2]; an index -1 (kmax_seq_score's pad) and one
    # past S select nothing
    return "sub_nested_seq", {
        "X": [_f(r, 3, 4, 5, 2)],
        "Selection": [np.array([[2, 0], [1, -1], [3, 4]], np.int64)]}, {}, \
        X, {("X", 0): np.array([4, 2, 4], np.int32),
            ("X", 0, 2): np.array([[5, 3, 1, 2], [4, 5, 0, 0],
                                   [1, 2, 3, 4]], np.int32)}


def _dyn_filter(shared):
    def case(r):
        w = _f(r, 4 * 3 * 3 * 3) if shared else _f(r, 2, 4 * 3 * 3 * 3)
        return "conv2d_dynamic_filter", {"Input": [_f(r, 2, 3, 5, 5)],
                                         "Filter": [w]}, \
            {"filter_shape": [4, 3, 3, 3], "strides": [1, 1],
             "paddings": [1, 1]}, [("Input", 0), ("Filter", 0)], {}
    return case


def _slice(r):
    return "sequence_slice", {
        "X": [_f(r, 4, 6, 2)],
        "Offset": [np.array([[1], [0], [2], [0]], np.int64)],
        "Length": [np.array([[3], [1], [0], [6]], np.int64)]}, {}, X, \
        {("X", 0): LENS}


def _unpad(r):
    return "sequence_unpad", {"X": [_f(r, 4, 6, 3)],
                              "Length": [np.array([3, 6, 0, 1],
                                                  np.int32)]}, {}, X, {}


def _lod_reset(with_y):
    def case(r):
        ins = {"X": [_f(r, 4, 6, 2)]}
        attrs = {"target_lod": [] if with_y else [0, 6, 7, 7, 11]}
        if with_y:
            ins["Y"] = [np.array([2, 6, 0, 5], np.int32)]
        return "lod_reset", ins, attrs, X, {("X", 0): LENS}
    return case


def _row_conv(r):
    return "row_conv", {"X": [_f(r, 4, 6, 3)], "Filter": [_f(r, 3, 3)]}, \
        {}, [("X", 0), ("Filter", 0)], {("X", 0): LENS}


def _kmax(k, shape=(4, 6)):
    def case(r):
        # ties: [1, 2, 2, 1, ...] ranks 1, 2 then 0 (the lower first)
        x = _tied(r, *shape)
        x[0, :4] = [1.0, 2.0, 2.0, 1.0]
        return "kmax_seq_score", {"X": [x]}, {"beam_size": k}, [], \
            {("X", 0): LENS}
    return case


def _max_len(with_lens):
    def case(r):
        return "max_sequence_len", {"X": [_f(r, 4, 6, 2)]}, {}, [], \
            {("X", 0): LENS} if with_lens else {}
    return case


def _lstm_unit(r):
    return "lstm_unit", {"X": [_f(r, 4, 12)], "C_prev": [_f(r, 4, 3)]}, \
        {"forget_bias": 1.0}, [("X", 0), ("C_prev", 0)], {}


def _crf(r):
    return "linear_chain_crf", {
        "Emission": [_f(r, 4, 6, 5)], "Transition": [_f(r, 7, 5, scale=0.5)],
        "Label": [r.randint(0, 5, (4, 6)).astype(np.int64)]}, {}, \
        [("Emission", 0), ("Transition", 0)], {("Emission", 0): LENS}


def _decode(variant):
    def case(r):
        T = 1 if variant == "T1" else 6
        if variant == "ties":
            # zeros and ones: most steps tie between several tags
            em = r.randint(0, 2, (4, T, 5)).astype(np.float32)
            tr = r.randint(0, 2, (7, 5)).astype(np.float32)
        else:
            em, tr = _half(r, 4, T, 5), _half(r, 7, 5, lo=-2, hi=2)
        ins = {"Emission": [em], "Transition": [tr]}
        if variant == "label":
            ins["Label"] = [r.randint(0, 5, (4, T)).astype(np.int64)]
        lens = np.minimum(LENS, T).astype(np.int32)
        return "crf_decoding", ins, {}, [], {("Emission", 0): lens}
    return case


def _ctc(norm):
    def case(r):
        # labels in 1..5 (0 is the blank), -1 pads; row 2's three labels
        # (one repeat: 4 steps needed) cannot fit in its 2 steps
        label = np.array([[1, 2, 2], [3, -1, -1], [4, 1, 5], [5, 5, -1]],
                         np.int64)
        lens = {("Logits", 0): np.array([8, 6, 2, 8], np.int32)}
        if norm:
            lens[("Label", 0)] = np.array([3, 1, 3, 2], np.int32)
        return "warpctc", {"Logits": [_f(r, 4, 8, 6)], "Label": [label]}, \
            {"blank": 0, "norm_by_times": norm}, [("Logits", 0)], lens
    return case


def _edit(normalized):
    def case(r):
        hyp = r.randint(0, 4, (4, 6)).astype(np.int64)
        ref = r.randint(0, 4, (4, 5)).astype(np.int64)
        lens = {("Hyps", 0): LENS,
                ("Refs", 0): np.array([5, 3, 2, 0], np.int32)} \
            if normalized else {}
        return "edit_distance", {"Hyps": [hyp], "Refs": [ref]}, \
            {"normalized": normalized}, [], lens
    return case


def _chunk(r):
    # IOB over 3 chunk types: B-k = 2k, I-k = 2k + 1, O = 6
    lab = r.randint(0, 7, (4, 6)).astype(np.int64)
    inf = np.where(r.rand(4, 6) < 0.6, lab,
                   r.randint(0, 7, (4, 6))).astype(np.int64)
    return "chunk_eval", {"Inference": [inf], "Label": [lab]}, \
        {"num_chunk_types": 3, "chunk_scheme": "IOB"}, [], \
        {("Label", 0): LENS}


def _hsigmoid(op, num_classes):
    def case(r):
        return op, {"X": [_f(r, 4, 3)],
                    "Label": [r.randint(0, num_classes, (4, 1))
                              .astype(np.int64)],
                    "W": [_f(r, num_classes - 1, 3)],
                    "Bias": [_f(r, num_classes - 1)]}, \
            {"num_classes": num_classes}, \
            [("X", 0), ("W", 0), ("Bias", 0)], {}
    return case


# name -> function of a RandomState giving (op, ins, attrs, wrt, lens):
# lens as torch_parity.run_op takes it, {(slot, i): [B] lengths,
# (slot, i, 2): [B, S] nested lengths}
SEQ_CASES = {
    # sequence_ops.py
    "sequence_softmax": _softmax(LENS_NONEMPTY),
    "sequence_softmax[empty]": _softmax(LENS, (4, 6, 1)),
    "sequence_expand": _expand("sequence_expand", (4, 3), (4, 6, 3)),
    "sequence_expand[same_rank]": _expand("sequence_expand", (4, 6, 3),
                                          (4, 6, 3)),
    "sequence_expand_as": _expand("sequence_expand_as", (4, 2), (4, 6, 5)),
    "sequence_concat": _concat,
    "sequence_context": _context(False),
    "sequence_context[padw]": _context(True),
    "sub_nested_seq": _sub_nested,
    "conv2d_dynamic_filter": _dyn_filter(False),
    "conv2d_dynamic_filter[shared]": _dyn_filter(True),
    "sequence_slice": _slice,
    "sequence_reverse": _seq("sequence_reverse"),
    "sequence_reshape": _seq("sequence_reshape", (4, 6, 4),
                             {"new_dim": 8}, np.array([6, 1, 0, 5],
                                                      np.int32)),
    "sequence_pad": _seq("sequence_pad"),
    "sequence_unpad": _unpad,
    "lod_reset": _lod_reset(False),
    "lod_reset[Y]": _lod_reset(True),
    "row_conv": _row_conv,
    "kmax_seq_score": _kmax(3),
    "kmax_seq_score[k>T]": _kmax(8),
    "max_sequence_len": _max_len(True),
    "max_sequence_len[no_len]": _max_len(False),
    "lstm_unit": _lstm_unit,
    # crf_ops.py
    "linear_chain_crf": _crf,
    "crf_decoding": _decode(None),
    "crf_decoding[ties]": _decode("ties"),
    "crf_decoding[label]": _decode("label"),
    "crf_decoding[T1]": _decode("T1"),
    "warpctc": _ctc(False),
    "warpctc[norm]": _ctc(True),
    "edit_distance": _edit(True),
    "edit_distance[raw]": _edit(False),
    "chunk_eval": _chunk,
    # embedding_ops.py
    "hierarchical_sigmoid": _hsigmoid("hierarchical_sigmoid", 6),
    "hsigmoid": _hsigmoid("hsigmoid", 11),
    "hsigmoid[8]": _hsigmoid("hsigmoid", 8),
}
# cases whose bf16 run is held to the same package's fp32 run, not to the
# other package's bf16 run: the JAX fill -3.4e38 is -inf in bf16, so its
# row of length 0 is NaN where the port's is zeros (ROADMAP Queue C)
BF16_OWN_FP32 = {"sequence_softmax[empty]"}


# ---------------------------------------------------------------------------
# nce: a draw held to its distribution and its cost given the draw
# ---------------------------------------------------------------------------
NCE_V = 50


def nce_case(rows=8, k=10, seed=11):
    """(op, ins, attrs, wrt) of ``nce``: Input [rows, 4], Label [rows, 1],
    Weight [50, 4], Bias [50]; k negatives a row."""
    r = np.random.RandomState(seed)
    return "nce", {"Input": [_f(r, rows, 4)],
                   "Label": [r.randint(0, NCE_V, (rows, 1)).astype(np.int64)],
                   "Weight": [_f(r, NCE_V, 4, scale=0.5)],
                   "Bias": [_f(r, NCE_V, scale=0.1)]}, \
        {"num_neg_samples": k, "num_total_classes": NCE_V}, \
        [("Input", 0), ("Weight", 0), ("Bias", 0)]


def nce_cost(ins, attrs, samples):
    """nce's SampleLogits and Cost in float64 numpy given its drawn
    SampleLabels."""
    x = ins["Input"][0].astype(np.float64)
    w = ins["Weight"][0].astype(np.float64)
    b = ins["Bias"][0].astype(np.float64)
    k, V = attrs["num_neg_samples"], attrs["num_total_classes"]
    logits = np.einsum("bd,bkd->bk", x, w[samples]) + b[samples] \
        - math.log(k / V)
    y = np.zeros_like(logits)
    y[:, 0] = 1.0
    ce = np.maximum(logits, 0) - logits * y + np.log1p(np.exp(-np.abs(logits)))
    return logits, ce.sum(axis=1, keepdims=True)


def check_nce(outs, ins, attrs, tol=1e-5):
    """Hold one ``nce`` draw (numpy outputs) to its bounds and its cost:
    the label first, the negatives in [0, V), the logits and cost the
    float64 recomputation's within ``tol`` of scale.  Returns a line of
    the statistics, raises ``ValueError`` outside the limits."""
    samples = outs["SampleLabels"]
    label = ins["Label"][0].reshape(-1)
    logits, cost = nce_cost(ins, attrs, samples)
    err_l = float(np.abs(outs["SampleLogits"] - logits).max()
                  / max(np.abs(logits).max(), 1e-30))
    err_c = float(np.abs(outs["Cost"] - cost).max()
                  / max(np.abs(cost).max(), 1e-30))
    stats = (f"{samples.shape[0]} rows x {samples.shape[1] - 1} negatives "
             f"in [{samples[:, 1:].min()}, {samples[:, 1:].max()}], logits "
             f"within {err_l:.2e} and cost within {err_c:.2e} of scale of "
             f"float64")
    if samples.dtype != np.int64 or not np.array_equal(samples[:, 0], label) \
            or samples.min() < 0 or samples.max() >= attrs[
                "num_total_classes"] or err_l > tol or err_c > tol:
        raise ValueError(f"nce: {stats}")
    return stats


def nce_uniformity(samples, V=NCE_V):
    """Chi-square of the negatives' classes against uniform over V (49
    degrees of freedom): (the statistic, its limit at a false-alarm rate
    of 1e-6)."""
    neg = np.asarray(samples)[:, 1:].reshape(-1)
    counts = np.bincount(neg, minlength=V)
    expect = neg.size / V
    return float(((counts - expect) ** 2 / expect).sum()), 111.14


# ---------------------------------------------------------------------------
# The control-flow, io, detection and moe families: single-op cases
# (``while``, ``conditional_block`` and ``print`` need a program: their
# tests build one), each (op, ins, attrs, wrt, lens) as in SEQ_CASES
# ---------------------------------------------------------------------------
def _i64(*v):
    return np.array(v, np.int64)


def _mask_rows(r, n):
    return (r.rand(n, 1) > 0.5) | (np.arange(n)[:, None] == 0)


def _merge(float_mask):
    def case(r):
        mask = np.array([0.0, 2.0, -1.0, 0.0], np.float32) if float_mask \
            else _mask_rows(r, 4)
        return "merge_lod_tensor", {"InTrue": [_f(r, 4, 3)],
                                    "InFalse": [_f(r, 4, 3)],
                                    "Mask": [mask]}, {}, \
            [("InTrue", 0), ("InFalse", 0)], None
    return case


def _write(i, cap=5):
    def case(r):
        return "write_to_array", {"X": [_f(r, 3, 2)], "I": [_i64(i)]}, \
            {"capacity": cap}, X, None
    return case


def _read(i):
    def case(r):
        return "read_from_array", {"X": [_f(r, 5, 3, 2)], "I": [_i64(i)]}, \
            {}, X, None
    return case


# ties among the lengths: a stable descending order keeps their order
RANK_LENS = np.array([3, 5, 1, 5, 3, 0], np.int32)
PERM = np.array([2, 0, 3, 1], np.int32)


def _rank_table(with_lens):
    def case(r):
        if with_lens:
            return "lod_rank_table", {"X": [_f(r, 6, 5, 2)]}, {}, [], \
                {("X", 0): RANK_LENS}
        return "lod_rank_table", {"X": [_f(r, 4, 6, 2)]}, {}, [], None
    return case


def _no_outputs(op):
    def case(r):
        return op, {"X": [_f(r, 2, 3)]}, {"file_path": "unused"}, [], None
    return case


CF_CASES = {
    "split_lod_tensor": lambda r: (
        "split_lod_tensor", {"X": [_f(r, 4, 3)], "Mask": [_mask_rows(r, 4)]},
        {}, X, None),
    "merge_lod_tensor": _merge(False),
    "merge_lod_tensor[float_mask]": _merge(True),
    "write_to_array": _write(2),
    "write_to_array[negative]": _write(-1),
    "write_to_array[clamped]": _write(9),
    "read_from_array": _read(3),
    "read_from_array[negative]": _read(-2),
    "lod_array_length": lambda r: (
        "lod_array_length", {"X": [_f(r, 7, 2)]}, {}, [], None),
    "lod_tensor_to_array": lambda r: (
        "lod_tensor_to_array", {"X": [_f(r, 4, 6, 3)], "RankTable": [PERM]},
        {}, X, None),
    "array_to_lod_tensor": lambda r: (
        "array_to_lod_tensor", {"X": [_f(r, 6, 4, 3)],
                                "RankTable": [PERM]}, {}, X,
        {("RankTable", 0): LENS}),
    "lod_rank_table": _rank_table(True),
    "lod_rank_table[no_len]": _rank_table(False),
    "reorder_lod_tensor_by_rank": lambda r: (
        "reorder_lod_tensor_by_rank", {"X": [_f(r, 4, 6, 3)],
                                       "RankTable": [PERM]}, {}, X,
        {("X", 0): LENS}),
    "shrink_rnn_memory": lambda r: (
        "shrink_rnn_memory", {"X": [_f(r, 4, 3)], "I": [_i64(1)],
                              "RankTable": [PERM]}, {}, X, None),
    "assert": _no_outputs("assert"),
    "save": _no_outputs("save"),
    "load": _no_outputs("load"),
}


def _boxes(r, *lead, lo=0.0, hi=1.0):
    """Corner-form boxes [*lead, 4] with x1 < x2 and y1 < y2 in [lo, hi]."""
    a = r.uniform(lo, hi, lead + (2, 2))
    a.sort(axis=-2)
    return a.transpose(*range(len(lead)), -1, -2).reshape(
        lead + (4,))[..., [0, 2, 1, 3]].astype(np.float32)


def _roi_pool(scale, ph, pw):
    def case(r):
        # ReLU features: about half exact zeros, so many bins tie at 0
        # (and a block of them is 0 everywhere)
        x = np.maximum(_half(r, 2, 3, 8, 9), 0).astype(np.float32)
        x[0, 0, :4, :4] = 0.0
        s = 1.0 / scale
        rois = np.array([[0, 0, 0, 7, 7], [1, 2, 1, 6, 8],
                         [0, 3.5, 2.5, 5.5, 6.5], [1, 0, 0, 0, 0],
                         [1, 10, 9, 12, 11]], np.float32)
        rois[:, 1:] *= s
        return "roi_pool", {"X": [x], "ROIs": [rois]}, \
            {"pooled_height": ph, "pooled_width": pw,
             "spatial_scale": scale}, X, None
    return case


def _prior(r, mins, maxs, ars, flip, clip, var=None):
    attrs = {"min_sizes": mins, "max_sizes": maxs, "aspect_ratios": ars,
             "flip": flip, "clip": clip}
    if var:
        attrs["variances"] = var
    return "prior_box", {"Input": [_f(r, 2, 4, 5, 6)],
                         "Image": [_f(r, 1, 3, 30, 36)]}, attrs, [], None


def _box_coder(with_var):
    def case(r):
        ins = {"PriorBox": [_boxes(r, 10)],
               "TargetBox": [_f(r, 1, 10, 4, scale=0.5)]}
        if with_var:
            ins["PriorBoxVar"] = [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                          (10, 1))]
        return "box_coder", ins, {}, [("TargetBox", 0), ("PriorBox", 0)], \
            None
    return case


def _iou(r):
    y = _boxes(r, 10)
    x = np.concatenate([_boxes(r, 2), y[3:4],                  # identical
                        np.float32([[2.0, 2.0, 3.0, 3.0]])])   # disjoint
    return "iou_similarity", {"X": [x], "Y": [y]}, {}, XY, None


def _ssd(label3d):
    def case(r):
        N, P, C, M = 2, 10, 4, 3
        gtl = np.array([[1, 2, -1], [3, -1, -1]], np.int64)
        gtb = _boxes(r, N, M)
        gtb[gtl < 0] = 0.0
        ins = {"Location": [_f(r, N, P, 4)], "Confidence": [_f(r, N, P, C)],
               "GTBox": [gtb],
               "GTLabel": [gtl[..., None] if label3d else gtl],
               "PriorBox": [_boxes(r, P)]}
        attrs = {}
        if label3d:
            attrs = {"neg_pos_ratio": 2.0, "background_label": 1,
                     "overlap_threshold": 0.3}
        else:
            ins["PriorBoxVar"] = [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                          (P, 1))]
        return "ssd_loss", ins, attrs, [("Location", 0),
                                        ("Confidence", 0)], None
    return case


def _nms(op, attrs):
    def case(r):
        N, P, C = 2, 8, 4
        # a tie in every class (two priors with one score), and boxes
        # overlapping in pairs so that NMS suppresses
        logits = _half(r, N, P, C, lo=-2, hi=2)
        logits[:, 1] = logits[:, 4]
        scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        base = _boxes(r, N, P // 2)
        boxes = np.concatenate([base, base + np.float32(0.02)], axis=1)
        return op, {"Scores": [scores.astype(np.float32)],
                    "BBoxes": [boxes]}, dict(attrs), \
            [("Scores", 0), ("BBoxes", 0)], None
    return case


DET_CASES = {
    "roi_pool": _roi_pool(1.0, 2, 3),
    "roi_pool[scale]": _roi_pool(0.5, 3, 3),
    "prior_box": lambda r: _prior(r, [8.0], [16.0], [2.0, 3.0], True, True),
    "prior_box[noflip]": lambda r: _prior(r, [4.0, 10.0], [], [1.0, 2.0],
                                          False, False,
                                          [0.1, 0.2, 0.3, 0.4]),
    "box_coder": _box_coder(True),
    "box_coder[no_var]": _box_coder(False),
    "iou_similarity": _iou,
    "ssd_loss": _ssd(False),
    "ssd_loss[3d_label]": _ssd(True),
    # keep_top_k above the (C - 1) * nms_top_k candidates: -1 pad rows
    "multiclass_nms": _nms("multiclass_nms", {
        "nms_top_k": 5, "keep_top_k": 20, "score_threshold": 0.05,
        "nms_threshold": 0.45}),
    "detection_output": _nms("detection_output", {
        "nms_top_k": 6, "keep_top_k": 4, "score_threshold": 0.2,
        "nms_threshold": 0.3, "background_label": 1}),
}


def _moe(act, top_k=2, cap=1.25, lead=(2, 6)):
    def case(r):
        D, E, H = 8, 4, 16
        return "moe", {"X": [_f(r, *lead, D)], "GateW": [_f(r, D, E)],
                       "W1": [_f(r, E, D, H, scale=0.5)],
                       "W2": [_f(r, E, H, D, scale=0.5)]}, \
            {"top_k": top_k, "capacity_factor": cap, "activation": act}, \
            [("X", 0), ("GateW", 0), ("W1", 0), ("W2", 0)], None
    return case


# capacity 1.25 * 2 * 12 / 4 = 7 slots an expert: some tokens overflow
MOE_CASES = {
    "moe": _moe("relu"),
    "moe[gelu]": _moe("gelu"),
    "moe[top1]": _moe("tanh", top_k=1, cap=2.0, lead=(12,)),
    "moe[sigmoid]": _moe("sigmoid", cap=0.5),
    "moe[swish]": _moe("swish", top_k=3),
}
