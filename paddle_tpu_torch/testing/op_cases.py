"""Operands of the tensor and math op families, made with numpy from a
seed, for holding an op against another implementation of it: the JAX
lowering on the CPU (``tests/test_torch_tensor_math_ops.py``) or the
port's own op on another device (``chip_smoke.py``'s ``[dense]``).

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
