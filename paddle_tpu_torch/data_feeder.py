"""DataFeeder: rows of Python lists or numpy arrays -> a feed dict
(counterpart of ``paddle_tpu/data_feeder.py``; reference:
fluid/data_feeder.py:55).

A sequence var (``lod_level`` 1) arrives as one variable-length row per
example; the feeder pads the batch to its longest row, rounded up to
``seq_bucket_multiple``, and adds ``name@LEN``, the int32 lengths.  A
nested var (``lod_level`` 2) pads to [B, S, T, ...] and adds ``@LEN``
[B] and ``@LEN2`` [B, S].  The padding is the JAX feeder's vectorized
numpy path (one mask scatter a batch); its native C++ path and its
reusable staging buffers are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .core.program import Variable


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


class DataFeeder:
    """``id_bounds`` (``{var_name: vocab_size}``) checks an integer
    variable's ids against its table: a negative or out-of-vocab id
    raises a ValueError naming the variable.  Integer columns take the
    variable's declared dtype; float values aimed at an integer
    variable are refused."""

    def __init__(self, feed_list: Sequence[Variable], place=None,
                 program=None, seq_bucket_multiple: int = 8,
                 id_bounds: Optional[Dict[str, int]] = None):
        self.feed_list = list(feed_list)
        self.place = place
        self.seq_bucket_multiple = seq_bucket_multiple
        self.id_bounds = dict(id_bounds or {})

    def _check_int_feed(self, var: Variable, arr: np.ndarray) -> np.ndarray:
        dt = np.dtype(var.dtype)
        if arr.dtype == object:
            raise ValueError(
                f"feed {var.name!r}: rows form a ragged/mixed object array "
                f"— every row must carry the same rectangular shape for a "
                f"lod_level-0 variable (sequence ids belong in a "
                f"lod_level>0 variable)")
        if arr.dtype.kind == "f":
            raise ValueError(
                f"feed {var.name!r}: declared {dt.name} but got float "
                f"values ({arr.dtype.name}); convert explicitly")
        arr = arr.astype(dt, copy=False)
        self._check_id_range(var, arr)
        return arr

    def _check_id_range(self, var: Variable, arr: np.ndarray):
        """Ids within [0, id_bounds[name]); pad slots are 0, inside
        every range."""
        bound = self.id_bounds.get(var.name)
        if bound is None or not arr.size:
            return
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= bound:
            raise ValueError(
                f"feed {var.name!r}: id {lo if lo < 0 else hi} outside the "
                f"embedding table's valid range [0, {bound})")

    def feed(self, minibatch: Sequence[Sequence]) -> Dict[str, np.ndarray]:
        """minibatch: a list of rows, each a tuple matching feed_list."""
        out: Dict[str, np.ndarray] = {}
        cols = list(zip(*minibatch))
        if len(cols) != len(self.feed_list):
            raise ValueError(f"feed rows have {len(cols)} fields, expected "
                             f"{len(self.feed_list)}")
        for var, col in zip(self.feed_list, cols):
            is_int = np.dtype(var.dtype).kind in "iu"
            if var.lod_level == 0:
                try:
                    arr = np.asarray(col)
                except ValueError as e:
                    raise ValueError(
                        f"feed {var.name!r}: rows form a ragged/mixed "
                        f"column ({e}) — every row must carry the same "
                        f"rectangular shape for a lod_level-0 variable") \
                        from e
                if is_int:
                    arr = self._check_int_feed(var, arr)
                if var.shape is not None and len(var.shape) == arr.ndim + 1 \
                        and var.shape[-1] == 1:
                    arr = arr[..., None]       # label [B] -> [B, 1]
                out[var.name] = arr.astype(np.dtype(var.dtype), copy=False)
            elif var.lod_level == 1:
                arr, lens = self._pad_rows(col, var)
                if is_int:
                    self._check_id_range(var, arr)
                if var.shape is not None and len(var.shape) == arr.ndim + 1 \
                        and var.shape[-1] == 1:
                    arr = arr[..., None]
                out[var.name] = arr
                out[var.name + "@LEN"] = lens
            elif var.lod_level == 2:
                arr, lens, lens2 = self._pad_nested(col, var)
                if is_int:
                    self._check_id_range(var, arr)
                out[var.name] = arr
                out[var.name + "@LEN"] = lens
                out[var.name + "@LEN2"] = lens2
            else:
                raise NotImplementedError(
                    "lod_level>2 nested sequences are not supported (max "
                    "LoD depth 2)")
        return out

    def _pad_rows(self, col, var):
        """Rows concatenate to [sum of lengths, ...] and land in the
        zeroed [B, T, ...] buffer through ``arr[mask]``, mask[b, t] =
        t < len(row b)."""
        dt = np.dtype(var.dtype)
        rows = [np.asarray(r, dtype=dt) for r in col]
        lens = np.fromiter((r.shape[0] for r in rows), np.int32, len(rows))
        T = _round_up(int(lens.max()) if len(lens) else 1,
                      self.seq_bucket_multiple)
        feat_shape = rows[0].shape[1:] if rows and rows[0].ndim > 1 else ()
        arr = np.zeros((len(rows), T) + feat_shape, dt)
        if rows:
            mask = np.arange(T, dtype=np.int32)[None, :] < lens[:, None]
            arr[mask] = np.concatenate(rows, axis=0)
        return arr, lens

    def _pad_nested(self, col, var):
        """Rows of subsequences -> [B, S, T, ...], @LEN [B] and @LEN2
        [B, S]: the subsequences pad into [N, T, ...] with one mask
        scatter, then scatter to their (b, s) slots."""
        dt = np.dtype(var.dtype)
        B = len(col)
        lens = np.fromiter((len(r) for r in col), np.int32, B)
        S = int(lens.max()) if B else 1
        subs = [np.asarray(sub, dtype=dt) for row in col for sub in row]
        sub_lens = np.fromiter((s.shape[0] for s in subs), np.int32,
                               len(subs))
        T = int(sub_lens.max()) if len(sub_lens) else 1
        if len(lens) and (lens == 0).any():
            T = max(T, 1)     # a row with no subsequences counts as one
        T = _round_up(T, self.seq_bucket_multiple)
        feat_shape = next((s.shape[1:] for s in subs if s.shape[0]), ())
        arr = np.zeros((B, S, T) + feat_shape, dt)
        lens2 = np.zeros((B, S), np.int32)
        if subs:
            b_idx = np.repeat(np.arange(B, dtype=np.int32), lens)
            s_idx = np.concatenate([np.arange(n, dtype=np.int32)
                                    for n in lens])
            lens2[b_idx, s_idx] = sub_lens
            padded = np.zeros((len(subs), T) + feat_shape, dt)
            mask = np.arange(T, dtype=np.int32)[None, :] < sub_lens[:, None]
            nonempty = [s for s in subs if s.shape[0]]
            if nonempty:
                padded[mask] = np.concatenate(nonempty, axis=0)
            arr[b_idx, s_idx] = padded
        return arr, lens, lens2
