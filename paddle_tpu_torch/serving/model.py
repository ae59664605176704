"""Servable model handles (counterpart of ``paddle_tpu/serving/model.py``,
the live-program constructor only).

A :class:`Model` is (name, infer fn): the fn takes ONE stacked feed dict
``{name: array[B, ...]}`` and returns the output list ``[out[B, ...],
...]`` — the row-wise batch contract the server's batcher needs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Model"]


class Model:
    """One servable tenant: a batched infer fn.  ``fn`` must be row-wise
    (row i of every output depends only on row i of the feeds)."""

    def __init__(self, name: str, fn: Callable, *,
                 output_names: Optional[Sequence[str]] = None,
                 example: Optional[Dict[str, np.ndarray]] = None):
        if not name:
            raise ValueError("Model: name must be non-empty")
        self.name = str(name)
        self._fn = fn
        self.output_names = list(output_names or [])
        self.example = example

    def __call__(self, feeds_stacked: Dict[str, np.ndarray]) -> List:
        return self._fn(feeds_stacked)

    def coerce_feeds(self, feeds: Dict[str, object]) -> Dict[str, np.ndarray]:
        """One request's feeds (no batch axis) -> numpy arrays; the
        executor casts them to the program's declared dtypes."""
        return {k: np.asarray(v) for k, v in feeds.items()}

    def __repr__(self):
        return f"Model({self.name!r}, outputs={self.output_names})"

    @classmethod
    def from_program(cls, executor, program, fetch_list, scope=None,
                     name: Optional[str] = None, is_test: bool = True,
                     example: Optional[Dict[str, np.ndarray]] = None):
        """Serve a live Program through ``executor.run``; outputs stay
        tensors on the executor's device until the server splits them."""
        from ..core.program import Variable

        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]
        name = name or f"program-{id(program):x}"

        def fn(feeds):
            return executor.run(program, feed=feeds,
                                fetch_list=fetch_names, scope=scope,
                                return_numpy=False, is_test=is_test)

        return cls(name, fn, output_names=fetch_names, example=example)
