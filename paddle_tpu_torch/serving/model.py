"""Servable model handles (counterpart of ``paddle_tpu/serving/model.py``,
its ``from_program`` and ``from_artifact`` constructors).

A :class:`Model` is (name, infer fn, input specs): the fn takes ONE
stacked feed dict ``{name: array[B, ...]}`` and returns the output list
``[out[B, ...], ...]`` — the row-wise batch contract the server's batcher
needs.

* :meth:`Model.from_artifact` — an ``export_compiled_model`` directory
  (``model.pt2`` and its manifest): one artifact with a symbolic batch
  serves every bucket, each bucket replaying its own CUDA graph on a
  card (``export_model.CompiledRun``).
* :meth:`Model.from_program` — a live (executor, program, fetch_list,
  scope).
* :meth:`Model.from_compiled` — an ``Executor.compile`` handle: its
  bucket replays the step built ahead; other buckets go through the
  owning executor.

``example`` (one
example's feeds, no batch axis) drives the server's warm-up; an
artifact's manifest gives one from its input shapes.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Model"]


def _example_from_specs(
        specs: Dict[str, dict]) -> Optional[Dict[str, np.ndarray]]:
    """One example's feeds from manifest input specs ({name: {shape,
    dtype}}): zeros for integers, 0.5 for floats; None when a non-batch
    dim is unknown."""
    out: Dict[str, np.ndarray] = {}
    for name, spec in specs.items():
        shape = list(spec["shape"])
        if shape and shape[0] in (None, -1):
            shape = shape[1:]
        if any(d is None or int(d) < 0 for d in shape):
            return None
        dtype = np.dtype(spec["dtype"])
        if dtype.kind in "iu":
            out[name] = np.zeros(tuple(int(d) for d in shape), dtype)
        else:
            out[name] = np.full(tuple(int(d) for d in shape), 0.5, dtype)
    return out


class Model:
    """One servable tenant: a batched infer fn and its calling
    convention.  ``fn`` must be row-wise (row i of every output depends
    only on row i of the feeds)."""

    def __init__(self, name: str, fn: Callable, *,
                 input_specs: Optional[Dict[str, dict]] = None,
                 output_names: Optional[Sequence[str]] = None,
                 example: Optional[Dict[str, np.ndarray]] = None):
        if not name:
            raise ValueError("Model: name must be non-empty")
        self.name = str(name)
        self._fn = fn
        self.input_specs = dict(input_specs or {})
        self.output_names = list(output_names or [])
        if example is None and self.input_specs:
            example = _example_from_specs(self.input_specs)
        self.example = example

    def __call__(self, feeds_stacked: Dict[str, np.ndarray]) -> List:
        return self._fn(feeds_stacked)

    def coerce_feeds(self, feeds: Dict[str, object]) -> Dict[str, np.ndarray]:
        """One request's feeds (no batch axis) -> numpy arrays.  With
        input specs (an artifact's manifest) they take the declared
        dtypes, and an unknown, missing or mis-shaped input raises here,
        at admission, as one request's rejection, not later as a failed
        batch that would count against the model's circuit breaker.
        Without specs the executor casts feeds to the program's dtypes."""
        out: Dict[str, np.ndarray] = {}
        for k, v in feeds.items():
            spec = self.input_specs.get(k)
            if self.input_specs and spec is None:
                raise ValueError(
                    f"model {self.name!r} has no input {k!r} "
                    f"(inputs: {sorted(self.input_specs)})")
            arr = np.asarray(v, dtype=np.dtype(spec["dtype"]) if spec
                             else None)
            if spec is not None:
                shape = list(spec["shape"])
                if shape and (shape[0] is None or int(shape[0]) < 0):
                    shape = shape[1:]        # one example: no batch dim
                want = tuple(None if d is None or int(d) < 0 else int(d)
                             for d in shape)
                if len(arr.shape) != len(want) or any(
                        w is not None and a != w
                        for a, w in zip(arr.shape, want)):
                    raise ValueError(
                        f"model {self.name!r} input {k!r}: example shape "
                        f"{arr.shape} does not match declared {want}")
            out[k] = arr
        missing = sorted(set(self.input_specs) - set(out))
        if missing:
            raise ValueError(f"model {self.name!r}: missing inputs {missing}")
        return out

    def __repr__(self):
        return (f"Model({self.name!r}, inputs={sorted(self.input_specs)}, "
                f"outputs={self.output_names})")

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_artifact(cls, dirname: str, name: Optional[str] = None,
                      device=None):
        """Serve an ``export_compiled_model`` directory: one artifact,
        one captured CUDA graph per bucket on a card.  ``device`` as for
        ``load_compiled_model`` (default: the card)."""
        from ..export_model import load_compiled_model

        run, manifest = load_compiled_model(dirname, device=device)
        name = name or os.path.basename(os.path.normpath(dirname))
        return cls(name, run, input_specs=manifest.get("inputs"),
                   output_names=manifest.get("outputs"))

    @classmethod
    def from_compiled(cls, compiled, name: Optional[str] = None,
                      scope=None,
                      example: Optional[Dict[str, np.ndarray]] = None):
        """Wrap an ``Executor.compile`` handle (a
        ``compile_cache.CompiledProgram``): its bucket is free (a replay
        of the step built ahead, from any thread); other buckets go
        through the owning executor's cache on the same program.  Pass
        the ``scope`` the program was compiled against (its state is
        part of the key)."""
        return cls.from_program(
            compiled.executor, compiled.program, compiled.fetch_names,
            scope=scope, name=name, is_test=compiled.is_test,
            example=example)

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

        # no input_specs: executor.run casts feeds to the program's dtypes
        return cls(name, fn, output_names=fetch_names, example=example)
