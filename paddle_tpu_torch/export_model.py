"""Inference export: a self-contained artifact of a pruned program.

Counterpart of ``paddle_tpu/export_model.py``, where the pruned
inference program goes through ``jax.export`` as serialized StableHLO
with the weights baked in.  Here it goes through ``torch.export``:

* :func:`export_compiled_model` prunes the program to ``target_vars``,
  wraps it as an ``nn.Module`` over the executor's interpreter
  (``Executor.as_module``: the state are its buffers), traces it with
  ``torch.export.export(strict=False)`` and writes ``model.pt2``
  (``torch.export.save``: the graph and the weights) and
  ``manifest.json`` (the JAX manifest's ``inputs``, with a ``null``
  batch, ``outputs`` and ``symbolic_batch``; ``format: "torch.export"``;
  the ``device`` it was exported for and the ``custom_ops`` its graph
  holds).  A leading dim of -1 or None becomes one shared ``Dim("b")``,
  so one artifact serves every batch.  The 1x1 convolutions that pass
  the static part of the gate are ``paddle_tpu_torch::conv2d_1x1`` nodes
  (``ops/conv1x1.py``), which pick K1 or ``F.conv2d`` at each call's
  batch, and flash attention is a ``paddle_tpu_torch::flash_attention_fwd``
  node (``ops/flash_attention.py``), which launches K2 on a card.
* :func:`load_compiled_model` needs no Program and no Scope: it loads
  the artifact and returns ``(run, manifest)``.  On a card ``run``
  replays one CUDA graph per input shape (a thread's first call of a
  shape runs the graph module eagerly, its second captures), the
  counterpart of XLA compiling the artifact once per concrete shape.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import compile_cache
from .core.executor import CPUPlace, CUDAPlace, Executor, Place
from .core.program import Program, Variable, default_main_program
from .core.scope import global_scope

__all__ = ["export_compiled_model", "load_compiled_model", "CompiledRun",
           "resolve_place"]

_ARTIFACT = "model.pt2"
_MANIFEST = "manifest.json"
# the batch the trace runs at: torch.export specializes a dim whose
# example size is 0 or 1
_EXAMPLE_BATCH = 2


def resolve_place(device) -> Place:
    """A Place from None (the card), a Place, a torch.device or a str."""
    if device is None:
        return CUDAPlace(0)
    if isinstance(device, Place):
        return device
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPUPlace()
    if dev.type == "cuda":
        return CUDAPlace(dev.index or 0)
    raise ValueError(f"export: no place for device {device!r}")


def custom_ops(graph_module) -> Dict[str, int]:
    """{``namespace::name``: count} of the port's custom ops in a graph."""
    found: Dict[str, int] = {}
    for node in graph_module.graph.nodes:
        ns = getattr(node.target, "namespace", None)
        if node.op == "call_function" and ns == "paddle_tpu_torch":
            name = f"{ns}::{node.target._opname}"
            found[name] = found.get(name, 0) + 1
    return found


def export_compiled_model(dirname: str,
                          feed_specs: Dict[str, Tuple[Sequence[int], str]],
                          target_vars,
                          main_program: Optional[Program] = None,
                          scope=None, device=None) -> dict:
    """Export the inference slice ending at ``target_vars`` as a
    ``torch.export`` artifact with the weights inside.

    feed_specs: ``{feed_name: (shape, dtype)}``; a leading -1/None dim
    becomes the symbolic batch "b", shared by every input.  ``device``:
    where the artifact runs (default: the card, ``CUDAPlace(0)``; pass
    ``"cpu"`` or ``CPUPlace()`` for the CPU); the scope's state is taken
    to it.  Returns the manifest dict."""
    from torch.export import Dim, export, save

    main_program = main_program or default_main_program()
    scope = global_scope() if scope is None else scope
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    fetch_names = [t.name if isinstance(t, Variable) else str(t)
                   for t in target_vars]
    pruned = main_program.prune(target_vars).clone(for_test=True)
    exe = Executor(resolve_place(device))
    module = exe.as_module(pruned, fetch_names, scope)
    module.to(exe.device)

    batch = Dim("b", min=1)
    example, dynamic, inputs = {}, {}, {}
    for name, (shape, dtype) in feed_specs.items():
        shape = list(shape)
        sym = bool(shape) and shape[0] in (None, -1)
        dims = [_EXAMPLE_BATCH if sym and i == 0 else int(d)
                for i, d in enumerate(shape)]
        example[name] = torch.zeros(dims, dtype=_torch_dtype(dtype),
                                    device=exe.device)
        dynamic[name] = {0: batch} if sym else None
        inputs[name] = {"shape": [None if sym and i == 0 else int(d)
                                  for i, d in enumerate(shape)],
                        "dtype": str(np.dtype(dtype))}
    with torch.no_grad():
        ep = export(_Positional(module, list(example)),
                    tuple(example.values()),
                    dynamic_shapes=({"inputs": tuple(dynamic.values())}
                                    if example else None),
                    strict=False)
    os.makedirs(dirname, exist_ok=True)
    save(ep, os.path.join(dirname, _ARTIFACT))
    manifest = {
        "format": "torch.export",
        "inputs": inputs,
        "outputs": fetch_names,
        "symbolic_batch": any(v is not None for v in dynamic.values()),
        "device": str(exe.device),
        "custom_ops": custom_ops(ep.graph_module),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(dirname, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class _Positional(torch.nn.Module):
    """``ProgramModule`` with its feeds as positional inputs, in the
    manifest's order: the form ``torch.export`` takes a symbolic batch
    on (it refuses dynamic shapes for a ``**feeds`` signature)."""

    def __init__(self, program: torch.nn.Module, names):
        super().__init__()
        self.program = program
        self.names = list(names)

    def forward(self, *inputs):
        return self.program(**dict(zip(self.names, inputs)))


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, np.dtype(dtype).name)


class _ShapeGraph:
    """One input shape's CUDA graph over static input buffers."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm_threads = set()
        self.inputs: Dict[str, torch.Tensor] = {}
        self.outputs: tuple = ()
        self.deltas: list = []


class CompiledRun:
    """``run(feeds) -> [outputs]`` of a loaded artifact
    (:func:`load_compiled_model`): feeds are arrays or tensors by input
    name, cast to the manifest's dtypes on the artifact's device; the
    outputs are tensors there, the caller's own.

    On a card each input shape has its CUDA graph: a thread's first call
    of a shape runs the graph module eagerly on a side stream (its
    warm-up: the kernels build and cuBLAS makes the thread's handles
    there), the next call captures the graph on that stream and replays
    it, later calls replay.  A failed capture raises.  The kernel
    wrappers' launch counts are added once a replay, as the executor's
    captured steps add them.  On the CPU every call runs the module."""

    def __init__(self, module: torch.nn.Module, manifest: dict,
                 device: torch.device):
        self.module = module
        self.manifest = manifest
        self.device = device
        self.graphs: Dict[tuple, _ShapeGraph] = {}
        self._lock = threading.Lock()
        self._side = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def _inputs(self, feeds) -> Dict[str, torch.Tensor]:
        specs = self.manifest["inputs"]
        unknown = sorted(set(feeds) - set(specs))
        missing = sorted(set(specs) - set(feeds))
        if unknown or missing:
            raise ValueError(f"artifact run: inputs {sorted(specs)} "
                             f"expected; missing {missing}, unknown "
                             f"{unknown}")
        out = {}
        for name, spec in specs.items():
            v = feeds[name]
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.array(v, order="C"))
            out[name] = t.to(self.device, _torch_dtype(spec["dtype"]),
                             non_blocking=True)
        return out

    def __call__(self, feeds):
        inputs = self._inputs(feeds)
        if self.device.type != "cuda":
            with torch.no_grad():
                return list(self.module(*inputs.values()))
        key = tuple((n, tuple(t.shape)) for n, t in inputs.items())
        thread = threading.get_ident()
        with self._lock, torch.no_grad():
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = _ShapeGraph()
            if g.graph is None and thread not in g.warm_threads:
                g.warm_threads.add(thread)
                return self._warm(inputs)
            if g.graph is None:
                self._capture(g, inputs)
            else:
                for n, t in inputs.items():
                    g.inputs[n].copy_(t)
            g.graph.replay()
            compile_cache.replay_launches(g.deltas)
            return [o.clone() for o in g.outputs]

    def replay(self, feeds, k: int):
        """Replay the graph of ``feeds``' shapes ``k`` times on the current
        stream with ``feeds`` copied in once and no outputs copied out:
        the device's own time of a call, K replays between two events
        (the caller's).  Warms up and captures the shape first where this
        thread has not."""
        if self.device.type != "cuda":
            raise ValueError("CompiledRun.replay: graphs run on a card")
        inputs = self._inputs(feeds)
        key = tuple((n, tuple(t.shape)) for n, t in inputs.items())
        while key not in self.graphs or self.graphs[key].graph is None:
            self(inputs)
        g = self.graphs[key]
        with self._lock:
            for n, t in inputs.items():
                g.inputs[n].copy_(t)
            for _ in range(int(k)):
                g.graph.replay()
                compile_cache.replay_launches(g.deltas)

    def _warm(self, inputs):
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            outs = list(self.module(*inputs.values()))
        cur.wait_stream(self._side)
        return outs

    def _capture(self, g: _ShapeGraph, inputs):
        g.inputs = {n: t.clone() for n, t in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            with compile_cache.capture_launches(g.deltas), \
                    torch.cuda.graph(graph, stream=self._side,
                                     capture_error_mode="thread_local"):
                g.outputs = tuple(self.module(*g.inputs.values()))
        except Exception as e:
            raise RuntimeError(
                f"paddle_tpu_torch: capturing the exported model "
                f"{self.manifest.get('outputs')} at input shapes "
                f"{[tuple(t.shape) for t in inputs.values()]} as a CUDA "
                f"graph failed ({type(e).__name__}: {e})") from e
        g.graph = graph


def load_compiled_model(dirname: str, device=None):
    """Load an exported artifact: ``(run, manifest)``, ``run`` a
    :class:`CompiledRun`.  ``device`` as for
    :func:`export_compiled_model` (default: the card); it must be the
    device the artifact was exported for, whose constants its graph
    holds."""
    from . import ops  # noqa: F401  (registers the port's custom ops)

    with open(os.path.join(dirname, _MANIFEST)) as f:
        manifest = json.load(f)
    dev = resolve_place(device).device()
    if str(dev) != manifest["device"]:
        raise ValueError(
            f"load_compiled_model({dirname!r}): the artifact was exported "
            f"for {manifest['device']}, asked to run on {dev}; export it "
            f"again for {dev}")
    ep = torch.export.load(os.path.join(dirname, _ARTIFACT))
    return CompiledRun(ep.module(), manifest, dev), manifest
