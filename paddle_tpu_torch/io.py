"""Model persistence (counterpart of ``paddle_tpu/io.py:33-130``, the
reference's ``fluid/io.py:32-165``).

The on-disk format is the JAX package's: one ``<name>.npy`` per var in
``dirname`` (``/`` in a name becomes ``__``), and for an inference model
a ``__model__`` JSON file holding the pruned program
(``Program.to_dict``) with its feed and fetch names.  So a directory
either package saved loads in the other.  Loaded values become tensors
on the executor's device (default: the card, ``CUDAPlace(0)``); pass an
``Executor(CPUPlace())`` to load on the CPU.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from .core.program import Parameter, Program, Variable, default_main_program
from .core.scope import Scope, global_scope, to_numpy

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program",
]


def _san(name: str) -> str:
    return name.replace("/", "__")


def _names(main_program, vars, predicate):
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    return [v.name if isinstance(v, Variable) else str(v) for v in vars]


def save_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, scope: Optional[Scope] = None):
    """Write each var of ``vars`` (default: those of ``main_program`` that
    ``predicate`` keeps) that ``scope`` holds to ``<dirname>/<name>.npy``
    (bfloat16 as float32)."""
    main_program = main_program or default_main_program()
    scope = global_scope() if scope is None else scope
    os.makedirs(dirname, exist_ok=True)
    for name in _names(main_program, vars, predicate):
        if scope.has(name):
            np.save(os.path.join(dirname, _san(name) + ".npy"),
                    to_numpy(scope.get(name)))


def _is_param(v):
    return isinstance(v, Parameter)


def _is_persistable(v):
    return v.persistable


def save_params(executor=None, dirname=None, main_program=None, scope=None):
    save_vars(executor, dirname, main_program, predicate=_is_param,
              scope=scope)


def save_persistables(executor=None, dirname=None, main_program=None,
                      scope=None):
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              scope=scope)


def _device(executor) -> torch.device:
    if executor is not None:
        return executor.device
    from .core.executor import CUDAPlace
    return CUDAPlace(0).device()


def load_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, scope: Optional[Scope] = None):
    """Read ``<dirname>/<name>.npy`` into ``scope`` for each var of
    ``vars`` (default: those of ``main_program`` that ``predicate``
    keeps) that has a file, as a tensor on the executor's device."""
    main_program = main_program or default_main_program()
    scope = global_scope() if scope is None else scope
    device = _device(executor)
    for name in _names(main_program, vars, predicate):
        path = os.path.join(dirname, _san(name) + ".npy")
        if os.path.exists(path):
            scope.set(name, torch.from_numpy(np.load(path)).to(device))


def load_params(executor=None, dirname=None, main_program=None, scope=None):
    load_vars(executor, dirname, main_program, predicate=_is_param,
              scope=scope)


def load_persistables(executor=None, dirname=None, main_program=None,
                      scope=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              scope=scope)


def get_inference_program(target_vars, main_program=None) -> Program:
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return main_program.prune(target_vars)


def save_inference_model(dirname, feeded_var_names: List[str], target_vars,
                         executor=None, main_program=None, scope=None):
    """Prune ``main_program`` to the inference slice ending at
    ``target_vars`` and write it (``__model__``) with its persistables
    (reference: ``fluid/io.py:165``)."""
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    pruned = main_program.prune(target_vars).clone(for_test=True)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": pruned.to_dict(),
        "feed_var_names": list(feeded_var_names),
        "fetch_var_names": [t.name if isinstance(t, Variable) else str(t)
                            for t in target_vars],
    }
    with open(os.path.join(dirname, "__model__"), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, main_program, scope=scope)


def load_inference_model(dirname, executor=None, scope=None):
    """(program, feed names, fetch vars) of a saved inference model, its
    persistables loaded into ``scope`` on the executor's device."""
    with open(os.path.join(dirname, "__model__")) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, scope=scope)
    gb = program.global_block()
    fetch_vars = [gb.var(n) for n in meta["fetch_var_names"]
                  if gb.has_var(n)]
    return program, meta["feed_var_names"], fetch_vars
