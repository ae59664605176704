"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
build the same model in the JAX package and in paddle_tpu_torch, and
move a JAX scope's persistables into a port scope."""
from __future__ import annotations

import paddle_tpu as pt
import paddle_tpu_torch as ptt


def reset_both():
    """Fresh default programs, scopes and name counters in both packages
    (the name counters must start equal for the programs to match)."""
    pt.core.reset_default_programs()
    pt.core.reset_global_scope()
    pt.unique_name.reset()
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def build(pkg, model, shape, seed=0, **kwargs):
    """(main, startup, pred) of ``pkg.models.<model>`` on an ``img`` feed
    of per-example ``shape``, with fresh name counters."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", list(shape))
        pred = getattr(pkg.models, model)(img, **kwargs)
    return main, startup, pred


def jax_state(scope):
    """{name: numpy array} of every value in a JAX scope."""
    return {k: scope.numpy(k) for k in scope.keys()}


def both(model, shape, **kwargs):
    """The same model built by both packages, JAX startup run on the CPU,
    its weights carried into a port scope.  Returns a dict of the
    programs (inference clones), fetch vars and scopes."""
    jm, js, jp = build(pt, model, shape, **kwargs)
    tm, ts, tp = build(ptt, model, shape, **kwargs)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    return {"jax": (jm.clone(for_test=True), jp, jscope),
            "torch": (tm.clone(for_test=True), tp, tscope)}
