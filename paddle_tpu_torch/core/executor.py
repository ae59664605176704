"""Executor: runs a Program op by op on torch tensors.

Counterpart of ``paddle_tpu/core/executor.py``.  The JAX executor traces
the whole block into one ``jax.jit`` function; here PyTorch runs
eagerly, so ``run`` walks the global block through the registered op
implementations (``run_op``) on the executor's device:

    run(program, feed, fetch_list)
        feeds -> tensors on device; persistable state from the Scope
        interpret every op (inference AMP: the whole net in bf16);
        a program with a ``backward`` op runs its forward slice once
        under autograd, then the optimizer ops
        write back the persistables the ops produced; return fetches

``run_steps`` runs K such steps with the state kept on the device and
the fetches stacked on a leading K axis.

A sub-block (the step of a ``StaticRNN``) runs in a child ``Env`` whose
lookups fall through to its parent's; sequence vars carry their lengths
as ``name@LEN`` integer companions (fed, or set by ops through
``ExecContext.set_len``), which no AMP cast touches.

Not ported yet: capturing a step as a CUDA graph (the counterpart of
the JAX executor's compiled step), the compile cache, observability,
validation and retry.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .program import Block, Operator, Program, Variable, grad_var_name
from .registry import get_op_impl
from .scope import Scope, global_scope, to_numpy
from .types import to_torch_dtype


# ---------------------------------------------------------------------------
# Places
# ---------------------------------------------------------------------------
class Place:
    def device(self) -> torch.device:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class CPUPlace(Place):
    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card.  Asking for it on a machine without one raises:
    the executor never carries on quietly on the CPU."""

    def __init__(self, index: int = 0):
        self.index = int(index)

    def device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: no CUDA device is available; pass "
                "place=CPUPlace() to run on the CPU")
        if self.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"paddle_tpu_torch: CUDA device {self.index} requested, "
                f"{torch.cuda.device_count()} present")
        return torch.device("cuda", self.index)

    def __repr__(self):
        return f"CUDAPlace({self.index})"


# ---------------------------------------------------------------------------
# Environment: name -> tensor for one run of a block, with a parent chain
# for sub-blocks (a StaticRNN step looks up what its parent block bound)
# ---------------------------------------------------------------------------
class Env:
    def __init__(self, block: Block, parent: Optional["Env"] = None):
        self.block = block
        self.parent = parent
        self.local: Dict[str, object] = {}

    def get(self, name: str):
        e: Optional[Env] = self
        while e is not None:
            if name in e.local:
                return e.local[name]
            e = e.parent
        raise KeyError(f"variable {name!r} has no value; is it fed, "
                       f"initialized by the startup program, or "
                       f"produced by an earlier op?")

    def has(self, name: str) -> bool:
        e: Optional[Env] = self
        while e is not None:
            if name in e.local:
                return True
            e = e.parent
        return False

    def set(self, name: str, value):
        """Bind in the nearest env that already binds the name (the
        step's own inputs and memories stay local) or whose block
        declares it (a sub-block writes through to its parent's vars)."""
        e: Optional[Env] = self
        while e is not None:
            if name in e.local or name in e.block.vars:
                e.local[name] = value
                return
            e = e.parent
        self.local[name] = value

    def snapshot(self) -> Dict[str, object]:
        """Every binding visible here, nearer envs shadowing outer ones."""
        chain = []
        e: Optional[Env] = self
        while e is not None:
            chain.append(e)
            e = e.parent
        out: Dict[str, object] = {}
        for e in reversed(chain):
            out.update(e.local)
        return out


# ---------------------------------------------------------------------------
# Context passed to op implementations
# ---------------------------------------------------------------------------
class ExecContext:
    """What an op implementation may consult: the device, test mode, AMP,
    the 1x1-conv routing, per-op random generators, the env it runs in
    (``env``, bound by ``run_op``), sub-blocks, and the ``@LEN`` /
    ``@LEN2`` length companions of sequence vars."""

    def __init__(self, program: Program, device: torch.device, step: int,
                 is_test: bool = False,
                 conv1x1_pallas: Optional[bool] = None, amp: bool = False):
        self.program = program
        self.device = device
        self.step = step
        self.is_test = is_test
        self.amp = amp
        # tri-state 1x1-conv kernel routing (None = defer to the flag);
        # consulted by ops.nn_ops._conv2d
        self.conv1x1_pallas = conv1x1_pallas
        self.op: Optional[Operator] = None
        self.env: Optional[Env] = None
        self._op_uid = 0

    def block(self, idx: int) -> Block:
        return self.program.blocks[idx]

    def interpret_block(self, block_idx: int, env: Env):
        interpret_ops(self.program.blocks[block_idx].ops, env, self)

    def child_env(self, block_idx: int, parent_env: Env) -> Env:
        return Env(self.program.blocks[block_idx], parent=parent_env)

    def get_len(self, name: str):
        """Lengths [B] of a lod_level>0 var (its ``@LEN``), or None."""
        ln = name + "@LEN"
        return self.env.get(ln) if self.env.has(ln) else None

    def set_len(self, name: str, lens):
        self.env.local[name + "@LEN"] = lens

    def get_len2(self, name: str):
        """Inner lengths [B, S] of a lod_level-2 var (its ``@LEN2``), or
        None."""
        ln = name + "@LEN2"
        return self.env.get(ln) if self.env.has(ln) else None

    def set_len2(self, name: str, lens2):
        self.env.local[name + "@LEN2"] = lens2

    def generator(self) -> torch.Generator:
        """A generator for the current op, seeded from (program seed, run
        counter, op position, op seed attr): reproducible per program and
        different on every run, like the JAX executor's folded keys."""
        seed = int(self.op.attrs.get("seed", 0) or 0) if self.op else 0
        mixed = 0
        for part in (self.program.random_seed, self.step, self._op_uid, seed):
            mixed = (mixed * 0x9E3779B97F4A7C15 + int(part) + 1) % (1 << 63)
        g = torch.Generator(device=self.device)
        g.manual_seed(mixed)
        return g


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------
def _normalize_outputs(op: Operator, result) -> Dict[str, List]:
    if result is None:
        return {}
    if not isinstance(result, dict):
        slots = [s for s, ns in op.outputs.items() if ns]
        if len(slots) != 1:
            raise ValueError(f"op {op.type}: ambiguous single-value return")
        result = {slots[0]: result}
    return {slot: val if isinstance(val, list) else [val]
            for slot, val in result.items()}


def run_op(op: Operator, env: Env, ctx: ExecContext):
    impl = get_op_impl(op.type)
    ins = {slot: [env.get(n) for n in names]
           for slot, names in op.inputs.items() if names}
    prev_op, prev_env = ctx.op, ctx.env
    ctx.op, ctx.env = op, env
    ctx._op_uid += 1
    try:
        result = impl(ctx, ins, op.attrs)
    except Exception as e:
        # name the op and its operand shapes so an error points at the
        # graph site, not only at the torch call inside the op
        shapes = {slot: [tuple(v.shape) if hasattr(v, "shape") else None
                         for v in vals]
                  for slot, vals in ins.items()}
        e.add_note(f"[paddle_tpu_torch] while running op {op.type!r} "
                   f"(outputs {op.outputs}) with input shapes {shapes}")
        raise
    finally:
        ctx.op, ctx.env = prev_op, prev_env
    outs = _normalize_outputs(op, result)
    for slot, names in op.outputs.items():
        if not names:
            continue
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) != len(names):
            raise ValueError(
                f"op {op.type} slot {slot}: produced {len(vals)} values for "
                f"{len(names)} outputs {names}")
        for n, v in zip(names, vals):
            if v is not None:
                env.set(n, v)


def interpret_ops(ops: Sequence[Operator], env: Env, ctx: ExecContext):
    for op in ops:
        run_op(op, env, ctx)


def interpret_block_with_backward(block: Block, env: Env, ctx: ExecContext):
    """Interpret a block, splitting at a top-level ``backward`` op so the
    forward slice runs exactly once under autograd; everything else runs
    without it."""
    bw_idx = next((i for i, op in enumerate(block.ops)
                   if op.type == "backward"), None)
    if bw_idx is None:
        with torch.no_grad():
            interpret_ops(block.ops, env, ctx)
        return
    _run_backward(block.ops[:bw_idx], block.ops[bw_idx], env, ctx)
    with torch.no_grad():
        interpret_ops(block.ops[bw_idx + 1:], env, ctx)


def _run_backward(forward_ops: Sequence[Operator], bw_op: Operator,
                  env: Env, ctx: ExecContext):
    """Run the ``backward`` pseudo-op inserted by append_backward.

    attrs: loss (var name), params (names to differentiate).  Produces
    ``<p>@GRAD`` for every p in params and puts every forward var into
    ``env``, detached, so later fetches and ops see them.

    AMP (the JAX recipe, ``paddle_tpu/core/executor.py:371-409``): the
    forward env holds bf16 copies of the state and of the wrt leaves,
    which stay fp32, so the gradients come back fp32 through the cast;
    the loss is cast to fp32; the master fp32 params are set back before
    the post-backward (optimizer) ops run.
    """
    loss_name = bw_op.attrs["loss"]
    wrt_names = list(bw_op.attrs["params"])
    init = env.snapshot()
    masters = {n: init[n] for n in wrt_names}
    leaves = [masters[n].detach().requires_grad_(True) for n in wrt_names]
    fenv = Env(env.block)
    if ctx.amp:
        fenv.local.update({k: _to_bf16(v) for k, v in init.items()})
        fenv.local.update({n: _to_bf16(v) for n, v in zip(wrt_names, leaves)})
    else:
        fenv.local.update(init)
        fenv.local.update(zip(wrt_names, leaves))
    with torch.enable_grad():
        interpret_ops(forward_ops, fenv, ctx)
        loss = fenv.get(loss_name)
        if loss.dim() > 0:
            if loss.numel() != 1:
                raise ValueError(
                    f"append_backward loss {loss_name!r} must be a scalar, "
                    f"got shape {tuple(loss.shape)}")
            loss = loss.reshape(())
        if ctx.amp:
            loss = loss.float()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for name, val in fenv.local.items():
        env.set(name, val.detach() if isinstance(val, torch.Tensor) else val)
    if ctx.amp:
        env.local.update(masters)
    env.set(loss_name, loss.detach())
    for n, leaf, g in zip(wrt_names, leaves, grads):
        # a param the loss does not reach gets a zero gradient, as under
        # jax.grad
        env.set(grad_var_name(n), torch.zeros_like(leaf) if g is None
                else g.to(leaf.dtype))


def _to_bf16(v):
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
        return v.to(torch.bfloat16)
    return v


# ---------------------------------------------------------------------------
# Feed staging helpers (host side of the input pipeline)
# ---------------------------------------------------------------------------
def stack_feeds(feeds: Sequence[Dict[str, object]]) -> Dict[str, np.ndarray]:
    """Stack K same-signature host feed dicts along a new leading axis.

    Every dict must carry the same keys with same-shaped values; the
    result's entries have shape ``[K, ...]``."""
    if not feeds:
        raise ValueError("stack_feeds: need at least one feed dict")
    keys = feeds[0].keys()
    for f in feeds[1:]:
        if f.keys() != keys:
            raise ValueError(
                f"stack_feeds: feed keys differ: {sorted(keys)} vs "
                f"{sorted(f.keys())}")
    return {k: np.stack([np.asarray(f[k]) for f in feeds]) for k in keys}


def pad_batch(stacked: Dict[str, np.ndarray], to: int) -> Dict[str, np.ndarray]:
    """Pad every entry of a stacked feed dict (leading batch axis) up to
    ``to`` rows by repeating the first row.

    The serving batcher rounds a coalesced batch up to its bucket size
    with this.  Repeating a REAL row keeps the pad rows inside the
    model's input distribution; row-wise models make pad rows independent
    of live rows, which are sliced back out before delivery."""
    if to < 1:
        raise ValueError(f"pad_batch: target size must be >= 1, got {to}")
    out: Dict[str, np.ndarray] = {}
    for k, v in stacked.items():
        a = np.asarray(v)
        if a.ndim < 1:
            raise ValueError(
                f"pad_batch: entry {k!r} has no leading batch axis")
        n = a.shape[0]
        if n > to:
            raise ValueError(
                f"pad_batch: entry {k!r} already has {n} rows > target {to}")
        if n == to:
            out[k] = a
        else:
            pad = np.broadcast_to(a[:1], (to - n,) + a.shape[1:])
            out[k] = np.concatenate([a, pad], axis=0)
    return out


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------
class Executor:
    """Run a Program on one device (``place``, default ``CUDAPlace(0)``).

    ``amp=True``: a program with no ``backward`` op (inference) computes
    entirely in bf16 — fp32 feeds and state are cast on entry, and state
    keeps its fp32 dtype in the scope.  A training program computes its
    forward and backward in bf16 against fp32 master parameters, whose
    fp32 gradients the optimizer ops apply (``_run_backward``).
    ``conv1x1_pallas``: per-executor
    override of the 1x1-conv kernel routing (None defers to the flag; a
    per-op ``use_pallas`` attr overrides both)."""

    def __init__(self, place: Optional[Place] = None, amp: bool = False,
                 conv1x1_pallas: Optional[bool] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self.amp = amp
        self.conv1x1_pallas = conv1x1_pallas
        self._step = 0

    def _feed_tensor(self, gb: Block, name: str, val) -> torch.Tensor:
        want = to_torch_dtype(gb.var(name).dtype) if gb.has_var(name) \
            else None
        if isinstance(val, torch.Tensor):
            t = val
        else:
            arr = np.asarray(val)
            if arr.dtype.name == "bfloat16":   # ml_dtypes array from JAX
                arr = arr.astype(np.float32)
            if not (arr.flags.c_contiguous and arr.flags.writeable):
                arr = np.array(arr, order="C")
            t = torch.from_numpy(arr)
        t = t.to(self.device, non_blocking=True)
        if want is not None and t.dtype != want:
            t = t.to(want)
        return t

    @staticmethod
    def _state_keys(program: Program, scope: Scope) -> List[str]:
        """Persistable vars referenced by the program that exist in scope."""
        referenced = set()
        for b in program.blocks:
            for op in b.ops:
                referenced.update(op.input_names)
                referenced.update(op.output_names)
        keys = []
        for name in sorted(referenced):
            for b in program.blocks:
                if name in b.vars:
                    if b.vars[name].persistable and scope.has(name):
                        keys.append(name)
                    break
        return keys

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, object]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            is_test: bool = False):
        from .program import default_main_program
        program = program or default_main_program()
        scope = global_scope() if scope is None else scope
        gb = program.global_block()
        feeds = {k: self._feed_tensor(gb, k, v)
                 for k, v in (feed or {}).items()}
        fetches = self._run_once(program, feeds, _fetch_names(fetch_list),
                                 scope, is_test)
        if return_numpy:
            fetches = [to_numpy(f) if f is not None else None
                       for f in fetches]
        return fetches

    def run_steps(self, num_steps: int,
                  program: Optional[Program] = None,
                  feed: Optional[Dict[str, object]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True,
                  is_test: bool = False,
                  feeds_stacked: bool = False):
        """Run ``num_steps`` steps of ``program`` back to back, with the
        state kept on the device between steps (the counterpart of the
        JAX executor's device-side scan, run here as a Python loop).

        ``feeds_stacked=False`` reuses ``feed`` for every step.
        ``feeds_stacked=True`` expects every feed to carry a leading
        ``num_steps`` axis: it is copied to the device once, and step i
        reads slice i.  Fetches come back stacked with a leading
        ``num_steps`` axis; the step counter advances by ``num_steps``."""
        from .program import default_main_program
        num_steps = int(num_steps)
        if num_steps < 1:
            raise ValueError(f"run_steps: num_steps must be >= 1, got "
                             f"{num_steps}")
        program = program or default_main_program()
        scope = global_scope() if scope is None else scope
        gb = program.global_block()
        feeds = {}
        for name, val in (feed or {}).items():
            t = self._feed_tensor(gb, name, val)
            if feeds_stacked and tuple(t.shape[:1]) != (num_steps,):
                raise ValueError(
                    f"run_steps(feeds_stacked=True): feed {name!r} must "
                    f"have leading dim {num_steps}, got {tuple(t.shape)}")
            feeds[name] = t
        fetch_names = _fetch_names(fetch_list)
        steps = [self._run_once(program,
                                {k: v[i] for k, v in feeds.items()}
                                if feeds_stacked else feeds,
                                fetch_names, scope, is_test)
                 for i in range(num_steps)]
        fetches = []
        for j in range(len(fetch_names)):
            vals = [s[j] for s in steps]
            fetches.append(None if any(v is None for v in vals)
                           else torch.stack(vals))
        if return_numpy:
            fetches = [to_numpy(f) if f is not None else None
                       for f in fetches]
        return fetches

    def _run_once(self, program: Program, feeds: Dict[str, torch.Tensor],
                  fetch_names: List[str], scope: Scope,
                  is_test: bool) -> List[Optional[torch.Tensor]]:
        """One step: state from the scope, feeds already on the device;
        returns the fetched tensors (on the device)."""
        gb = program.global_block()
        has_backward = any(op.type == "backward" for op in gb.ops)
        env = Env(gb)
        state = {k: scope.get(k) for k in self._state_keys(program, scope)}
        env.local.update(state)
        env.local.update(feeds)
        if self.amp and not has_backward:
            # pure-inference AMP: the whole net computes in bf16
            env.local = {k: _to_bf16(v) for k, v in env.local.items()}
        entry = dict(env.local)
        ctx = ExecContext(program, self.device, self._step, is_test=is_test,
                          conv1x1_pallas=self.conv1x1_pallas, amp=self.amp)
        self._step += 1
        interpret_block_with_backward(gb, env, ctx)
        fetches = [env.get(n) if env.has(n) else None for n in fetch_names]

        # persistables an op produced go back to the scope in the dtype
        # they had there (bn running stats etc. stay fp32 under AMP); a
        # value an op passed through unchanged is not written back
        written = {n for op in gb.ops for n in op.output_names}
        for name, var in gb.vars.items():
            if not (var.persistable and name in written and env.has(name)):
                continue
            v = env.get(name)
            if name in entry and v is entry[name]:
                continue
            old = state.get(name)
            if old is not None and v.dtype != old.dtype:
                v = v.to(old.dtype)
            scope.set(name, v)
        return fetches


def _fetch_names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]
