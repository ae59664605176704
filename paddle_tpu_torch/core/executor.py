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
the fetches stacked on a leading K axis.  On a card each step is a
replay of a CUDA graph captured from the interpreter (``_CapturedStep``,
cached by fingerprint in ``core/compile_cache.py``), the counterpart of
the JAX executor's compiled step; ``run_pipelined`` overlaps the feeds'
staging with the steps.

A sub-block (the step of a ``StaticRNN``) runs in a child ``Env`` whose
lookups fall through to its parent's; sequence vars carry their lengths
as ``name@LEN`` integer companions (fed, or set by ops through
``ExecContext.set_len``), which no AMP cast touches.

``as_module`` gives an inference program as an ``nn.Module`` over the
same interpreter (``ProgramModule``), the form ``torch.export`` traces
(``export_model.py``).

Dispatch retries: ``Executor(retry_policy=faults.RetryPolicy(...))``
retries a run's dispatch after a retryable failure (``faults.classify``)
that came before any of its steps ran; the ``executor.dispatch`` fault
site fires there (``testing/faultinject.py``).

Observability (``observability/``): ``Executor(observe=True)`` (or the
``observe`` flag) records each dispatch's telemetry (the ``executor/*``
metrics, a ``step`` event, the ``executor/step``, ``executor/dispatch``
and ``executor/fetch_block`` spans, a ``record_function`` range around
the dispatch), all on the host and around a captured step's replay,
never inside it; ``observe`` is not part of a captured step's key.
``check_nan_inf=True`` reads one stacked tensor of per-var finite flags
after each ``run`` step and raises ``FloatingPointError`` naming the
first producer in program order, with the eager bisect's diagnosis
(``observability/nanprov.py``); ``compute_dtype`` upcasts floating
feeds, state and op outputs (float64 runs of a program).

Validation (``analysis/``): ``Executor(validate=True)`` (or the
``validate`` flag) runs the static verifier once per (program version,
fetches) in ``run``, ``run_steps`` and ``run_pipelined``, before the
step's capture key is taken: an invalid program raises
``ProgramVerificationError`` and is never interpreted or captured, and a
captured replay never pays for the check.  ``analysis`` is imported only
when validation is on.

Autotuning (``tuning/``): ``Executor(autotune=True)`` (or the
``autotune`` flag) makes ``run_pipelined`` take omitted knobs from the
persisted ``executor/run_pipelined`` winner; off, or with no record, the
defaults are today's (4, 2).  ``tuning`` is imported only when it is on.

Ahead of the first call: ``compile(program, feed, fetch_list, ...)``
builds the step of the key ``run`` would take (feeds may be example
arrays, ``(shape, dtype)`` tuples or tensors on the ``meta`` device) and
returns a ``compile_cache.CompiledProgram``; on a card the step is
warmed up without committing and captured, so the first ``run`` of the
key replays.  With the ``cache_dir`` flag set, what a cold compile
learned is kept on disk (``compile_cache.disk_store``), and a warm
compile in a later process builds the same step and reports it.
"""
from __future__ import annotations

import collections
import threading
import time
import warnings
import weakref
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults as _faults
from .. import observability as obs
from ..flags import get_flag
from ..testing import faultinject as _fi
from . import compile_cache
from .program import Block, Operator, Program, Variable, grad_var_name
from .registry import get_op_impl, register_tunable, resolve_tuned
from .scope import Scope, global_scope, to_numpy
from .types import to_torch_dtype

# ---------------------------------------------------------------------------
# Autotuner knob (paddle_tpu_torch.tuning), declared beside the code it
# controls; nothing loads the tuning package until an opt-in replays it.
# The JAX package's space and default (its core/executor.py:53).
# ---------------------------------------------------------------------------
register_tunable(
    "executor/run_pipelined", side="host",
    space={"steps_per_dispatch": (1, 2, 4, 8, 16),
           "prefetch_depth": (1, 2, 4)},
    default={"steps_per_dispatch": 4, "prefetch_depth": 2},
    description="run_pipelined dispatch chunking: steps stacked per "
                "captured K-step dispatch, and staged dispatches in "
                "flight.  Larger K amortizes the host's dispatch; deeper "
                "prefetch hides staging; both cost memory and tail "
                "latency, and the right point depends on the workload "
                "and the host.")


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
                 conv1x1_pallas: Optional[bool] = None, amp: bool = False,
                 streams: Optional[Dict[tuple, torch.Generator]] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.program = program
        self.device = device
        self.step = step
        self.is_test = is_test
        self.amp = amp
        # tri-state 1x1-conv kernel routing (None = defer to the flag);
        # consulted by ops.nn_ops._conv2d
        self.conv1x1_pallas = conv1x1_pallas
        # precision-instrument mode: run_op upcasts floating op outputs
        # so constants made in the step (fill_constant) do not leak fp32
        # into a float64 step
        self.compute_dtype = compute_dtype
        self.op: Optional[Operator] = None
        self.env: Optional[Env] = None
        # the op last started (a failed capture names it)
        self.last_op: Optional[Operator] = None
        # the random ops' generators by stream key (the executor keeps
        # one table a program); a capture sets ``capturing``, and the
        # replay places the streams at the step instead
        self.streams = {} if streams is None else streams
        self.capturing = False
        self._placed = set()
        # Executor.compile's capture records the step listing here: one
        # entry a global-block op and the backward, with its route
        self.listing: Optional[List[dict]] = None
        # a sharded executor's step (parallel/sharded.py): each op's
        # collectives and the specs of the values it binds
        self.shard = None

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

    def stream(self, key: tuple) -> torch.Generator:
        """The generator of stream ``key`` (``_stream_key``), made and
        seeded on first use."""
        seeded = (self.program.random_seed,) + key
        g = self.streams.get(seeded)
        if g is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(_mix(*seeded))
            self.streams[seeded] = g
        return g

    def generator(self) -> torch.Generator:
        """The current op's generator: one stream a (op position, op
        seed attr), seeded once from (program seed, position, seed
        attr).  Its first use in a step places it at the step
        (``place_stream``), so a step's draws are a function of (program
        seed, step, op) alone, the same interpreted and replayed from a
        CUDA graph, and an op that runs again within the step (in a
        sub-block) draws on from there."""
        key = _stream_key(self.program, self.op)
        g = self.stream(key)
        if key not in self._placed:
            self._placed.add(key)
            if not self.capturing:
                place_stream(g, self.program, key, self.step)
        return g


# Random ops draw from ExecContext.generator; dropout only in training.
RANDOM_OPS = ("uniform_random", "gaussian_random", "dropout",
              "truncated_gaussian_random", "sampling_id", "shuffle", "nce")
# A step's draws of one stream start STEP_OFFSET Philox counters after
# the previous step's: far more than one op draws in a step (a call
# advances the counter by 4 per element a thread handles, at most).
STEP_OFFSET = 1 << 32


def _mix(*parts) -> int:
    mixed = 0
    for part in parts:
        mixed = (mixed * 0x9E3779B97F4A7C15 + int(part) + 1) % (1 << 63)
    return mixed


def _stream_key(program: Program, op: Optional[Operator]) -> tuple:
    """(block index, op index, op seed attr) of ``op`` in ``program``;
    an op called outside the program's blocks is at (-1, -1)."""
    if op is None:
        return (-1, -1, 0)
    pos = _memo(program, "op_positions", lambda: {
        id(o): (b.idx, i) for b in program.blocks
        for i, o in enumerate(b.ops)}).get(id(op), (-1, -1))
    return pos + (int(op.attrs.get("seed", 0) or 0),)


def place_stream(g: torch.Generator, program: Program, key: tuple,
                 step: int):
    """Put stream ``key``'s generator where step ``step`` starts.  On a
    card: its Philox offset at ``step * STEP_OFFSET`` (a replay reads the
    offset set before it, so a captured step draws what the interpreter
    draws).  The CPU generator (mt19937) has no counter offset: the step
    is folded into its seed."""
    if g.device.type == "cuda":
        g.set_offset(step * STEP_OFFSET)
    else:
        g.manual_seed(_mix(program.random_seed, *key, step))


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


def _counts() -> list:
    return [collections.Counter(c) for c in compile_cache.launch_counters()]


def _list_op(ctx: ExecContext, op: Operator, before: list):
    """Append ``op``'s entry to the step listing: its position, type, the
    kernel launches it made since ``before`` and its route."""
    deltas = [collections.Counter(c) - b for c, b in
              zip(compile_cache.launch_counters(), before)]
    launched = compile_cache.counter_deltas(deltas, ("launches",))
    ctx.listing.append({"index": _stream_key(ctx.program, op)[1],
                        "op": op.type,
                        "route": "kernel" if launched else "other",
                        "launches": launched})


def _static_listing(program: Program) -> List[dict]:
    """The step listing without a run (the CPU, where nothing launches a
    kernel, or a step that runs uncaptured): every global-block op, none
    on a kernel's route, an op of ``UNCAPTURED_OPS`` on the ``host``'s."""
    return [{"index": i, "op": op.type,
             "route": "host" if op.type in UNCAPTURED_OPS else "other",
             "launches": {}}
            for i, op in enumerate(program.global_block().ops)]


def run_op(op: Operator, env: Env, ctx: ExecContext):
    if ctx.listing is not None and env.block.idx == 0:
        before = _counts()
        _run_op(op, env, ctx)
        _list_op(ctx, op, before)
        return
    _run_op(op, env, ctx)


def _run_op(op: Operator, env: Env, ctx: ExecContext):
    impl = get_op_impl(op.type)
    ins = {slot: [env.get(n) for n in names]
           for slot, names in op.inputs.items() if names}
    prev_op, prev_env = ctx.op, ctx.env
    ctx.op, ctx.env = op, env
    ctx.last_op = op
    try:
        if ctx.shard is None:
            result = impl(ctx, ins, op.attrs)
        else:
            result = ctx.shard.call(op, impl, ctx, ins)
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
        cd = ctx.compute_dtype
        for n, v in zip(names, vals):
            if v is not None:
                if cd is not None and isinstance(v, torch.Tensor) \
                        and v.is_floating_point() and v.dtype != cd:
                    v = v.to(cd)
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
        before = _counts() if ctx.listing is not None else None
        if ctx.shard is None:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            # the loss seeded on every rank, the replicated parameters'
            # partial gradients summed (parallel/sharded.py)
            grads = ctx.shard.grads(loss, leaves, wrt_names)
        if before is not None:
            _list_op(ctx, bw_op, before)
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


def _upcast(env_local: Dict[str, object], dtype: Optional[torch.dtype]):
    """``compute_dtype`` at step entry: every floating tensor in
    ``dtype``."""
    if dtype is None:
        return env_local
    return {k: v.to(dtype) if isinstance(v, torch.Tensor)
            and v.is_floating_point() and v.dtype != dtype else v
            for k, v in env_local.items()}


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
# Per-program memo (keyed by the program object and its version)
# ---------------------------------------------------------------------------
_MEMO_MAX = 64


def _memo(program: Program, key, compute):
    """``compute()`` once per (program object, version, key): the
    executor's per-step scans of the op lists happen once per program
    mutation, as the JAX executor memoizes ``_state_keys``."""
    tag = (id(program), program.version)
    memo = program.__dict__.get("_exec_memo")
    if memo is None or memo[0] != tag:
        memo = (tag, {})
        program._exec_memo = memo
    table = memo[1]
    if key not in table:
        if len(table) > _MEMO_MAX:
            table.clear()
        table[key] = compute()
    return table[key]


# ops a CUDA graph cannot hold, each its own reason to run a step
# uncaptured: a loop whose trip count is data, a branch chosen by a
# predicate read on the host, a print that must print at every run
UNCAPTURED_OPS = ("while", "conditional_block", "print")


def uncaptured_op(program: Program) -> Optional[str]:
    """The type of the first op of ``program`` (any block) that
    ``UNCAPTURED_OPS`` names, or None; memoized per program version."""
    return _memo(program, "uncaptured_op", lambda: next(
        (op.type for b in program.blocks for op in b.ops
         if op.type in UNCAPTURED_OPS), None))


def _has_backward(program: Program) -> bool:
    return _memo(program, "has_backward", lambda: any(
        op.type == "backward" for op in program.global_block().ops))


def _written_persistables(program: Program) -> List[str]:
    """Persistables of the global block some op of it writes, in the
    block's var order (the order the write-back visits them)."""
    def compute():
        gb = program.global_block()
        written = {n for op in gb.ops for n in op.output_names}
        return [name for name, var in gb.vars.items()
                if var.persistable and name in written]
    return _memo(program, "written", compute)


def _random_streams(program: Program, is_test: bool) -> List[tuple]:
    """The stream keys of the ops a step of ``program`` draws random
    numbers in (``RANDOM_OPS``; dropout only in training): a capture
    registers their generators with the graph."""
    def compute():
        return [_stream_key(program, op) for b in program.blocks
                for op in b.ops if op.type in RANDOM_OPS and not (
                    op.type == "dropout"
                    and (is_test or op.attrs.get("is_test", False)))]
    return _memo(program, ("random", bool(is_test)), compute)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# One step captured as a CUDA graph
# ---------------------------------------------------------------------------
class _CapturedStep:
    """A step of one (program, feed signature, fetches, state, config)
    key, captured as a CUDA graph over static buffers.

    Inputs are the static feed and state buffers, filled before each
    replay outside the graph: feeds by a copy, and every state entry for
    which the scope holds a tensor other than this step's own buffer (a
    ``scope.set`` from outside, another scope, or another captured step's
    buffer: a replay writes its buffers in place and leaves their
    ``_version`` as it was, so nothing short of a copy sees what it
    wrote); the step ends by copying every persistable an op produced
    into its state buffer, in the dtype the scope held, and after a
    replay the scope points at those buffers.  Fetches are copied out of
    the graph's buffers.  ``nbytes`` is what the graph's private memory
    pool holds after the capture.

    A thread's first step of the key runs interpreted (the warm-up: the
    thread's cuDNN and cuBLAS handles, which PyTorch keeps per thread,
    are made there); ``warm_threads`` holds the threads that took one.
    The next step in a warm thread captures (and replays once).

    The generators of the step's random ops (``streams``) are registered
    with the graph, and before each replay each is placed at the step
    (``place_stream``): the replay draws what an interpreted step with
    that index draws."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm_threads = set()
        self.static_feeds: Dict[str, torch.Tensor] = {}
        self.static_state: Dict[str, torch.Tensor] = {}
        self.nbytes = 0
        self.fetches: List[Optional[torch.Tensor]] = []
        self.written: List[str] = []
        self.new_outputs: Dict[str, torch.Tensor] = {}
        self.deltas: List[collections.Counter] = []
        self.streams: List[tuple] = []
        # check_nan_inf: the names of the finite flags and the graph's
        # flags tensor
        self.finite = None
        # the compile_cache.CachedStep of a step built by Executor.compile
        self.cached = None

    def capture(self, exe: "Executor", program: Program,
                feeds: Dict[str, torch.Tensor], scope: Scope,
                state_keys: List[str], fetch_names: List[str],
                is_test: bool, listing: Optional[List[dict]] = None):
        self.static_feeds = {k: v.clone() for k, v in feeds.items()}
        self.static_state = {k: scope.get(k).clone() for k in state_keys}
        owned = {_storage(t) for t in (*self.static_feeds.values(),
                                       *self.static_state.values())}

        def own(v):
            # a value sharing a static buffer's storage is copied inside
            # the graph, before the state write-back can change it
            if isinstance(v, torch.Tensor) and _storage(v) in owned:
                return v.clone()
            return v

        ctx = exe._context(program, is_test)
        ctx.capturing = True
        ctx.listing = listing
        graph = torch.cuda.CUDAGraph()
        self.streams = [(key, ctx.stream(key))
                        for key in _random_streams(program, is_test)]
        register = getattr(graph, "register_generator_state", None)
        if self.streams and register is None:
            raise RuntimeError(
                f"paddle_tpu_torch: this torch ({torch.__version__}) cannot "
                f"register a generator with a CUDA graph "
                f"(CUDAGraph.register_generator_state), so a step that draws "
                f"random numbers cannot be captured; run it with "
                f"Executor(use_jit=False)")
        for _, g in self.streams:
            register(g)
        try:
            with compile_cache.capture_launches(self.deltas), \
                    torch.cuda.graph(graph, stream=exe._side,
                                     capture_error_mode="thread_local"):
                fetches, writes, finite = exe._interpret_step(
                    program, ctx, self.static_state, self.static_feeds,
                    fetch_names)
                self.fetches = [own(f) for f in fetches]
                self.finite = finite
                writes = {k: own(v) for k, v in writes.items()}
                for k, v in writes.items():
                    if k in self.static_state:
                        self.static_state[k].copy_(v)
                    else:
                        self.new_outputs[k] = v
        except Exception as e:
            op = ctx.last_op
            where = f"op {op.type!r} (outputs {op.outputs})" if op else \
                "the step's start"
            cause = str(e).strip().splitlines()[0] if str(e).strip() else ""
            raise RuntimeError(
                f"paddle_tpu_torch: capturing the step of a program as a "
                f"CUDA graph failed at {where} ({type(e).__name__}: "
                f"{cause}); run it with Executor(use_jit=False) to step it "
                f"uncaptured") from e
        self.written = [k for k in writes if k in self.static_state]
        self.graph = graph
        pool = tuple(graph.pool())
        self.nbytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)

    def load_state(self, scope: Scope):
        """Copy in every state entry whose scope tensor is not this
        step's own buffer, in one multi-tensor copy (a served program
        copies in every weight before each batch)."""
        dst, src = [], []
        for k, buf in self.static_state.items():
            t = scope.get(k)
            if t is not buf:
                dst.append(buf)
                src.append(t)
        if dst:
            torch._foreach_copy_(dst, src)

    def replay(self, program: Program, feeds: Dict[str, torch.Tensor],
               step: int):
        for k, v in feeds.items():
            self.static_feeds[k].copy_(v)
        for key, g in self.streams:
            place_stream(g, program, key, step)
        self.graph.replay()
        compile_cache.replay_launches(self.deltas)

    def publish(self, scope: Scope):
        for k in self.written:
            scope.set(k, self.static_state[k])
        for k, v in self.new_outputs.items():
            scope.set(k, v)

    def close(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.static_feeds, self.static_state = {}, {}
        self.fetches, self.new_outputs = [], {}
        self.streams = []
        self.finite = None
        self.cached = None


# ---------------------------------------------------------------------------
# A program as a function: the executor's functional entry
# ---------------------------------------------------------------------------
class ProgramModule(torch.nn.Module):
    """An inference program as an ``nn.Module`` (``Executor.as_module``):
    the program's state are its buffers (the scope's tensors, shared, not
    copied), and ``forward(**feeds)`` interprets the global block through
    :func:`interpret_ops`, as ``Executor.run`` does, and returns the
    fetches as a tuple.  It keeps no step counter and writes nothing
    back, so ``torch.export`` can trace it: the counterpart of the JAX
    executor's ``_make_fn`` over ``_state_keys``."""

    def __init__(self, exe: "Executor", program: Program,
                 fetch_names: List[str], state: Dict[str, torch.Tensor]):
        super().__init__()
        if _has_backward(program):
            raise ValueError("Executor.as_module: the program has a "
                             "backward op; prune it to an inference slice "
                             "(Program.prune(...).clone(for_test=True))")
        self.program = program
        self.fetch_names = list(fetch_names)
        self._exe = exe
        self._slots = {}
        for name, t in state.items():
            slot = name.replace(".", "__")
            if slot in self._slots.values():
                raise ValueError(f"Executor.as_module: state names "
                                 f"{name!r} and another map to one buffer "
                                 f"name {slot!r}")
            self._slots[name] = slot
            self.register_buffer(slot, t)

    def forward(self, **feeds):
        gb = self.program.global_block()
        env = Env(gb)
        env.local.update({name: getattr(self, slot)
                          for name, slot in self._slots.items()})
        env.local.update(feeds)
        if self._exe.amp:
            env.local = {k: _to_bf16(v) for k, v in env.local.items()}
        ctx = ExecContext(self.program, self._exe.device, 0, is_test=True,
                          conv1x1_pallas=self._exe.conv1x1_pallas,
                          amp=self._exe.amp)
        interpret_ops(gb.ops, env, ctx)
        return tuple(env.get(n) for n in self.fetch_names)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------
class Executor:
    """Run a Program on one device (``place``, default ``CUDAPlace(0)``).
    The parameters come in the JAX package's order (``place``,
    ``use_jit``, ``check_nan_inf``, ``amp``, ``auto_layout``,
    ``compiler_options``, ...), so ``Executor(place, True)`` is a captured
    run in both.  ``auto_layout`` and ``compiler_options`` are XLA's and
    only their defaults are accepted.

    ``use_jit=True`` (the default) on a card: ``run`` and ``run_steps``
    dispatch each step as a replay of a CUDA graph captured from the
    interpreter, cached by fingerprint (``core/compile_cache.py``): the
    content digest, the per-step feed signature, the fetch names, the
    state keys with their shapes and dtypes, ``is_test``, ``amp``,
    ``conv1x1_pallas`` and the device.  A key's first step runs
    interpreted on the capture's side stream (the warm-up: kernels build,
    cuBLAS makes its handles there); its second step is captured and
    replayed; later steps replay.  Random ops (``RANDOM_OPS``: dropout
    in training, ``uniform_random``, ``gaussian_random``,
    ``truncated_gaussian_random``, ``sampling_id``, ``shuffle``) draw
    from one generator an op, kept per (executor, program) and placed at
    each step's index (``ExecContext.generator``), so a step draws the same numbers
    interpreted, warmed up or replayed, and differs from step to step.
    A failed capture raises, and so does a step with a random op on a
    torch that cannot register a generator with a graph.
    ``use_jit=False``, or a CPU place, steps the interpreter (the
    debugging path, as ``use_jit=False`` in the JAX package).

    ``amp=True``: a program with no ``backward`` op (inference) computes
    entirely in bf16 — fp32 feeds and state are cast on entry, and state
    keeps its fp32 dtype in the scope.  A training program computes its
    forward and backward in bf16 against fp32 master parameters, whose
    fp32 gradients the optimizer ops apply (``_run_backward``).
    ``conv1x1_pallas``: per-executor override of the 1x1-conv kernel
    routing (None defers to the flag; a per-op ``use_pallas`` attr
    overrides both).  ``retry_policy``: a ``faults.RetryPolicy`` for
    the dispatch of each ``run``/``run_steps`` (``dispatch_retries``
    counts the retries taken).  ``observe``: per-executor override of the
    ``observe`` flag (step telemetry, spans, the JSONL log; host side
    only, not part of the step's key).  ``check_nan_inf``: check every
    floating var of each ``run`` step for NaN/Inf (one host read of the
    stacked flags after the step) and raise ``FloatingPointError`` naming
    the first producer, with the eager bisect's diagnosis; ``run_steps``
    and ``run_pipelined`` refuse it.  ``compute_dtype`` (e.g.
    ``"float64"``): floating feeds, state and op outputs computed in this
    dtype, the scope keeping each persistable's own dtype.
    ``validate``: run the static program verifier (``analysis``) before
    a program's first step, once per (program version, fetches); None
    defers to the ``validate`` flag.  Errors raise
    ``ProgramVerificationError`` before any capture; warnings are
    emitted as Python warnings.  Not part of the step's key.
    ``autotune``: replay persisted autotuner winners into this
    executor's tuned knobs (``run_pipelined``'s omitted ones); None
    defers to the ``autotune`` flag.

    Each captured step keeps a private memory pool about one step's
    activations in size.  At most ``MAX_CACHED_STEPS`` captured steps are
    kept, and their pools hold at most ``GRAPH_BYTES_SHARE`` of the
    card's memory, least recently used first out; ``close()`` releases them all.  The captured path is made
    for fixed shapes: every new feed shape is a new key, which pays an
    interpreted warm-up step and a capture before it replays, so traffic
    whose shapes change every few steps (ragged batches each padded to
    their own longest row) runs slower than ``use_jit=False`` until its
    keys repeat (``PERF.md`` §5, ``[seq2seq]``'s ragged window)."""

    MAX_CACHED_STEPS = 64
    GRAPH_BYTES_SHARE = 0.5

    def __init__(self, place: Optional[Place] = None, use_jit: bool = True,
                 check_nan_inf: bool = False, amp: bool = False,
                 auto_layout: bool = False,
                 compiler_options: Optional[Dict[str, object]] = None,
                 compute_dtype: Optional[str] = None,
                 conv1x1_pallas: Optional[bool] = None,
                 validate: Optional[bool] = None,
                 observe: Optional[bool] = None,
                 retry_policy=None,
                 autotune: Optional[bool] = None):
        if auto_layout:
            raise ValueError(
                "Executor(auto_layout=True): XLA's choice of parameter "
                "layouts has no counterpart on the card; the port keeps "
                "PyTorch's layouts")
        if compiler_options:
            raise ValueError(
                f"Executor(compiler_options={compiler_options!r}): XLA "
                f"compiler options have no counterpart on the card")
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self.amp = amp
        self.observe = observe
        self.check_nan_inf = bool(check_nan_inf)
        self.compute_dtype = compute_dtype
        self.conv1x1_pallas = conv1x1_pallas
        self.use_jit = use_jit
        self.retry_policy = retry_policy
        self.dispatch_retries = 0
        self._step = 0
        self._lock = threading.RLock()
        max_bytes = None
        if self.device.type == "cuda" and torch.cuda.is_available():
            max_bytes = int(self.GRAPH_BYTES_SHARE * torch.cuda
                            .get_device_properties(self.device).total_memory)
        self._cache = compile_cache.ExecCache(self.MAX_CACHED_STEPS,
                                              max_bytes)
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # program -> its random ops' generators (ExecContext.streams)
        self._streams = weakref.WeakKeyDictionary()
        # static verification before a program's first step; None defers
        # to the `validate` flag.  Memoized per live Program object
        # (weakly: a dead program drops out, and a successor that reuses
        # its id() is validated afresh) -> {(version, fetches)}
        self.validate = validate
        self._validated = weakref.WeakKeyDictionary()
        # persisted-autotuner replay; None defers to the `autotune` flag
        self.autotune = autotune

    def graph_pools(self) -> list:
        """The memory-pool handles of the captured steps' graphs (the
        caching allocator's ``segment_pool_id`` of their segments)."""
        return [tuple(v.graph.pool()) for v in self._cache.values()
                if v.graph is not None]

    def close(self):
        """Drop every captured step (their graphs and memory pools)."""
        with self._lock:
            self._cache.clear()

    # -- feeds, state, fingerprints ------------------------------------------
    def _feed_tensor(self, gb: Block, name: str, val) -> torch.Tensor:
        """A feed on the executor's device in its var's dtype; host data
        reaches a card through pinned memory."""
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
        if t.device != self.device:
            if t.device.type == "cpu" and self.device.type == "cuda":
                t = t.pin_memory()
            t = t.to(self.device, non_blocking=True)
        if want is not None and t.dtype != want:
            t = t.to(want)
        return t

    def _state_keys(self, program: Program, scope: Scope) -> List[str]:
        """Persistable vars referenced by the program that exist in
        scope; memoized per (program version, scope, scope key set)."""
        def compute():
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
        return _memo(program, ("state_keys", scope.uid, scope.keys_version),
                     compute)

    def _fingerprint(self, program: Program, step_feeds: Dict[str, object],
                     fetch_names: List[str], scope: Scope,
                     is_test: bool) -> tuple:
        """The captured-step key: a signature tuple (its stable string
        form is ``compile_cache.fingerprint_hex``)."""
        state = tuple((k, tuple(t.shape), str(t.dtype))
                      for k in self._state_keys(program, scope)
                      for t in (scope.get(k),))
        # the 1x1 routing as the ops will resolve it (the executor's
        # setting, else the process flag)
        conv1x1 = self.conv1x1_pallas if self.conv1x1_pallas is not None \
            else bool(get_flag("conv1x1_pallas"))
        return (compile_cache.program_content_digest(program),
                _feed_signature(step_feeds), tuple(fetch_names), state,
                bool(is_test), bool(self.amp), conv1x1, str(self.device),
                self.check_nan_inf, str(self.compute_dtype)) + \
            self._fingerprint_extras(program)

    def _fingerprint_extras(self, program: Program) -> tuple:
        """More components of the captured-step key (a sharded
        executor's mesh and specs); none on one card."""
        return ()

    def _validation_context(self):
        """(mesh axes as an axis->size dict, param_specs, feed_specs)
        for the sharding lints; a one-card executor has no mesh."""
        return None, None, None

    def _observe_label(self) -> Optional[str]:
        """A label for spans and step events (a sharded executor's
        mesh); None on one card."""
        return None

    def _uncaptured_reason(self, program: Program,
                           is_test: bool) -> Optional[str]:
        """Why a step of ``program`` runs interpreted, or None (captured):
        an op a CUDA graph cannot hold (``UNCAPTURED_OPS``, in any block,
        on any device), else the CPU, else ``use_jit=False``.  Decided
        before a capture starts: a capture cannot read a predicate on
        the host."""
        op = uncaptured_op(program)
        if op is not None:
            return op
        if self.device.type != "cuda":
            return "cpu"
        if not self.use_jit:
            return "use_jit=False"
        return None

    # -- validation -----------------------------------------------------------
    def _maybe_validate(self, program: Program, fetch_names: Sequence[str]):
        """Run the static verifier once per (program version, fetches),
        before the step's capture key is taken, so an invalid program is
        never captured.  Clean results memoize (stale versions dropped);
        error reports raise on every call.  A one-card executor has no
        mesh, so the sharding lints do not run; a sharded executor's
        mesh and specs (``_validation_context``) join the memo key and
        run them."""
        want = self.validate
        if want is None:
            want = bool(get_flag("validate"))
        if not want:
            return
        mesh, param_specs, feed_specs = self._validation_context()
        key = (program.version, tuple(fetch_names),
               repr((sorted((mesh or {}).items()),
                     sorted((param_specs or {}).items()),
                     sorted((feed_specs or {}).items()))))
        seen = self._validated.get(program)
        if seen is not None and key in seen:
            return
        from ..analysis import validate_program
        # an EMPTY fetch list (a startup or side-effect run) means the
        # targets are unknown, not that nothing is live: no dead-op lint
        report = validate_program(program,
                                  fetch_list=list(fetch_names) or None,
                                  mesh=mesh, param_specs=param_specs,
                                  feed_specs=feed_specs)
        report.raise_on_error()
        for d in report.warnings:
            warnings.warn(f"program verifier: {d.render()}", stacklevel=3)
        if seen is None:
            seen = self._validated.setdefault(program, set())
        else:
            # versions only grow: a stale version's key never hits again
            seen.difference_update(
                [k for k in seen if k[0] != program.version])
        seen.add(key)

    # -- ahead of the first call ---------------------------------------------
    def compile(self, program: Optional[Program] = None,
                feed: Optional[Dict[str, object]] = None,
                fetch_list: Optional[Sequence] = None,
                scope: Optional[Scope] = None,
                is_test: bool = False,
                num_steps: Optional[int] = None,
                feeds_stacked: bool = False):
        """Build ONE key's step ahead of its first call and install it in
        the executor's cache, so the matching :meth:`run` (or
        :meth:`run_steps`, with ``num_steps``) replays it with no warm-up
        and no capture: the counterpart of the JAX executor's AOT
        ``compile``.

        ``feed`` maps feed names to example arrays or tensors, ``(shape,
        dtype)`` tuples, or tensors on the ``meta`` device (the
        counterpart of ``jax.ShapeDtypeStruct``); a declared var dtype
        overrides, as ``run`` coerces.  A spec has no values, so a spec of
        a ``@LEN``/``@LEN2`` feed (sequence lengths, whose values steer
        the step) is refused: pass an example.  With ``feeds_stacked``
        the feeds carry the leading ``num_steps`` axis, as ``run_steps``
        receives them.  ``run_steps`` replays the single-step key, so
        ``num_steps`` and ``feeds_stacked`` compile that key too.

        Call it after the startup program ran: the scope's state is part
        of the key.  Compile validates (``validate``), takes the key
        ``run`` takes, and on a card warms the step up without committing
        it and captures it: the scope, the step counter and the random
        streams' placement are as they were.  On the CPU there is nothing
        to capture; the returned handle's ``run`` is :meth:`run`.  With
        the ``cache_dir`` flag set, a cold compile stores what it learned
        (``compile_cache.disk_store``), and a warm one (an entry on disk)
        builds the step as a cold one does and reports the entry's facts
        beside its own times.  A program holding an op of
        ``UNCAPTURED_OPS`` is captured on no device: the handle's
        ``step.uncaptured`` names the op, its listing puts the op on the
        ``host`` route, and its steps run interpreted, counted under the
        op.  Returns a
        :class:`~paddle_tpu_torch.core.compile_cache.CompiledProgram`."""
        from .program import default_main_program
        if not self.use_jit:
            raise ValueError("Executor.compile requires use_jit=True")
        if self.check_nan_inf and num_steps is not None:
            raise ValueError("run_steps: check_nan_inf needs per-step host "
                             "inspection; compile the run() step instead")
        if feeds_stacked and num_steps is None:
            raise ValueError(
                "Executor.compile: feeds_stacked=True requires num_steps "
                "(stacked [K, ...] specs describe run_steps' feeds; "
                "without num_steps they would key the wrong shapes)")
        if num_steps is not None and int(num_steps) < 1:
            raise ValueError(f"Executor.compile: num_steps must be >= 1, "
                             f"got {num_steps}")
        program = program or default_main_program()
        scope = global_scope() if scope is None else scope
        fetch_names = _fetch_names(fetch_list)
        gb = program.global_block()
        lead = int(num_steps) if feeds_stacked else None
        with self._lock:
            feeds = {name: self._spec_feed(gb, name, val, lead)
                     for name, val in (feed or {}).items()}
        t0 = time.perf_counter()
        self._maybe_validate(program, fetch_names)
        validate_s = time.perf_counter() - t0
        with self._lock:
            fp = self._fingerprint(program, feeds, fetch_names, scope,
                                   is_test)
            hexfp = compile_cache.fingerprint_hex(fp)
            step = self._compile_step(fp, hexfp, program, feeds,
                                      fetch_names, scope, is_test,
                                      validate_s)
        return compile_cache.CompiledProgram(
            self, program, hexfp, step, fetch_names,
            self._state_keys(program, scope),
            num_steps=None if num_steps is None else int(num_steps),
            feeds_stacked=feeds_stacked, is_test=is_test)

    def _spec_feed(self, gb: Block, name: str, val,
                   lead: Optional[int]) -> torch.Tensor:
        """One step's feed tensor for ``compile``: an example converted as
        ``run`` converts it, or zeros of a spec's shape in the declared
        dtype; ``lead``: the stacked feeds' leading K, checked and
        dropped (step 0's slice)."""
        spec = None
        if isinstance(val, torch.Tensor) and val.device.type == "meta":
            spec = (tuple(val.shape), val.dtype)
        elif isinstance(val, tuple) and len(val) == 2 and \
                isinstance(val[0], (tuple, list)):
            spec = (tuple(int(d) for d in val[0]), to_torch_dtype(val[1]))
        if spec is None:
            t = self._feed_tensor(gb, name, val)
        else:
            if name.endswith("@LEN") or name.endswith("@LEN2"):
                raise ValueError(
                    f"Executor.compile: feed {name!r} is a (shape, dtype) "
                    f"spec, but its values (sequence lengths) steer the "
                    f"step; pass an example array for it")
            want = to_torch_dtype(gb.var(name).dtype) if gb.has_var(name) \
                else spec[1]
            t = torch.zeros(spec[0], dtype=want, device=self.device)
        if lead is not None:
            if tuple(t.shape[:1]) != (lead,):
                raise ValueError(
                    f"Executor.compile(feeds_stacked=True): feed {name!r} "
                    f"must have leading dim {lead}, got {tuple(t.shape)}")
            t = t[0]
        return t

    def _compile_step(self, fp: tuple, hexfp: str, program: Program,
                      feeds: Dict[str, torch.Tensor], fetch_names: List[str],
                      scope: Scope, is_test: bool, validate_s: float):
        """The key's :class:`~paddle_tpu_torch.core.compile_cache
        .CachedStep`: the one already built, else one built now (on a
        card: a dry warm-up and a capture); a cold build stores what it
        learned on disk, a warm one reports the entry's facts with its
        own times."""
        stats = compile_cache.stats()
        entry = self._cache.get(fp, program)
        reason = self._uncaptured_reason(program, is_test)
        on_card = reason is None
        if entry is not None and entry.cached is not None and (
                entry.graph is not None or not on_card):
            return entry.cached
        if entry is None:
            entry = _CapturedStep()
            self._cache.put(fp, entry, program)
        payload = compile_cache.disk_load(hexfp)
        times = {"validate_s": validate_s}
        learned = {}
        if on_card:
            if entry.graph is None:
                learned = self._compile_capture(
                    entry, program, feeds, fetch_names, scope, is_test,
                    times)
                self._cache.charge(fp, entry.nbytes)
            learned.update(
                launches=compile_cache.counter_deltas(entry.deltas,
                                                      ("launches",)),
                detail=compile_cache.counter_deltas(entry.deltas,
                                                    ("detail",)),
                pool_bytes=entry.nbytes)
        if payload is None:
            facts = {"device": str(self.device), "launches": {},
                     "detail": {}, "pool_bytes": 0,
                     "capture_peak_bytes": None,
                     "listing": _static_listing(program)}
            facts.update(learned)
            facts["times"] = dict(times)
            compile_cache.disk_store(hexfp, facts)
            source = "compile"
        else:
            facts = {k: v for k, v in payload.items()
                     if k not in ("format", "fingerprint")}
            facts["cold_times"] = facts.get("times") or {}
            facts.update(learned)
            facts["times"] = dict(times)
            source = "disk"
        # why the key's steps will run interpreted (None: captured); its
        # steps are counted under it when they run
        facts["uncaptured"] = reason
        stats.record_times(hexfp, source, **times)
        entry.cached = compile_cache.CachedStep(
            hexfp, facts, captured=entry if on_card else None,
            source=source)
        return entry.cached

    def _compile_capture(self, entry: "_CapturedStep", program: Program,
                         feeds, fetch_names, scope, is_test,
                         times) -> dict:
        """compile's build on the card: this thread's dry warm-up where it
        has none, then the capture, with the listing recorded; the random
        streams' offsets set back afterwards.  Returns the facts learned
        (``times`` is filled in)."""
        stats = compile_cache.stats()
        offsets = self._stream_offsets(program)
        thread = threading.get_ident()
        if thread not in entry.warm_threads:
            t0 = time.perf_counter()
            self._warm_dry(program, feeds, fetch_names, scope, is_test)
            torch.cuda.synchronize(self.device)
            times["warmup_s"] = time.perf_counter() - t0
            stats.bump("warmups")
            entry.warm_threads.add(thread)
        held = torch.cuda.memory_allocated(self.device)
        listing: List[dict] = []
        t0 = time.perf_counter()
        entry.capture(self, program, feeds, scope,
                      self._state_keys(program, scope), fetch_names,
                      is_test, listing=listing)
        times["capture_s"] = time.perf_counter() - t0
        stats.bump("captures")
        # what the allocator held as the capture began, plus the static
        # buffers and the graph's pool: a bound on the capture's peak that
        # leaves the card's peak statistics, which callers read, as they
        # were
        peak = held + entry.nbytes + sum(
            t.nbytes for t in (*entry.static_feeds.values(),
                               *entry.static_state.values()))
        self._restore_stream_offsets(program, offsets)
        return {"capture_peak_bytes": peak, "listing": listing}

    def _warm_dry(self, program, feeds, fetch_names, scope, is_test):
        """The key's warm-up step interpreted on the capture's side stream
        from the scope's state, nothing committed: no write to the scope,
        no step taken (the ops are functional; their outputs are
        dropped)."""
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            state = {k: scope.get(k)
                     for k in self._state_keys(program, scope)}
            self._interpret_step(program, self._context(program, is_test),
                                 state, feeds, fetch_names)
        cur.wait_stream(self._side)

    def _stream_offsets(self, program: Program) -> dict:
        streams = self._streams.get(program) or {}
        return {k: g.get_offset() for k, g in streams.items()
                if g.device.type == "cuda"}

    def _restore_stream_offsets(self, program: Program, offsets: dict):
        """Put each of ``program``'s card generators back where it was
        (a generator made since: where a fresh one starts)."""
        for k, g in (self._streams.get(program) or {}).items():
            if g.device.type == "cuda":
                g.set_offset(offsets.get(k, 0))

    # -- entry points ---------------------------------------------------------
    def as_module(self, program: Program, fetch_list: Sequence,
                  scope: Optional[Scope] = None) -> ProgramModule:
        """``program`` (an inference slice: no backward op) as a
        :class:`ProgramModule` over this executor's device, AMP and 1x1
        routing, with the persistables it references that ``scope``
        holds as buffers; what ``export_model.export_compiled_model``
        hands to ``torch.export``."""
        scope = global_scope() if scope is None else scope
        state = {k: scope.get(k) for k in self._state_keys(program, scope)}
        return ProgramModule(self, program, _fetch_names(fetch_list), state)

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
        fetch_names = _fetch_names(fetch_list)
        self._maybe_validate(program, fetch_names)
        with self._lock:
            feeds = {k: self._feed_tensor(gb, k, v)
                     for k, v in (feed or {}).items()}
        nan = {}

        def run():
            if self.check_nan_inf:
                # the pre-step state for the bisect: a replay overwrites
                # its state buffers in place
                nan["step"] = self._step
                nan["pre"] = {k: scope.get(k).clone()
                              for k in self._state_keys(program, scope)}
            return self._steps(program, [feeds], fetch_names, scope,
                               is_test)

        def post(steps):
            fetches, = steps
            if self.check_nan_inf:
                *fetches, finite = fetches
                self._nan_check(program, fetch_names, fetches, finite,
                                feeds, nan["pre"], nan["step"], is_test)
            return fetches

        return self._observed("run", program, [feeds], fetch_names, scope,
                              is_test, feeds, False, run, post,
                              return_numpy)

    def run_steps(self, num_steps: int,
                  program: Optional[Program] = None,
                  feed: Optional[Dict[str, object]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True,
                  is_test: bool = False,
                  feeds_stacked: bool = False):
        """Run ``num_steps`` steps of ``program`` back to back, with the
        state kept on the device between steps: on a card, ``num_steps``
        replays of the step's graph (the counterpart of the JAX
        executor's device-side scan).

        ``feeds_stacked=False`` reuses ``feed`` for every step.
        ``feeds_stacked=True`` expects every feed to carry a leading
        ``num_steps`` axis: it is copied to the device once, and step i
        reads slice i.  Fetches come back stacked with a leading
        ``num_steps`` axis; the step counter advances by ``num_steps``."""
        from .program import default_main_program
        if self.check_nan_inf:
            raise ValueError(
                "run_steps: check_nan_inf needs per-step host inspection; "
                "use run() for NaN hunts")
        num_steps = int(num_steps)
        if num_steps < 1:
            raise ValueError(f"run_steps: num_steps must be >= 1, got "
                             f"{num_steps}")
        program = program or default_main_program()
        scope = global_scope() if scope is None else scope
        gb = program.global_block()
        fetch_names = _fetch_names(fetch_list)
        self._maybe_validate(program, fetch_names)
        with self._lock:
            feeds = {}
            for name, val in (feed or {}).items():
                t = self._feed_tensor(gb, name, val)
                if feeds_stacked and tuple(t.shape[:1]) != (num_steps,):
                    raise ValueError(
                        f"run_steps(feeds_stacked=True): feed {name!r} must "
                        f"have leading dim {num_steps}, got "
                        f"{tuple(t.shape)}")
                feeds[name] = t
            per_step = [{k: v[i] for k, v in feeds.items()}
                        if feeds_stacked else feeds
                        for i in range(num_steps)]

        def post(steps):
            fetches = []
            for j in range(len(fetch_names)):
                vals = [s[j] for s in steps]
                fetches.append(None if any(v is None for v in vals)
                               else torch.stack(vals))
            return fetches

        return self._observed(
            "run_steps", program, per_step, fetch_names, scope, is_test,
            feeds, feeds_stacked, lambda: self._steps(
                program, per_step, fetch_names, scope, is_test),
            post, return_numpy)

    # -- autotuner replay -----------------------------------------------------
    def _autotuning(self) -> bool:
        """Resolved autotune switch: per-executor override, else flag."""
        if self.autotune is not None:
            return bool(self.autotune)
        return bool(get_flag("autotune"))

    def _tuned(self, name: str, default: Dict[str, object]):
        """A tuned call site's config: the persisted winner under the
        autotune opt-in, else ``default`` itself."""
        return resolve_tuned(name, default, self.autotune)

    # -- observability --------------------------------------------------------
    def _observing(self) -> bool:
        """Resolved observe switch: per-executor override, else flag."""
        if self.observe is not None:
            return bool(self.observe)
        return obs.enabled()

    def _observed(self, path: str, program: Program, per_step, fetch_names,
                  scope: Scope, is_test: bool, feeds, stacked: bool, run,
                  post, return_numpy: bool):
        """One dispatch: ``run()`` through the fault rim and ``post`` on
        its result under the executor's lock, then the fetches to numpy
        (where the host waits for the card) outside it.  Observing, it
        wraps that in the ``executor/step`` span, the dispatch in an
        ``executor/dispatch`` span and a ``record_function`` range, the
        conversion in ``executor/fetch_block``, and records the
        dispatch; all of it on the host, around a captured step's replay
        and never inside it, and no extra wait on the card."""
        if not self._observing():
            with self._lock:
                fetches = post(self._dispatch(run))
            return _out(fetches, return_numpy)
        fp = compile_cache.fingerprint_hex(self._fingerprint(
            program, per_step[0], fetch_names, scope, is_test))[:12]
        t_start = time.perf_counter()
        c0 = compile_cache.stats().snapshot()
        label = self._observe_label()
        attrs = {} if label is None else {"label": label}
        sp = obs.tracing.start_span("executor/step", path=path,
                                    steps=len(per_step), fingerprint=fp,
                                    **attrs)
        tag = "" if label is None else f":{label}"
        try:
            with self._lock, torch.profiler.record_function(
                    f"pt:{path}:{fp}:step{self._step}{tag}"), \
                    obs.tracing.span("executor/dispatch", parent=sp) as dsp:
                fetches = post(self._dispatch(run, trace_span=dsp))
            t_fetch = time.perf_counter()
            if return_numpy:
                with obs.tracing.span("executor/fetch_block", parent=sp):
                    fetches = _out(fetches, True)
        except BaseException as e:
            # a failed step is what a trace must explain: the root ends
            # with the typed status
            sp.end(status=type(e).__name__)
            raise
        now = time.perf_counter()
        sp.end()
        self._record_dispatch(path, fp, len(per_step), now - t_start,
                              now - t_fetch, feeds, stacked, c0, sp)
        return fetches

    def _record_dispatch(self, path: str, fp: str, steps: int,
                         wall_s: float, fetch_block_s: float,
                         feeds: Dict[str, torch.Tensor], stacked: bool,
                         compile_before: Dict[str, int], span):
        """Registry writes and the JSONL ``step`` event of one dispatch.
        A dispatch that warmed up or captured a key is cold: it stays out
        of the step-time histogram and the throughput gauge."""
        after = compile_cache.stats().snapshot()
        cold = any(after[k] > compile_before[k]
                   for k in ("warmups", "captures"))
        wall_ms = wall_s * 1e3
        step_ms = wall_ms / max(steps, 1)
        obs.inc_counter("executor/steps", steps)
        obs.inc_counter("executor/dispatches")
        obs.observe_hist("executor/dispatch_steps", steps)
        obs.observe_hist("executor/fetch_block_ms", fetch_block_s * 1e3)
        feed_bytes = int(sum(t.nbytes for t in feeds.values()))
        if feed_bytes:
            obs.inc_counter("executor/feed_bytes", float(feed_bytes))
        examples_per_s = None
        if not cold:
            obs.observe_hist("executor/step_time_ms", step_ms)
            lead = 1 if stacked else 0      # stacked feeds: [K, B, ...]
            for _, t in sorted(feeds.items()):
                if t.dim() > lead:
                    if wall_s > 0:
                        examples_per_s = t.shape[lead] * steps / wall_s
                        obs.set_gauge("executor/examples_per_sec",
                                      examples_per_s)
                    break
        obs.sample_device_memory()
        obs.emit_event(
            "step", path=path, fingerprint=fp, steps=steps,
            wall_ms=round(wall_ms, 3),
            step_ms=None if cold else round(step_ms, 3),
            cold_compile=cold, feed_bytes=feed_bytes,
            fetch_block_ms=round(fetch_block_s * 1e3, 3),
            examples_per_sec=round(examples_per_s, 2)
            if examples_per_s else None,
            label=self._observe_label(), trace=span.trace_id,
            span=span.span_id)

    # -- check_nan_inf --------------------------------------------------------
    def _nan_check(self, program: Program, fetch_names: List[str],
                   fetches, finite, feeds, pre, step: int, is_test: bool):
        """Raise ``FloatingPointError`` for a non-finite var of the step
        just run, with the eager bisect's diagnosis.  ``finite`` is the
        step's (names, stacked flags), read in one host transfer."""
        names, flags = finite
        try:
            if flags is not None:
                ok = flags.tolist()
                self._nan_localize(program, {n for n, f in zip(names, ok)
                                             if not f})
            covered = set(names)
            for n, f in zip(fetch_names, fetches):
                if n in covered or not isinstance(f, torch.Tensor) \
                        or not f.is_floating_point():
                    continue
                if not bool(torch.isfinite(f).all()):
                    raise FloatingPointError(
                        f"NaN/Inf detected in fetched var {n!r} "
                        f"(check_nan_inf, analog of FLAGS_check_nan_inf)")
        except FloatingPointError as e:
            raise self._nan_diagnose(program, feeds, pre, step, is_test,
                                     e) from e

    @staticmethod
    def _nan_localize(program: Program, bad):
        """Raise naming the first op (program order) whose output went
        non-finite (executor.cc:116-124's per-op check)."""
        if not bad:
            return
        for op in program.global_block().ops:
            for slot, names in op.outputs.items():
                for n in names:
                    if n in bad:
                        raise FloatingPointError(
                            f"NaN/Inf first produced by op {op.type!r} in "
                            f"var {n!r} (output slot {slot}; "
                            f"check_nan_inf, executor.cc FLAGS_check_nan_inf"
                            f" analog)")
        n = sorted(bad)[0]
        raise FloatingPointError(
            f"NaN/Inf detected in var {n!r} (not produced by any op — "
            f"check the feed; check_nan_inf)")

    def _nan_diagnose(self, program: Program, feeds, state, step: int,
                      is_test: bool, err: FloatingPointError):
        """The failure augmented with the eager bisect's provenance
        (``observability.nanprov``); always emits a ``nan`` event when a
        metrics log is set."""
        from ..observability import nanprov
        diag = nanprov.bisect_step(self, program, feeds, state, step,
                                   is_test)
        if self._observing():
            obs.inc_counter("executor/nan_events")
        obs.emit_event("nan", original=str(err), step=step, **(diag or {}))
        if diag is None:
            return err
        return FloatingPointError(
            f"{err}\n[paddle_tpu_torch] NaN provenance (eager re-run of "
            f"step {step}): {nanprov.format_diagnosis(diag)}")

    # -- dispatch -------------------------------------------------------------
    def _dispatch(self, fn, trace_span=None):
        """One dispatch through the fault rim: a direct call with no
        retry policy and fault injection off; else the
        ``executor.dispatch`` site fires first, and a retryable failure
        backs off and retries per the policy, unless a step of the
        dispatch already ran (its state is written: running it again
        would apply it twice)."""
        policy = self.retry_policy
        if policy is None and not _fi.ENABLED:
            return fn()

        def attempt():
            if _fi.ENABLED:
                action = _fi.check("executor.dispatch")
                if action is not None:
                    _fi.raise_for(action, "executor.dispatch")
            return fn()

        if policy is None:
            return attempt()
        step0 = self._step

        def cls(e):
            kind = _faults.classify(e)
            return "fatal" if self._step != step0 else kind

        def on_retry(i, e, d):
            self.dispatch_retries += 1
            obs.inc_counter("fault/retries")
            obs.emit_event("fault", event="retry",
                           site="executor.dispatch", step=int(step0),
                           attempt=i + 1, delay_s=round(d, 4),
                           error=f"{type(e).__name__}: {e}")
            if trace_span is not None:
                trace_span.event("retry", attempt=i + 1,
                                 delay_s=round(d, 4),
                                 error=f"{type(e).__name__}: {e}")

        return _faults.retry_call(attempt, policy, what="dispatch",
                                  classify_fn=cls, on_retry=on_retry)

    def _steps(self, program: Program, per_step: List[Dict[str, object]],
               fetch_names: List[str], scope: Scope,
               is_test: bool) -> List[List[Optional[torch.Tensor]]]:
        """Run one step per feed dict of ``per_step``; returns each step's
        fetches (tensors the caller owns)."""
        stats = compile_cache.stats()
        reason = self._uncaptured_reason(program, is_test)
        if reason is not None:
            stats.bump_uncaptured(reason, len(per_step))
            return [self._run_once(program, f, fetch_names, scope, is_test)
                    for f in per_step]
        fp = self._fingerprint(program, per_step[0], fetch_names, scope,
                               is_test)
        entry = self._cache.get(fp, program)
        if entry is None:
            entry = _CapturedStep()
            self._cache.put(fp, entry, program)
        thread = threading.get_ident()
        out = []
        loaded = False
        for feeds in per_step:
            if entry.graph is None and thread not in entry.warm_threads:
                # this thread's warm-up for the key: the step interpreted
                # on the side stream the capture will use, and committed
                stats.bump("warmups")
                out.append(self._warm(program, feeds, fetch_names, scope,
                                      is_test))
                entry.warm_threads.add(thread)
                continue
            if entry.graph is None:
                entry.capture(self, program, feeds, scope,
                              self._state_keys(program, scope), fetch_names,
                              is_test)
                stats.bump("captures")
                self._cache.charge(fp, entry.nbytes)
                loaded = True
            elif not loaded:
                entry.load_state(scope)
                loaded = True
            entry.replay(program, feeds, self._step)
            self._step += 1
            stats.bump("replays")
            fetches = [f.clone() if f is not None else None
                       for f in entry.fetches]
            if self.check_nan_inf:
                names, flags = entry.finite
                fetches.append((names, flags.clone()
                                if flags is not None else None))
            out.append(fetches)
        if loaded:
            entry.publish(scope)
        return out

    def _warm(self, program, feeds, fetch_names, scope, is_test):
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            fetches = self._run_once(program, feeds, fetch_names, scope,
                                     is_test)
        cur.wait_stream(self._side)
        return fetches

    def _context(self, program: Program, is_test: bool) -> ExecContext:
        streams = self._streams.get(program)
        if streams is None:
            streams = self._streams[program] = {}
        return ExecContext(program, self.device, self._step, is_test=is_test,
                           conv1x1_pallas=self.conv1x1_pallas, amp=self.amp,
                           streams=streams,
                           compute_dtype=self._compute_dtype())

    def _compute_dtype(self) -> Optional[torch.dtype]:
        return None if self.compute_dtype is None \
            else to_torch_dtype(self.compute_dtype)

    def _interpret_step(self, program: Program, ctx: ExecContext,
                        state: Dict[str, torch.Tensor],
                        feeds: Dict[str, torch.Tensor],
                        fetch_names: List[str]):
        """Interpret one step from ``state`` and ``feeds``; returns the
        fetched tensors, the persistables an op produced (a value an op
        passed through unchanged is not among them) and, under
        ``check_nan_inf``, (names, one stacked tensor of their
        ``isfinite(...).all()`` flags) over every floating var the step
        bound, else None."""
        gb = program.global_block()
        env = Env(gb)
        env.local.update(state)
        env.local.update(feeds)
        env.local = _upcast(env.local, ctx.compute_dtype)
        if self.amp and not _has_backward(program):
            # pure-inference AMP: the whole net computes in bf16
            env.local = {k: _to_bf16(v) for k, v in env.local.items()}
        entry = dict(env.local)
        interpret_block_with_backward(gb, env, ctx)
        fetches = [env.get(n) if env.has(n) else None for n in fetch_names]
        writes = {}
        for name in _written_persistables(program):
            if not env.has(name):
                continue
            v = env.get(name)
            if name in entry and v is entry[name]:
                continue
            writes[name] = v
        finite = None
        if self.check_nan_inf:
            names = [k for k, v in env.local.items()
                     if isinstance(v, torch.Tensor) and v.is_floating_point()]
            finite = (names, torch.stack([torch.isfinite(env.local[k]).all()
                                          for k in names]) if names else None)
        return fetches, writes, finite

    def _run_once(self, program: Program, feeds: Dict[str, torch.Tensor],
                  fetch_names: List[str], scope: Scope,
                  is_test: bool) -> List[Optional[torch.Tensor]]:
        """One interpreted step: state from the scope, feeds already on
        the device; returns the fetched tensors (on the device)."""
        state = {k: scope.get(k) for k in self._state_keys(program, scope)}
        ctx = self._context(program, is_test)
        self._step += 1
        fetches, writes, finite = self._interpret_step(
            program, ctx, state, feeds, fetch_names)
        # persistables an op produced go back to the scope in the dtype
        # they had there (bn running stats etc. stay fp32 under AMP)
        for name, v in writes.items():
            old = state.get(name)
            if old is not None and v.dtype != old.dtype:
                v = v.to(old.dtype)
            scope.set(name, v)
        return fetches + [finite] if self.check_nan_inf else fetches

    # -- the input pipeline ---------------------------------------------------
    def run_pipelined(self, feed_iter,
                      program: Optional[Program] = None,
                      fetch_list: Optional[Sequence] = None,
                      scope: Optional[Scope] = None,
                      steps_per_dispatch: Optional[int] = None,
                      prefetch_depth: Optional[int] = None,
                      return_numpy: bool = True,
                      is_test: bool = False):
        """Generator over per-step fetch lists for a stream of host feed
        dicts, with host batch assembly and the host-to-device copies
        overlapped with the device's steps.

        ``feed_iter`` yields host feed dicts (e.g. ``DataFeeder.feed``
        output).  A staging thread groups consecutive same-signature feeds
        into runs of ``steps_per_dispatch`` (default 4, or the persisted
        ``executor/run_pipelined`` winner under autotune), stacks each run
        along a new leading axis (:func:`stack_feeds`) into pinned host
        memory and copies it to the device on a stream of its own; up to
        ``prefetch_depth`` (default 2) staged dispatches wait in a bounded
        queue, each handed over with an event the consuming stream waits
        on.  Full runs dispatch as ``run_steps(feeds_stacked=True)``;
        leftovers (the tail of the stream, or a run cut by a signature
        change) go one at a time through :meth:`run`.

        Each step is the step the sequential :meth:`run` loop would take,
        with the same step counter and state updates (on a card both
        replay the same captured graph), so the fetches equal that loop's
        bit for bit.  An exception in ``feed_iter`` re-raises here, and
        abandoning this generator early stops and joins the staging
        thread.

        Observing, one ``executor/run_pipelined`` root span ties the run
        into one trace: the staging thread's ``pipeline/stage`` spans
        (and the engine's ``reader/*`` spans) parent to it, and each
        dispatch's ``executor/step`` nests under it; staging time goes
        to ``executor/stage_put_ms`` (the host's part: the copies run
        asynchronously on their stream), per-step leftovers to
        ``pipeline/fallback_steps``."""
        from ..reader.pipeline import prefetch as _prefetch
        from .program import default_main_program
        if self.check_nan_inf:
            raise ValueError(
                "run_pipelined: check_nan_inf needs per-step host "
                "inspection; use run() for NaN hunts")
        program = program or default_main_program()
        # before the staging thread starts: an invalid program stages
        # nothing (the dispatches below then hit the memo)
        self._maybe_validate(program, _fetch_names(fetch_list))
        if steps_per_dispatch is None or prefetch_depth is None:
            cfg = self._tuned("executor/run_pipelined",
                              {"steps_per_dispatch": 4,
                               "prefetch_depth": 2})
            if steps_per_dispatch is None:
                steps_per_dispatch = cfg["steps_per_dispatch"]
            if prefetch_depth is None:
                prefetch_depth = cfg["prefetch_depth"]
        K = int(steps_per_dispatch)
        depth = int(prefetch_depth)
        if K < 1:
            raise ValueError(
                f"run_pipelined: steps_per_dispatch must be >= 1, got {K}")
        gb = program.global_block()
        on_card = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if on_card else None
        # resolved once: the staging thread and the queue instrumentation
        # run for the generator's whole lifetime
        obs_on = self._observing()
        root = obs.tracing.start_span(
            "executor/run_pipelined", steps_per_dispatch=K,
            prefetch_depth=depth) if obs_on else None

        def ship(feed, kind, n):
            with (obs.tracing.span("pipeline/stage", kind=kind, steps=n)
                  if obs_on else nullcontext()):
                t0 = time.perf_counter() if obs_on else 0.0
                out = ship_now(feed, kind, n)
                if obs_on:
                    obs.observe_hist("executor/stage_put_ms",
                                     (time.perf_counter() - t0) * 1e3)
            return out

        def ship_now(feed, kind, n):
            if kind == "scan":
                feed = stack_feeds(feed)
            if not on_card:
                # own copies: a feeder's staging buffers are reused
                return kind, {k: self._feed_tensor(gb, k, np.array(v))
                              for k, v in feed.items()}, n, None
            with torch.cuda.stream(copy_stream):
                dev = {k: self._feed_tensor(gb, k, v)
                       for k, v in feed.items()}
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return kind, dev, n, ready

        def staged():
            pend, sig = [], None
            for feed in feed_iter:
                fsig = _feed_signature(feed)
                if pend and fsig != sig:
                    for f in pend:
                        yield ship(f, "single", 1)
                    pend = []
                sig = fsig
                pend.append(feed)
                if len(pend) == K:
                    if K > 1:
                        yield ship(pend, "scan", K)
                    else:
                        yield ship(pend[0], "single", 1)
                    pend = []
            for f in pend:
                yield ship(f, "single", 1)

        reader = _prefetch(staged, buffer_size=max(1, depth), num_workers=1,
                           instrument=obs_on, trace_parent=root)
        try:
            for kind, dev, n, ready in reader():
                if ready is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    for t in dev.values():
                        t.record_stream(cur)
                if kind == "scan":
                    with (obs.tracing.attach(root) if root is not None
                          else nullcontext()):
                        outs = self.run_steps(
                            n, program, feed=dev, fetch_list=fetch_list,
                            scope=scope, return_numpy=return_numpy,
                            is_test=is_test, feeds_stacked=True)
                    for i in range(n):
                        yield [o[i] if o is not None else None
                               for o in outs]
                else:
                    # a per-step leftover (stream tail or a signature
                    # change); K=1 dispatches singles by design
                    if obs_on and K > 1:
                        obs.inc_counter("pipeline/fallback_steps")
                    with (obs.tracing.attach(root) if root is not None
                          else nullcontext()):
                        out = self.run(program, feed=dev,
                                       fetch_list=fetch_list, scope=scope,
                                       return_numpy=return_numpy,
                                       is_test=is_test)
                    yield out
        finally:
            if root is not None:
                root.end()


def _out(fetches, return_numpy):
    if return_numpy:
        return [to_numpy(f) if f is not None else None for f in fetches]
    return fetches


def _feed_signature(feed: Dict[str, object]):
    """(name, shape, dtype) of every entry of a feed dict, host arrays or
    tensors: one step's part of the captured-step key, and what feeds
    must share to stack (``run_pipelined``)."""
    return tuple(sorted(
        (k, tuple(np.shape(v)),
         str(getattr(v, "dtype", None) or np.asarray(v).dtype))
        for k, v in feed.items()))


def _fetch_names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]
