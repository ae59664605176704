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

Not ported yet: ``Executor.compile``, the disk cache, observability and
validation.
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults as _faults
from ..flags import get_flag
from ..testing import faultinject as _fi
from . import compile_cache
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
                 conv1x1_pallas: Optional[bool] = None, amp: bool = False,
                 streams: Optional[Dict[tuple, torch.Generator]] = None):
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
        # the op last started (a failed capture names it)
        self.last_op: Optional[Operator] = None
        # the random ops' generators by stream key (the executor keeps
        # one table a program); a capture sets ``capturing``, and the
        # replay places the streams at the step instead
        self.streams = {} if streams is None else streams
        self.capturing = False
        self._placed = set()

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
RANDOM_OPS = ("uniform_random", "gaussian_random", "dropout")
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


def run_op(op: Operator, env: Env, ctx: ExecContext):
    impl = get_op_impl(op.type)
    ins = {slot: [env.get(n) for n in names]
           for slot, names in op.inputs.items() if names}
    prev_op, prev_env = ctx.op, ctx.env
    ctx.op, ctx.env = op, env
    ctx.last_op = op
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
    numbers in (dropout in training, uniform_random, gaussian_random): a
    capture registers their generators with the graph."""
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

    def capture(self, exe: "Executor", program: Program,
                feeds: Dict[str, torch.Tensor], scope: Scope,
                state_keys: List[str], fetch_names: List[str],
                is_test: bool):
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
                fetches, writes = exe._interpret_step(
                    program, ctx, self.static_state, self.static_feeds,
                    fetch_names)
                self.fetches = [own(f) for f in fetches]
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

    ``use_jit=True`` (the default) on a card: ``run`` and ``run_steps``
    dispatch each step as a replay of a CUDA graph captured from the
    interpreter, cached by fingerprint (``core/compile_cache.py``): the
    content digest, the per-step feed signature, the fetch names, the
    state keys with their shapes and dtypes, ``is_test``, ``amp``,
    ``conv1x1_pallas`` and the device.  A key's first step runs
    interpreted on the capture's side stream (the warm-up: kernels build,
    cuBLAS makes its handles there); its second step is captured and
    replayed; later steps replay.  Random ops (dropout in training,
    ``uniform_random``, ``gaussian_random``) draw from one generator an
    op, kept per (executor, program) and placed at each step's index
    (``ExecContext.generator``), so a step draws the same numbers
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
    counts the retries taken).

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

    def __init__(self, place: Optional[Place] = None, amp: bool = False,
                 conv1x1_pallas: Optional[bool] = None,
                 use_jit: bool = True, retry_policy=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self.amp = amp
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
                bool(is_test), bool(self.amp), conv1x1, str(self.device))

    def _uncaptured_reason(self, program: Program,
                           is_test: bool) -> Optional[str]:
        if self.device.type != "cuda":
            return "cpu"
        if not self.use_jit:
            return "use_jit=False"
        return None

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
        with self._lock:
            feeds = {k: self._feed_tensor(gb, k, v)
                     for k, v in (feed or {}).items()}
            fetches, = self._dispatch(lambda: self._steps(
                program, [feeds], fetch_names, scope, is_test))
        return _out(fetches, return_numpy)

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
        num_steps = int(num_steps)
        if num_steps < 1:
            raise ValueError(f"run_steps: num_steps must be >= 1, got "
                             f"{num_steps}")
        program = program or default_main_program()
        scope = global_scope() if scope is None else scope
        gb = program.global_block()
        fetch_names = _fetch_names(fetch_list)
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
            steps = self._dispatch(lambda: self._steps(
                program, per_step, fetch_names, scope, is_test))
        fetches = []
        for j in range(len(fetch_names)):
            vals = [s[j] for s in steps]
            fetches.append(None if any(v is None for v in vals)
                           else torch.stack(vals))
        return _out(fetches, return_numpy)

    # -- dispatch -------------------------------------------------------------
    def _dispatch(self, fn):
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
            out.append([f.clone() if f is not None else None
                        for f in entry.fetches])
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
                           streams=streams)

    def _interpret_step(self, program: Program, ctx: ExecContext,
                        state: Dict[str, torch.Tensor],
                        feeds: Dict[str, torch.Tensor],
                        fetch_names: List[str]):
        """Interpret one step from ``state`` and ``feeds``; returns the
        fetched tensors and the persistables an op produced (a value an op
        passed through unchanged is not among them)."""
        gb = program.global_block()
        env = Env(gb)
        env.local.update(state)
        env.local.update(feeds)
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
        return fetches, writes

    def _run_once(self, program: Program, feeds: Dict[str, torch.Tensor],
                  fetch_names: List[str], scope: Scope,
                  is_test: bool) -> List[Optional[torch.Tensor]]:
        """One interpreted step: state from the scope, feeds already on
        the device; returns the fetched tensors (on the device)."""
        state = {k: scope.get(k) for k in self._state_keys(program, scope)}
        ctx = self._context(program, is_test)
        self._step += 1
        fetches, writes = self._interpret_step(program, ctx, state, feeds,
                                               fetch_names)
        # persistables an op produced go back to the scope in the dtype
        # they had there (bn running stats etc. stay fp32 under AMP)
        for name, v in writes.items():
            old = state.get(name)
            if old is not None and v.dtype != old.dtype:
                v = v.to(old.dtype)
            scope.set(name, v)
        return fetches

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
        into runs of ``steps_per_dispatch`` (default 4), stacks each run
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
        thread."""
        from ..reader.pipeline import prefetch as _prefetch
        from .program import default_main_program
        program = program or default_main_program()
        K = int(4 if steps_per_dispatch is None else steps_per_dispatch)
        depth = int(2 if prefetch_depth is None else prefetch_depth)
        if K < 1:
            raise ValueError(
                f"run_pipelined: steps_per_dispatch must be >= 1, got {K}")
        gb = program.global_block()
        on_card = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if on_card else None

        def ship(feed, kind, n):
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
                        yield ship(stack_feeds(pend), "scan", K)
                    else:
                        yield ship(pend[0], "single", 1)
                    pend = []
            for f in pend:
                yield ship(f, "single", 1)

        reader = _prefetch(staged, buffer_size=max(1, depth), num_workers=1)
        for kind, dev, n, ready in reader():
            if ready is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ready)
                for t in dev.values():
                    t.record_stream(cur)
            if kind == "scan":
                outs = self.run_steps(n, program, feed=dev,
                                      fetch_list=fetch_list, scope=scope,
                                      return_numpy=return_numpy,
                                      is_test=is_test, feeds_stacked=True)
                for i in range(n):
                    yield [o[i] if o is not None else None for o in outs]
            else:
                yield self.run(program, feed=dev, fetch_list=fetch_list,
                               scope=scope, return_numpy=return_numpy,
                               is_test=is_test)


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
