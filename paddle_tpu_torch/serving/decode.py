"""Continuous-batching autoregressive decode serving: KV-cache state
carried across dispatches, and admit/evict at every token step
(counterpart of ``paddle_tpu/serving/decode.py``).

A *generate* request is a session: each token depends on every token
before it.  Through the request batcher it would either recompute the
whole prefix for every token or hold a rigid batch hostage to its
slowest member.  This module is the iteration-level scheduler (Orca,
OSDI'22) over the port's executor:

* :class:`DecodeEngine` — exactly two programs over one scope.
  **Prefill** (batch 1, ``Tq = bucket``) runs the prompt through
  ``attention_with_cache``, writing per-layer K/V scratch slabs, and
  gives the first generated token; the host copies the scratch rows into
  the slot's rows of the slot slabs, in place (rows are independent, so
  the relocation is exact).  **Decode** (batch S, ``Tq = 1``) advances
  every live slot one token, reading and appending the ``[S, Tmax, D]``
  slabs, persistable state the executor carries from dispatch to
  dispatch.  Every feed shape is fixed: admit, evict and growth change
  values only, so on a card each program is one captured CUDA graph and
  steady-state decode makes no new capture key (:attr:`DecodeEngine.keys`
  holds the keys its dispatches asked for).  Slabs are sized by a
  max-len bucket (:data:`DEFAULT_LEN_BUCKETS`).
* :class:`DecodeRuntime` — the slot pool: S sequences occupy fixed
  slots; at each token-step boundary the loop completes finished
  sequences (EOS or max-len), admits queued requests into the freed
  slots, expires deadlines and sheds oldest-deadline-first per step.
  The per-model circuit breaker and the retry rim follow the request
  server's; the ``serving.decode_step`` fault-injection site fires inside
  the retry rim and before the executor call, so an injected transient
  retries with the slabs untouched.
* ``Server.add_decode_model`` / ``Server.submit_decode`` (server.py)
  mount a runtime beside the request tenants.

Greedy incremental decode is held bit-equal to a recompute-per-token
oracle (``tests/test_torch_decode.py``): the oracle replays the prefix
from zeroed slabs through the same two programs, at the same shapes.

``static`` mode (admit only into an empty pool, then run the batch to
its slowest member) is the benchmark's control arm: the same programs,
another scheduler.

On a card the slab relocation and :meth:`DecodeEngine.reset` write the
scope's tensors in place: after a replay the scope holds the captured
step's own state buffers, and an in-place write to them is what the next
replay reads (the executor copies a state buffer in only when the scope
holds another tensor).

Observability, as in the JAX pool, with ``observe`` on
(``DecodeRuntime(observe=...)``, else the global flag, read once at
construction; a pool mounted on a server takes the server's): the
``serving/decode_*`` metrics, the ``decode_admit``/``decode_step``/
``decode_done`` events, one ``serving/request`` span per request and one
``serving/decode_step`` span per token step (``attribution.decode_budget``
reads them).  With it off the pool builds no span and writes neither the
registry nor the log.  The pool's lock comes from the lock watch.

Autotuning: omitted ``slots`` (``DecodeEngine``) and ``step_wait_ms``
(``DecodeRuntime``) take :data:`DECODE_SLOTS_DEFAULT`, or, under the
opt-in (``autotune=True``, else the ``autotune`` flag), the persisted
``serving/decode_slots`` winner.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults as _faults
from .. import observability as obs
from ..core.registry import register_tunable, resolve_tuned
from ..testing import faultinject as _fi
from ..testing import lockwatch as _lw
from .server import ModelError, PendingResponse

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["DecodeEngine", "DecodeRuntime", "DEFAULT_LEN_BUCKETS",
           "DECODE_SLOTS_DEFAULT", "bucket_for_len"]

# Max-len buckets of the KV slabs: a request's prompt + generation budget
# is snapped up to a bucket, so engines with nearby limits share shapes.
DEFAULT_LEN_BUCKETS = (32, 64, 128, 256, 512)

# the slot count (the decode program's batch) and the idle pool's wait
DECODE_SLOTS_DEFAULT = {"slots": 8, "step_wait_ms": 1.0}

# Autotuner knob (paddle_tpu_torch.tuning), with the JAX package's space
# and default: more slots amortize a step over more live sequences but
# compute padded rows when the load cannot fill them; step_wait_ms bounds
# the idle pool's poll.
register_tunable(
    "serving/decode_slots", side="host",
    space={"slots": (2, 4, 8, 16), "step_wait_ms": (0.5, 1.0, 2.0, 5.0)},
    default=dict(DECODE_SLOTS_DEFAULT),
    description="decode slot pool: concurrent KV-cache slots (the "
                "compiled decode batch) and the idle-pool step wait.")


def bucket_for_len(max_len: int,
                   buckets: Sequence[int] = DEFAULT_LEN_BUCKETS) -> int:
    """Smallest bucket >= max_len (max_len itself when it exceeds every
    bucket)."""
    for b in buckets:
        if max_len <= b:
            return int(b)
    return int(max_len)


class DecodeEngine:
    """The two-program incremental-decode state machine.

    Builds a small causal transformer LM (embedding -> n_layers x [QKV
    projections -> attention_with_cache -> relu projection -> residual]
    -> vocab head) twice over shared weights: a batch-1 prefill at
    ``Tq = bucket`` and a batch-S decode at ``Tq = 1``.  The weights live
    in one scope under explicit ``ParamAttr`` names (``{name}/emb``,
    ``{name}/l{i}/wq|wk|wv|wp|bp``, ``{name}/wo``); the per-layer slabs are
    persistable vars of the same scope.  The engine owns no lengths:
    ``cache_len`` is a feed, because the slot pool is the authority on
    sequence lengths.

    ``place`` defaults to the card; ``use_jit`` is the executor's (on a
    card each program's step is one captured CUDA graph)."""

    def __init__(self, vocab_size: int, hidden_dim: int = 32,
                 n_layers: int = 1, slots: Optional[int] = None,
                 max_len: int = 64,
                 len_buckets: Sequence[int] = DEFAULT_LEN_BUCKETS,
                 eos_id: Optional[int] = None, seed: int = 0,
                 name: str = "decode", autotune: Optional[bool] = None,
                 place=None, use_jit: bool = True):
        if slots is None:
            slots = int(resolve_tuned("serving/decode_slots",
                                      dict(DECODE_SLOTS_DEFAULT),
                                      autotune)["slots"])
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
        self.name = str(name)
        self.vocab_size = int(vocab_size)
        self.hidden_dim = int(hidden_dim)
        self.n_layers = int(n_layers)
        self.slots = int(slots)
        self.bucket = bucket_for_len(int(max_len), len_buckets)
        self.eos_id = eos_id
        self.seed = int(seed)
        # the capture keys (executor fingerprints) the dispatches asked
        # for: after warmup() steady-state decode adds none
        self.keys = set()
        self._build(place, use_jit)

    # -- program construction ------------------------------------------------
    def _net(self, batch: int, tq: int, cache_prefix: str):
        from .. import layers
        from ..core.program import default_main_program
        from ..param_attr import ParamAttr

        D, V, p = self.hidden_dim, self.vocab_size, self.name
        tok = layers.data("tokens", shape=[batch, tq, 1], dtype="int64",
                          append_batch_size=False)
        cl = layers.data("cache_len", shape=[batch], dtype="int32",
                         append_batch_size=False)
        wm = layers.data("write_mask", shape=[batch], dtype="float32",
                         append_batch_size=False)
        x = layers.embedding(tok, size=[V, D],
                             param_attr=ParamAttr(name=f"{p}/emb"))
        gb = default_main_program().global_block()
        for i in range(self.n_layers):
            q = layers.fc(x, D, num_flatten_dims=2, bias_attr=False,
                          param_attr=ParamAttr(name=f"{p}/l{i}/wq"))
            k = layers.fc(x, D, num_flatten_dims=2, bias_attr=False,
                          param_attr=ParamAttr(name=f"{p}/l{i}/wk"))
            v = layers.fc(x, D, num_flatten_dims=2, bias_attr=False,
                          param_attr=ParamAttr(name=f"{p}/l{i}/wv"))
            ck = gb.create_var(name=f"{cache_prefix}_k{i}",
                               shape=(batch, self.bucket, D),
                               dtype="float32", persistable=True)
            cv = gb.create_var(name=f"{cache_prefix}_v{i}",
                               shape=(batch, self.bucket, D),
                               dtype="float32", persistable=True)
            a = layers.attention_with_cache(q, k, v, ck, cv, cl, wm)
            h = layers.fc(a, D, num_flatten_dims=2, act="relu",
                          param_attr=ParamAttr(name=f"{p}/l{i}/wp"),
                          bias_attr=ParamAttr(name=f"{p}/l{i}/bp"))
            x = layers.elementwise_add(x, h)
        return layers.fc(x, V, num_flatten_dims=2, bias_attr=False,
                         param_attr=ParamAttr(name=f"{p}/wo"))

    def _build(self, place, use_jit):
        from ..core import Executor, Scope
        from ..core.program import Program, program_guard

        self.scope = Scope()
        self.executor = Executor(place, use_jit=use_jit)
        self.device = self.executor.device
        self.prefill_prog, startup_p = Program(), Program()
        startup_p.random_seed = self.seed
        self.prefill_prog.random_seed = self.seed
        with program_guard(self.prefill_prog, startup_p):
            self._pf_logits = self._net(1, self.bucket, f"{self.name}/pf")
        self.decode_prog, startup_d = Program(), Program()
        startup_d.random_seed = self.seed
        self.decode_prog.random_seed = self.seed
        with program_guard(self.decode_prog, startup_d):
            self._dec_logits = self._net(self.slots, 1, f"{self.name}/kv")
        # one startup run initializes the shared weights (both builds
        # declare the same ParamAttr names)
        self.executor.run(startup_p, feed={}, fetch_list=[],
                          scope=self.scope)
        self._slab_names = (
            [f"{self.name}/pf_{c}{i}" for i in range(self.n_layers)
             for c in ("k", "v")]
            + [f"{self.name}/kv_{c}{i}" for i in range(self.n_layers)
               for c in ("k", "v")])
        self.reset()

    def param_names(self) -> List[str]:
        """The weights' scope names, the JAX engine's own."""
        p = self.name
        return ([f"{p}/emb"]
                + [f"{p}/l{i}/{w}" for i in range(self.n_layers)
                   for w in ("wq", "wk", "wv", "wp", "bp")]
                + [f"{p}/wo"])

    def load_numpy_state(self, arrays: Dict[str, np.ndarray]):
        """Take the weights from ``{name: array}`` (a JAX engine's scope,
        by the same names) onto the engine's device."""
        from ..weights import load_numpy_state
        unknown = sorted(set(arrays) - set(self.param_names()))
        if unknown:
            raise KeyError(f"DecodeEngine {self.name!r}: no weights named "
                           f"{unknown}")
        load_numpy_state(self.scope, arrays, self.device)

    # -- state ---------------------------------------------------------------
    def reset(self):
        """Zero every cache slab (prefill scratch and slot slabs), in
        place on the device: the state the recompute oracle replays from,
        and the recovery after a failed dispatch."""
        for nm in self._slab_names:
            if self.scope.has(nm):
                self.scope.get(nm).zero_()
            else:
                batch = 1 if "/pf_" in nm else self.slots
                self.scope.set(nm, torch.zeros(
                    (batch, self.bucket, self.hidden_dim),
                    dtype=torch.float32, device=self.device))

    def warmup(self):
        """Run each program twice (on a card: the interpreted warm-up,
        then the capture), then reset: steady-state traffic captures
        nothing."""
        for _ in range(2):
            self.prefill(0, [0])
            self.decode_step(np.zeros(self.slots, np.int64),
                             np.zeros(self.slots, np.int32),
                             np.zeros(self.slots, np.float32))
        self.reset()

    def _run(self, program, feed, fetch):
        exe = self.executor
        self.keys.add(exe._fingerprint(program, feed, [fetch.name],
                                       self.scope, True))
        (out,) = exe.run(program, feed=feed, fetch_list=[fetch],
                         scope=self.scope, is_test=True)
        return out

    # -- the two programs ----------------------------------------------------
    def prefill(self, slot: int, tokens: Sequence[int]):
        """Run the prompt through the batch-1 prefill program, copy the
        scratch K/V rows into ``slot``'s rows of the slot slabs, and
        return ``(first generated token, logits row [V] float32)``."""
        plen = len(tokens)
        if not 1 <= plen <= self.bucket:
            raise ValueError(
                f"prompt length {plen} outside [1, {self.bucket}] "
                f"(bucket={self.bucket})")
        padded = np.zeros((1, self.bucket, 1), np.int64)
        padded[0, :plen, 0] = np.asarray(tokens, np.int64)
        logits = self._run(self.prefill_prog,
                           {"tokens": padded,
                            "cache_len": np.zeros(1, np.int32),
                            "write_mask": np.ones(1, np.float32)},
                           self._pf_logits)
        for i in range(self.n_layers):
            for c in ("k", "v"):
                slab = self.scope.get(f"{self.name}/kv_{c}{i}")
                slab[slot].copy_(self.scope.get(f"{self.name}/pf_{c}{i}")[0])
        row = np.asarray(logits[0, plen - 1], np.float32)
        return int(row.argmax()), row

    def decode_step(self, tokens: np.ndarray, lens: np.ndarray,
                    active: np.ndarray) -> np.ndarray:
        """One token step for every slot: ``tokens``/``lens``/``active``
        are [S] arrays (dead slots: token 0, active 0.0; their slab rows
        are never written).  Returns logits [S, 1, V] float32."""
        return self._run(self.decode_prog,
                         {"tokens": np.asarray(tokens, np.int64)
                          .reshape(self.slots, 1, 1),
                          "cache_len": np.asarray(lens, np.int32),
                          "write_mask": np.asarray(active, np.float32)},
                         self._dec_logits)


class _Seq:
    """One generate request riding the pool: queued, then slotted."""

    __slots__ = ("req", "prompt", "max_new", "tokens", "slot",
                 "t_first", "t_last", "inter_ms")

    def __init__(self, req: PendingResponse, prompt: List[int],
                 max_new: int):
        self.req = req
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.t_first: Optional[float] = None   # first token (TTFT)
        self.t_last: Optional[float] = None
        self.inter_ms: List[float] = []


class DecodeRuntime:
    """The continuous-batching slot pool over one :class:`DecodeEngine`.

    Standalone (``start()`` / ``submit()`` / ``shutdown()``) or mounted on
    a :class:`~paddle_tpu_torch.serving.server.Server` through
    ``add_decode_model``.  ``mode="static"`` is the control arm: the
    whole batch waits for its slowest member.  ``observe``: write the
    pool's metrics, events and spans (default: the global ``observe``
    flag when the pool is built)."""

    def __init__(self, engine: DecodeEngine, name: Optional[str] = None,
                 mode: str = "continuous",
                 step_wait_ms: Optional[float] = None,
                 default_deadline_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None, shed: bool = True,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 retry_policy: Optional[_faults.RetryPolicy] = None,
                 autotune: Optional[bool] = None,
                 observe: Optional[bool] = None):
        if mode not in ("continuous", "static"):
            raise ValueError(
                f"mode must be 'continuous' or 'static', got {mode!r}")
        if step_wait_ms is None:
            step_wait_ms = float(resolve_tuned(
                "serving/decode_slots", dict(DECODE_SLOTS_DEFAULT),
                autotune)["step_wait_ms"])
        self.engine = engine
        self.observe = obs.enabled() if observe is None else bool(observe)
        self.name = str(name or engine.name)
        self.mode = mode
        self.step_wait_s = float(step_wait_ms) / 1e3
        self.default_deadline_ms = default_deadline_ms
        self.queue_capacity = queue_capacity
        self.shed = bool(shed)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.retry_policy = retry_policy if retry_policy is not None else \
            _faults.RetryPolicy(max_attempts=2, backoff_base_s=0.005,
                                backoff_max_s=0.1, seed=0)
        # re-entrant: submit() reads breaker_state() under the admission
        # condition, which shares this lock
        self.lock = _lw.make_rlock("serving.decode")
        self.cond = _lw.make_condition("serving.decode", self.lock)
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[_Seq]] = [None] * engine.slots
        self.closed = False
        self.consecutive_failures = 0
        self.breaker_open = False
        self.breaker_open_until = 0.0
        self.steps = 0
        self.tokens_done = 0
        self.served = 0
        self.t_start = time.monotonic()
        self._req_counter = 0
        self._thread: Optional[threading.Thread] = None

    # -- breaker (the request server's semantics) ----------------------------
    def breaker_state(self, now: Optional[float] = None) -> str:
        with self.lock:
            if not self.breaker_open:
                return "closed"
            now = time.monotonic() if now is None else now
            return "half_open" if now >= self.breaker_open_until else "open"

    def _note_failure(self, err: BaseException, span=None):
        opened = False
        with self.lock:
            self.consecutive_failures += 1
            if (self.consecutive_failures >= self.breaker_threshold
                    and not self.breaker_open):
                self.breaker_open = True
                opened = True
            if self.breaker_open:
                self.breaker_open_until = (time.monotonic()
                                           + self.breaker_cooldown_s)
        if opened:
            if self.observe:
                obs.inc_counter("serving/breaker_open")
                obs.emit_event("serving", event="breaker_open",
                               model=self.name,
                               error=f"{type(err).__name__}: {err}")
            if span is not None:
                span.event("breaker_open",
                           error=f"{type(err).__name__}: {err}")
            logger.error("serving: circuit breaker OPEN for decode model "
                         "%r after %d consecutive failures (%s: %s)",
                         self.name, self.consecutive_failures,
                         type(err).__name__, err)

    def _note_success(self, span=None):
        with self.lock:
            self.consecutive_failures = 0
            closed, self.breaker_open = self.breaker_open, False
        if closed:
            if self.observe:
                obs.emit_event("serving", event="breaker_close",
                               model=self.name)
            if span is not None:
                span.event("breaker_close")
            logger.info("serving: circuit breaker closed for decode "
                        "model %r (probe succeeded)", self.name)

    # -- lifecycle -----------------------------------------------------------
    def start(self, warmup: bool = True):
        if self._thread is not None:
            raise RuntimeError("DecodeRuntime.start: already started")
        if warmup:
            self.engine.warmup()
        self.t_start = time.monotonic()
        self._thread = threading.Thread(
            target=self._step_loop, name=f"pt-decode-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def close(self):
        """Close admission; the loop drains queued and active work."""
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None):
        if not drain:
            with self.cond:
                self.closed = True
                aborted = list(self.queue)
                self.queue.clear()
                actives = [s for s in self.slots if s is not None]
                self.slots = [None] * self.engine.slots
                self.cond.notify_all()
            err = _faults.ServerClosed(
                "server stopped before this request completed")
            for w in aborted + actives:
                w.req._complete(error=err)
        else:
            self.close()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- admission -----------------------------------------------------------
    def submit(self, tokens: Sequence[int], max_new_tokens: int,
               deadline_ms: Optional[float] = -1.0,
               req_id=None) -> PendingResponse:
        """Admit one generate request: ``tokens`` is the prompt (ints),
        ``max_new_tokens`` bounds generation (EOS may end it earlier).
        Completes with ``{"tokens": [...], "finish": "eos"|"length",
        "ttft_ms": float, "inter_token_ms": [...]}``.  Shedding happens
        at token-step boundaries, not here; admission rejects only a
        closed pool, an open breaker, a malformed request, and a full
        queue when ``shed=False``."""
        prompt = [int(t) for t in tokens]
        max_new = int(max_new_tokens)
        if not prompt:
            raise ValueError("submit: empty prompt")
        if max_new < 1:
            raise ValueError(f"submit: max_new_tokens must be >= 1, "
                             f"got {max_new}")
        if len(prompt) + max_new > self.engine.bucket:
            raise ValueError(
                f"decode model {self.name!r}: prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new}) exceeds the engine's "
                f"max-len bucket ({self.engine.bucket})")
        if req_id is None:
            with self.lock:
                self._req_counter += 1
                req_id = f"{self.name}-{self._req_counter}"
        sp = obs.tracing.start_span(
            "serving/request", parent=obs.tracing.ROOT,
            model=self.name, id=req_id) if self.observe else None
        try:
            if deadline_ms == -1.0:
                deadline_ms = self.default_deadline_ms
            deadline = None if deadline_ms is None \
                else time.monotonic() + deadline_ms / 1e3
            req = PendingResponse(
                req_id, self.name,
                {"tokens": np.asarray(prompt, np.int64)}, deadline)
            req.span = sp
            w = _Seq(req, prompt, max_new)
            with self.cond:
                if self.closed:
                    raise _faults.ServerClosed(
                        f"decode model {self.name!r}: admission closed")
                if self.breaker_state() == "open":
                    raise _faults.ModelUnavailable(
                        f"decode model {self.name!r}: circuit breaker "
                        f"open; retry after cooldown")
                if (not self.shed and self.queue_capacity is not None
                        and len(self.queue) >= self.queue_capacity):
                    self._note_shed("incoming", "decode_admission")
                    raise _faults.Overloaded(
                        f"decode model {self.name!r}: queue full "
                        f"({self.queue_capacity})")
                self.queue.append(w)
                self.cond.notify()
            if self.observe:
                obs.inc_counter("serving/requests")
            return req
        except BaseException as e:
            if sp is not None:
                sp.end(status=type(e).__name__)
            raise

    # -- health --------------------------------------------------------------
    def health(self) -> dict:
        with self.lock:
            active = sum(1 for s in self.slots if s is not None)
            return {"breaker": ("closed" if not self.breaker_open else
                                "open"),
                    "slots": self.engine.slots,
                    "active": active,
                    "queue_depth": len(self.queue),
                    "served": self.served,
                    "steps": self.steps,
                    "tokens": self.tokens_done,
                    "mode": self.mode}

    # -- step loop -----------------------------------------------------------
    def _expire(self, w: _Seq, where: str) -> bool:
        if not w.req.expired():
            return False
        if self.observe:
            obs.inc_counter("serving/deadline_expired")
            obs.emit_event("serving", event="deadline_expired",
                           model=self.name, where=where)
        w.req._complete(error=_faults.DeadlineExceeded(
            f"request {w.req.id!r}: deadline expired before {where}"))
        return True

    def _note_shed(self, victim: str, where: str):
        if self.observe:
            obs.inc_counter("serving/shed")
            obs.emit_event("serving", event="shed", model=self.name,
                           victim=victim, where=where)

    def _shed_locked(self):
        """Oldest-deadline-first shedding at the token-step boundary:
        while the queue is over capacity, the queued request with the
        soonest deadline completes ``Overloaded``; with no deadlines it
        is the newest arrival."""
        if self.queue_capacity is None or not self.shed:
            return
        shed = []
        while len(self.queue) > self.queue_capacity:
            with_dl = [w for w in self.queue
                       if w.req.deadline is not None]
            victim = (min(with_dl, key=lambda w: w.req.deadline)
                      if with_dl else self.queue[-1])
            self.queue.remove(victim)
            shed.append(victim)
        for w in shed:
            self._note_shed("queued", "decode_step")
            w.req._complete(error=_faults.Overloaded(
                f"decode model {self.name!r}: shed at step boundary "
                f"(oldest deadline first)"))

    def _pick_admits_locked(self) -> List[_Seq]:
        if self.breaker_open \
                and time.monotonic() < self.breaker_open_until:
            return []
        if self.mode == "static" \
                and any(s is not None for s in self.slots):
            return []
        free = [i for i, s in enumerate(self.slots) if s is None]
        admits: List[_Seq] = []
        while free and self.queue:
            w = self.queue.popleft()
            if self._expire(w, "decode_admit"):
                continue
            w.slot = free.pop(0)
            admits.append(w)
        return admits

    def _finish(self, w: _Seq, finish: str):
        if w.slot is not None and self.slots[w.slot] is w:
            self.slots[w.slot] = None
        with self.lock:
            self.served += 1
        ttft = None if w.t_first is None \
            else (w.t_first - w.req.t_admit) * 1e3
        if self.observe:
            obs.emit_event("serving", event="decode_done",
                           model=self.name, id=w.req.id,
                           tokens=len(w.tokens), finish=finish,
                           ttft_ms=None if ttft is None else round(ttft, 3))
        w.req._complete(outputs={
            "tokens": list(w.tokens), "finish": finish,
            "ttft_ms": ttft, "inter_token_ms": list(w.inter_ms)})

    def _fail_active(self, err: BaseException):
        """Complete every active sequence with a typed error and zero the
        slabs (the evicted sessions' state is unrecoverable anyway).
        Queued requests are untouched."""
        with self.cond:
            actives = [s for s in self.slots if s is not None]
            self.slots = [None] * self.engine.slots
        for w in actives:
            w.req._complete(error=err)
        self.engine.reset()

    def _do_prefill(self, w: _Seq):
        try:
            tok, _ = self.engine.prefill(w.slot, w.prompt)
        except BaseException as e:   # noqa: BLE001 — a prefill crash
            # fails this request (typed), counts toward the breaker, and
            # must not end the step loop
            logger.exception("serving: prefill for decode model %r "
                             "failed", self.name)
            self._note_failure(e)
            w.req._complete(error=ModelError(
                f"decode model {self.name!r}: prefill failed "
                f"({type(e).__name__}: {e})"))
            return
        self._note_success()
        now = time.monotonic()
        w.tokens.append(tok)
        w.t_first = w.t_last = now
        self.slots[w.slot] = w
        with self.lock:
            self.tokens_done += 1
        if self.observe:
            obs.inc_counter("serving/decode_tokens")
            ttft = (now - w.req.t_admit) * 1e3
            obs.observe_hist("serving/decode_ttft_ms", ttft)
            obs.emit_event("serving", event="decode_admit",
                           model=self.name, id=w.req.id, slot=w.slot,
                           prompt_len=len(w.prompt),
                           ttft_ms=round(ttft, 3))
        if self.engine.eos_id is not None and tok == self.engine.eos_id:
            self._finish(w, "eos")
        elif len(w.tokens) >= w.max_new:
            self._finish(w, "length")

    def _dispatch(self, toks, lens, act, span=None):
        """The decode dispatch through the injection site and the retry
        rim.  The site fires before the executor call, so an injected
        transient retries with the slabs untouched."""
        def attempt():
            if _fi.ENABLED:
                action = _fi.check("serving.decode_step")
                if action is not None:
                    if action == "fatal":
                        raise _faults.InjectedFault(
                            "injected fatal fault at serving.decode_step")
                    _fi.raise_for(action, "serving.decode_step")
            return self.engine.decode_step(toks, lens, act)

        def on_retry(i, e, d):
            obs.inc_counter("fault/retries")
            obs.emit_event("fault", event="retry",
                           site="serving.decode_step", attempt=i + 1,
                           delay_s=round(d, 4),
                           error=f"{type(e).__name__}: {e}")
            if span is not None:
                span.event("retry", attempt=i + 1, delay_s=round(d, 4),
                           error=f"{type(e).__name__}: {e}")

        if self.retry_policy is None:
            return attempt()
        return _faults.retry_call(
            attempt, self.retry_policy, what=f"decode step [{self.name}]",
            on_retry=on_retry if self.observe else None)

    def _decode_step(self):
        S = self.engine.slots
        toks = np.zeros(S, np.int64)
        lens = np.zeros(S, np.int32)
        act = np.zeros(S, np.float32)
        live: List[_Seq] = []
        for i, w in enumerate(self.slots):
            if w is None:
                continue
            if self._expire(w, "decode_step"):
                self.slots[i] = None
                continue
            toks[i] = w.tokens[-1]
            lens[i] = len(w.prompt) + len(w.tokens) - 1
            act[i] = 1.0
            live.append(w)
        if not live:
            return
        sp = obs.tracing.start_span(
            "serving/decode_step", parent=obs.tracing.ROOT,
            model=self.name, active=len(live),
            step=self.steps) if self.observe else None
        t0 = time.monotonic()
        try:
            logits = self._dispatch(toks, lens, act, span=sp)
        except BaseException as e:
            self._note_failure(e, span=sp)
            if sp is not None:
                obs.emit_event("serving", event="error", model=self.name,
                               error=f"{type(e).__name__}: {e}")
            self._fail_active(ModelError(
                f"decode model {self.name!r}: step dispatch failed "
                f"({type(e).__name__}: {e})"))
            if sp is not None:
                sp.end(status=type(e).__name__)
            return
        dispatch_ms = (time.monotonic() - t0) * 1e3
        self._note_success(span=sp)
        now = time.monotonic()
        with self.lock:
            self.steps += 1
            self.tokens_done += len(live)
            tokens_done, t_start = self.tokens_done, self.t_start
        if sp is not None:
            obs.inc_counter("serving/decode_tokens", len(live))
            obs.set_gauge("serving/decode_slot_occupancy",
                          len(live) / float(S))
            obs.set_gauge("serving/decode_tokens_per_s",
                          tokens_done / max(now - t_start, 1e-9))
        for w in live:
            nxt = int(np.argmax(logits[w.slot, 0]))
            w.tokens.append(nxt)
            gap = (now - w.t_last) * 1e3
            w.inter_ms.append(gap)
            w.t_last = now
            if sp is not None:
                obs.observe_hist("serving/decode_inter_token_ms", gap)
            if self.engine.eos_id is not None \
                    and nxt == self.engine.eos_id:
                self._finish(w, "eos")
            elif len(w.tokens) >= w.max_new:
                self._finish(w, "length")
        if sp is not None:
            with self.lock:
                queued = len(self.queue)
            obs.emit_event("serving", event="decode_step", model=self.name,
                           active=len(live), queued=queued,
                           dispatch_ms=round(dispatch_ms, 3))
            sp.end(status="ok", dispatch_ms=round(dispatch_ms, 3))

    def _step_loop(self):
        try:
            while True:
                with self.cond:
                    self._shed_locked()
                    if self.closed and not self.queue \
                            and not any(s is not None
                                        for s in self.slots):
                        break
                    admits = self._pick_admits_locked()
                for w in admits:
                    self._do_prefill(w)
                if not any(s is not None for s in self.slots):
                    if admits:
                        continue        # re-check the queue at once
                    with self.cond:
                        if not self.queue and not self.closed:
                            self.cond.wait(self.step_wait_s)
                        elif self.queue and self.breaker_open:
                            # open breaker: nothing to dispatch until the
                            # cooldown admits a probe
                            self.cond.wait(self.step_wait_s)
                    continue
                self._decode_step()
        except BaseException:   # noqa: BLE001 — a dead loop would
            # strand every queued and active request: give them terminal
            # errors instead of a hang
            logger.exception("serving: decode step loop for model %r "
                             "died", self.name)
            err = ModelError(
                f"decode model {self.name!r}: internal step-loop error")
            with self.cond:
                stranded = list(self.queue)
                self.queue.clear()
                stranded += [s for s in self.slots if s is not None]
                self.slots = [None] * self.engine.slots
            for w in stranded:
                w.req._complete(error=err)
