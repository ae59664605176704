"""Deterministic fault injection behind ``PADDLE_TPU_FAULT_SPEC``
(counterpart of ``paddle_tpu/testing/faultinject.py``).

Every failure the training runtime promises to survive has an injection
site, a named hook on the real code path, so a test can make "the
process was preempted at step 7" or "the checkpoint write tore" a
reproducible fact.  With no spec configured each site costs one module
attribute check (``if faultinject.ENABLED:``).

Spec grammar (``;``-separated entries)::

    PADDLE_TPU_FAULT_SPEC = "<site>@<when>=<action>[;...]"

* ``site``: a dotted site name (below).
* ``when``: ``N`` fires when the site's index equals N.  Sites called
  with an explicit index (the trainer's global batch counter) match on
  it, so a resumed run that starts past N does not fire again; the
  others match on their 1-based hit count in this process.  ``*`` fires
  on every hit.
* ``action``: ``error`` (:class:`InjectedFault`), ``transient``
  (:class:`TransientDispatchError`, retryable) and ``drop``
  (``ConnectionError``) at every site, through :func:`raise_for`; and
  the sites' own: ``truncate`` (``ckpt.write``/``ckpt.delta``: a torn
  file, after its md5 was recorded), ``kill`` (``ckpt.delta``: SIGKILL
  mid-chain), ``preempt`` (``trainer.step``: as if SIGTERM arrived),
  ``sigterm`` (``trainer.step``: a real SIGTERM to this process) and
  ``kill`` (``trainer.step``: a real SIGKILL).

The sites of the port:

=====================  =====================================================
``trainer.step``       per completed batch in ``trainer.SGD.train`` (index:
                       the global batch counter)
``reader.item``        per batch pulled from the reader, before its step
                       runs (index: the global batch counter)
``executor.dispatch``  per step dispatch in ``Executor.run``/``run_steps``,
                       inside the retry rim and before the step runs
``ckpt.write``         per file a full checkpoint commit writes
``ckpt.delta``         per file a delta checkpoint commit writes
``serving.request``    per request ``serving.Server.submit`` admits (hit
                       count); ``delay[:ms]`` sleeps (50 ms by default)
                       before admission
``serving.dispatch``   per batch the server dispatches, inside its retry
                       rim; ``fatal`` raises :class:`InjectedFault`
                       (fatal: it counts toward the circuit breaker)
``serving.decode_step`` per token step of a decode pool
                       (``serving/decode.py``), inside the retry rim and
                       before the executor call, so the cache slabs are
                       untouched when it fires; ``fatal`` as above
``sparse.push``        per push of a ``SparseSession``, inside its retry
                       rim
``pserver.rpc``        per frame a shard server handles; ``drop`` tears
                       the connection
``pserver.shard``      per push a shard server applies (index: its
                       applied pushes), after the apply and before the
                       ack; ``kill`` is a real SIGKILL
=====================  =====================================================

The master, elastic and tuning sites of the JAX package come with their
slices.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from ..faults import InjectedFault, TransientDispatchError

__all__ = [
    "ENABLED", "configure", "clear", "active_spec", "check", "raise_for",
    "hits", "fired", "KNOWN_SITES", "InjectedFault",
]

KNOWN_SITES = ("trainer.step", "reader.item", "executor.dispatch",
               "ckpt.write", "ckpt.delta", "serving.request",
               "serving.dispatch", "serving.decode_step", "sparse.push",
               "pserver.rpc", "pserver.shard")

# the off switch the call sites test: one attribute load when off
ENABLED = False

_lock = threading.Lock()
_entries: List[Tuple[str, Optional[int], str]] = []   # (site, when, action)
_hit_counts: Dict[str, int] = {}
_fired_counts: Dict[str, int] = {}
_spec_text = ""


def _parse(spec: str) -> List[Tuple[str, Optional[int], str]]:
    entries = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, sep, action = raw.partition("=")
        if not sep or not action:
            raise ValueError(
                f"fault spec entry {raw!r}: want site@when=action")
        site, sep, when_s = head.partition("@")
        site = site.strip()
        if not sep or not site:
            raise ValueError(
                f"fault spec entry {raw!r}: want site@when=action")
        when_s = when_s.strip()
        if when_s == "*":
            when: Optional[int] = None
        else:
            try:
                when = int(when_s)
            except ValueError:
                raise ValueError(
                    f"fault spec entry {raw!r}: when must be an integer "
                    f"or '*', got {when_s!r}")
        entries.append((site, when, action.strip()))
    return entries


def configure(spec: str):
    """Parse and activate a spec (replacing any active one; every hit
    count starts again).  An empty spec is :func:`clear`."""
    global ENABLED, _entries, _spec_text
    parsed = _parse(spec)
    with _lock:
        _entries = parsed
        _spec_text = spec
        _hit_counts.clear()
        _fired_counts.clear()
        ENABLED = bool(parsed)


def clear():
    """Turn injection off (the default)."""
    global ENABLED, _entries, _spec_text
    with _lock:
        _entries = []
        _spec_text = ""
        _hit_counts.clear()
        _fired_counts.clear()
        ENABLED = False


def active_spec() -> str:
    return _spec_text


def hits(site: str) -> int:
    """Times ``site`` was checked without an explicit index since
    :func:`configure`."""
    with _lock:
        return _hit_counts.get(site, 0)


def fired(site: str) -> int:
    """Times an injection fired at ``site``."""
    with _lock:
        return _fired_counts.get(site, 0)


def check(site: str, index: Optional[int] = None) -> Optional[str]:
    """The action to inject at this hit of ``site``, or None.  Call it
    only behind ``if faultinject.ENABLED:``.  ``index``: the site's
    natural position; without one, the 1-based hit count."""
    with _lock:
        if not _entries:
            return None
        if index is None:
            index = _hit_counts.get(site, 0) + 1
            _hit_counts[site] = index
        action = None
        for s, when, a in _entries:
            if s == site and (when is None or when == int(index)):
                action = a
                break
        if action is None:
            return None
        _fired_counts[site] = _fired_counts.get(site, 0) + 1
    _record(site, int(index), action)
    return action


def _record(site: str, index: int, action: str):
    # an injection is firing (a cold path): the registry write and the
    # JSONL event are unconditional, so the fault history reaches the log
    from ..observability import emit_event, inc_counter
    inc_counter("fault/injected")
    emit_event("fault", event="injected", site=site, index=index,
               action=action)


def raise_for(action: str, site: str, index: Optional[int] = None):
    """Raise the exception of a generic action.  Sites handle their own
    actions first and route the rest here, so an action this function
    does not know is a mistake in the spec: ValueError, never a silent
    no-op after :func:`check` counted the injection as fired."""
    at = f"{site}" + (f"#{index}" if index is not None else "")
    if action == "error":
        raise InjectedFault(f"injected fault at {at}")
    if action == "transient":
        raise TransientDispatchError(f"injected transient fault at {at}")
    if action == "drop":
        raise ConnectionError(f"injected connection drop at {at}")
    raise ValueError(
        f"fault spec: action {action!r} is not understood at site {at} "
        f"(generic actions: error/transient/drop; site-specific actions "
        f"must target their own site)")


# the environment's spec, parsed once at import; configure() and clear()
# override it
_env_spec = os.environ.get("PADDLE_TPU_FAULT_SPEC", "")
if _env_spec:
    configure(_env_spec)
