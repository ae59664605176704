"""High-level trainer with the v2 event-loop surface (counterpart of
``paddle_tpu/trainer.py``; reference: python/paddle/v2/trainer.py).

``SGD(cost, update_equation=opt).train(reader, ...)`` builds the
optimizer's ops into the cost's program, runs the startup program once,
and steps the training loop, firing :class:`events` around each pass and
batch: per batch through ``Executor.run``, in stacked runs of
``steps_per_dispatch`` through ``Executor.run_steps``, or, with
``pipeline=``, through ``Executor.run_pipelined`` (decode on reader
workers, staging on its own thread).  With ``checkpoint_dir`` the loop
checkpoints, handles preemption and resumes bit-identically
(``train_state.py``).  With ``sparse_tables=`` a ``SparseSession``
pulls each batch's rows of the host-resident tables before its step and
pushes their gradients after it (``paddle_tpu_torch.sparse``).
``validate=`` runs the static verifier for the call (``analysis``).

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item that brings them: ``warmup`` (``Executor.compile``, item
6), ``auto_shard`` (item 7), ``master`` and ``elastic`` (item 8c) and
``autotune`` (item 9d).  With the executor
observing, a periodic report (``observability.maybe_periodic_report``)
fires every ``log_period`` batches.
"""
from __future__ import annotations

import os
import signal as _signal
from typing import Callable, Optional, Sequence

import numpy as np

from . import observability
from . import optimizer as optimizer_mod
from .core.executor import Executor, _feed_signature, stack_feeds
from .core.program import Program, Variable, default_startup_program
from .core.scope import global_scope
from .data_feeder import DataFeeder
from .testing import faultinject as _fi

__all__ = ["events", "SGD", "infer"]


class events:
    """Event types passed to event_handler (python/paddle/v2/event.py)."""

    class BeginPass:
        def __init__(self, pass_id):
            self.pass_id = pass_id

    class EndPass:
        def __init__(self, pass_id, evaluator=None):
            self.pass_id = pass_id
            self.evaluator = evaluator

    class BeginIteration:
        def __init__(self, pass_id, batch_id):
            self.pass_id = pass_id
            self.batch_id = batch_id

    class EndIteration:
        def __init__(self, pass_id, batch_id, cost, metrics):
            self.pass_id = pass_id
            self.batch_id = batch_id
            self.cost = cost
            self.metrics = metrics


# train() arguments of the JAX trainer that the port does not take yet,
# with the ROADMAP Queue A item that brings each
_NOT_PORTED = {
    "warmup": "item 6 (Executor.compile)",
    "autotune": "item 9d (tuning)",
    "auto_shard": "item 7 (multi-GPU)",
    "master": "item 8c (the task-queue master)",
    "elastic": "item 8c (the elastic service)",
}


class SGD:
    """v2-style trainer: ``SGD(cost, parameters=None,
    update_equation=opt)``.

    ``update_equation`` is any ``paddle_tpu_torch.optimizer`` optimizer;
    ``extra_layers`` are fetched alongside the cost every iteration and
    reported in ``EndIteration.metrics``; ``place`` is the executor's
    (default ``CUDAPlace(0)``)."""

    def __init__(self, cost: Variable, parameters=None,
                 update_equation=None, extra_layers: Sequence = (),
                 is_local=True, place=None):
        self.cost = cost
        self.extra = list(extra_layers or ())
        self.optimizer = update_equation or optimizer_mod.SGD(
            learning_rate=0.01)
        self.main_program = cost.block.program
        self.optimizer.minimize(cost)
        self.exe = Executor(place)
        self._initialized = False
        # the last train(checkpoint_dir=...) call's Checkpointer
        self.checkpointer = None

    # -- training ----------------------------------------------------------
    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding=None, feed_list: Optional[Sequence[Variable]] = None,
              steps_per_dispatch: int = 1, pipeline=False,
              warmup: bool = False, validate: Optional[bool] = None,
              autotune: Optional[bool] = None, auto_shard=None,
              checkpoint_dir: Optional[str] = None, resume: bool = False,
              save_every_n_steps: Optional[int] = None, master=None,
              handle_signals: bool = True, elastic=None,
              sparse_tables=None):
        """``reader`` yields batches (lists of rows); ``feeding`` maps
        data-layer names to row positions, or pass ``feed_list``.

        ``steps_per_dispatch > 1`` stacks runs of consecutive same-shape
        batches and runs each as one ``Executor.run_steps`` with stacked
        feeds; iteration events still fire per batch, after the dispatch
        that held it; a batch of another shape flushes the run.

        ``pipeline`` turns on the asynchronous input pipeline
        (``Executor.run_pipelined``): ``True`` for the defaults or a dict
        with any of ``steps_per_dispatch`` (default 8, or the
        ``steps_per_dispatch`` argument when > 1), ``num_workers``
        (reader prefetch workers, default 1; 0 decodes in the staging
        thread), ``buffer_size`` (decoded batches queued, default 4) and
        ``prefetch_depth`` (staged dispatches in flight, default 2).  The
        step math is the per-batch loop's; only the events' timing
        changes.

        ``checkpoint_dir`` turns on the training runtime
        (``train_state.py``): every ``save_every_n_steps`` completed
        batches the scope and the loop's ``TrainState`` (the pass, batch
        and step counters; the step counter places the random streams)
        commit atomically; a SIGTERM or SIGINT finishes the dispatch in
        flight, commits an emergency checkpoint and raises
        ``faults.Preempted`` (exit 75), so a supervisor
        (``distributed/supervisor.py``) relaunches the run.
        ``resume=True`` restores the newest intact checkpoint and goes
        on: with a deterministic, restartable ``reader`` and an
        order-keeping pipeline (``num_workers <= 1``) the resumed run's
        fetches equal an uninterrupted run's bit for bit; an empty
        directory starts fresh.  Saves happen at dispatch boundaries
        only, so with chunked dispatch the cadence rounds up to the
        chunk.  ``handle_signals=False`` installs no signal
        handlers.

        ``validate=True`` runs the static program verifier
        (``paddle_tpu_torch.analysis``) over the startup and training
        programs before their first step: a malformed graph fails with a
        stable ``PT0xx`` diagnostic naming the op.  ``False`` forces it
        off; ``None`` (default) defers to the executor's own setting and
        then the ``validate`` flag.  The override applies to this call
        only.

        ``sparse_tables``: a ``paddle_tpu_torch.sparse.SparseSession``
        (duck-typed: the trainer does not import the sparse package).
        Each batch's feed goes through its ``prepare_feed`` (id dedup,
        host pull, the rows and inverse-index feeds) before the step,
        and the fetched ``<rows>@GRAD`` arrays through ``complete`` (the
        host push) after it.  The per-batch loop is synchronous (pull,
        step, push: dense and sparse training bit-identical); the
        chunked and pipelined loops pull a chunk (plus the prefetch
        depth) ahead of the pushes, the reference's async-pserver
        staleness.  A session with ``prefetch_depth > 0`` prepares feeds
        on its worker thread; one with ``async_push > 0`` pushes on its
        worker, with a ``flush`` barrier before every checkpoint export,
        every ``test`` pull and at the end of ``train``.  With
        ``checkpoint_dir`` the tables ride in every checkpoint and
        restore on ``resume``."""
        event_handler = event_handler or (lambda e: None)
        given = {"warmup": warmup,
                 "autotune": autotune, "auto_shard": auto_shard,
                 "master": master, "elastic": elastic}
        sess = sparse_tables
        if sess is not None:
            # the JAX trainer's refusals, before the ones of the port
            if elastic is not None:
                raise NotImplementedError(
                    "train(sparse_tables=..., elastic=...): the elastic "
                    "resize merge has no in-process sparse-row story; "
                    "host the rows outside the worker fleet instead "
                    "(a RemoteSparseTable against python -m "
                    "paddle_tpu_torch pserver)")
            if warmup:
                raise ValueError(
                    "train(sparse_tables=..., warmup=True) is not "
                    "supported: warmup compiles from a raw batch without "
                    "the session's rows feeds")
        for name, value in given.items():
            if value not in (None, False):
                raise NotImplementedError(
                    f"trainer.SGD.train({name}=...) is not ported yet: "
                    f"ROADMAP.md Queue A {_NOT_PORTED[name]}")
        if sess is not None:
            sess.bind(self.main_program)
        if not checkpoint_dir:
            # an operator who asked for checkpoints must never run
            # silently unprotected
            if resume:
                raise ValueError("train(resume=True) requires "
                                 "checkpoint_dir")
            if save_every_n_steps is not None:
                raise ValueError("train(save_every_n_steps=...) requires "
                                 "checkpoint_dir")
        # validate is a per-call override: the executor's own setting
        # comes back afterwards, so a later train() with the default None
        # defers to the flag again
        prev_validate = self.exe.validate
        if validate is not None:
            self.exe.validate = validate
        ckpt = None
        try:
            if not self._initialized:
                self.exe.run(default_startup_program(), feed={},
                             fetch_list=[])
                self._initialized = True
            start_pass, resume_skip = 0, 0
            if checkpoint_dir:
                from .train_state import Checkpointer
                opt_fp = {"type": type(self.optimizer).__name__}
                lr = getattr(self.optimizer, "_learning_rate", None)
                if isinstance(lr, (int, float)):
                    opt_fp["learning_rate"] = float(lr)
                ckpt = Checkpointer(checkpoint_dir, self.exe,
                                    save_every_n_steps=save_every_n_steps,
                                    handle_signals=handle_signals,
                                    sparse=sess)
                ts = None
                if resume:
                    ts = ckpt.restore(
                        global_scope(),
                        expect_seed=self.main_program.random_seed,
                        expect_optimizer=opt_fp)
                if ts is not None and sess is not None and \
                        not sess.restore_from_scope(global_scope()):
                    # the tables rode the checkpoint as __sparse__/ vars
                    raise ValueError(
                        "train(resume=True, sparse_tables=...): the "
                        "restored checkpoint carries no sparse-table "
                        "state; it was written by a run without "
                        "sparse_tables")
                if ts is not None:
                    # the step counter places every random op's stream
                    self.exe._step = ts.exe_step
                    start_pass, resume_skip = ts.pass_id, ts.batch_id
                ckpt.begin(global_scope(), ts,
                           self.main_program.random_seed, opt_fp)
            self.checkpointer = ckpt
            self._loop(reader, num_passes, event_handler, feeding,
                       feed_list, steps_per_dispatch, pipeline, ckpt,
                       start_pass, resume_skip, sess)
            if sess is not None:
                sess.flush()             # the async-push barrier
            if ckpt is not None:
                ckpt.final_save(num_passes)
        finally:
            self.exe.validate = prev_validate
            if ckpt is not None:
                ckpt.close()

    def _loop(self, reader, num_passes, event_handler, feeding, feed_list,
              steps_per_dispatch, pipeline, ckpt, start_pass, resume_skip,
              sess=None):
        fetch = [self.cost] + self.extra
        n_fetch = len(fetch)
        # a sparse session's <rows>@GRAD fetches ride after the model's;
        # finish() pushes them and strips them before the events
        sfetch = fetch + (sess.grad_fetch_list if sess is not None else [])

        def finish(out):
            if sess is None:
                return out
            sess.complete(out[n_fetch:])
            return out[:n_fetch]

        def prepared(feed_iter):
            """The feeds with the session's rows: on its worker thread
            when it prefetches, else inline."""
            if sess is None:
                return feed_iter
            if getattr(sess, "prefetch_depth", 0) > 0:
                return sess.prefetch_feeds(feed_iter)
            return (sess.prepare_feed(f) for f in feed_iter)
        # the global batch cursor (across passes and restarts): the index
        # of the trainer.step and reader.item fault sites, so a resumed
        # run never fires an entry it already passed
        gcount = [ckpt.emitted if ckpt is not None else 0]
        # periodic observability reports every `log_period` iterations
        # (v1's Stat::printAllStatus cadence, Flags.cpp:62), counted
        # across passes and restarts; no-op unless observing
        iters = [ckpt.iters_done if ckpt is not None else 0]
        observing = self.exe._observing()

        def emit_end(pass_id, batch_id, out):
            # the step counter before the handler runs: a handler that
            # runs executor work (trainer.test) must not blur this
            # batch's boundary
            step_now = self.exe._step
            metrics = {getattr(v, "name", str(i)): out[1 + i]
                       for i, v in enumerate(self.extra)}
            event_handler(events.EndIteration(pass_id, batch_id,
                                              float(out[0]), metrics))
            iters[0] += 1
            observability.maybe_periodic_report(iters[0],
                                                observing=observing)
            gcount[0] += 1
            if _fi.ENABLED:
                action = _fi.check("trainer.step", index=gcount[0])
                if action == "preempt":
                    if ckpt is None:
                        raise _fi.InjectedFault(
                            "trainer.step=preempt injected but train() "
                            "has no checkpoint_dir")
                    ckpt.request_preempt()
                elif action == "sigterm":
                    os.kill(os.getpid(), _signal.SIGTERM)
                elif action == "kill":
                    os.kill(os.getpid(), _signal.SIGKILL)
                elif action is not None:
                    _fi.raise_for(action, "trainer.step", gcount[0])
            if ckpt is not None:
                ckpt.on_batch_done(pass_id, batch_id, step_now)

        # the reader of a pass: the resumed pass skips the batches done,
        # and the reader.item site fires per batch; the plain reader when
        # neither applies
        rcount = [gcount[0]]

        def pass_reader(pass_id):
            skip = resume_skip if pass_id == start_pass else 0
            if skip == 0 and not _fi.ENABLED:
                return reader, 0

            def _r():
                for i, b in enumerate(reader()):
                    if i < skip:
                        continue
                    rcount[0] += 1
                    if _fi.ENABLED:
                        a = _fi.check("reader.item", index=rcount[0])
                        if a is not None:
                            _fi.raise_for(a, "reader.item", rcount[0])
                    yield b
            return _r, skip

        if pipeline:
            opts = dict(pipeline) if isinstance(pipeline, dict) else {}
            K = self._dispatch_k(opts, steps_per_dispatch)
            workers = int(opts.get("num_workers", 1))
            buf = int(opts.get("buffer_size", 4))
            depth = int(opts.get("prefetch_depth", 2))
            # feed() results live at most until their run is stacked or
            # shipped: K pending plus the in-flight slack
            feeder = self._feeder(feeding, feed_list, staging_slots=K + 2)
            from .reader.pipeline import prefetch
            for pass_id in range(start_pass, num_passes):
                event_handler(events.BeginPass(pass_id))
                if ckpt is not None:
                    ckpt.resync()
                r, skip = pass_reader(pass_id)
                src = prefetch(r, buffer_size=buf,
                               num_workers=workers) if workers > 0 else r
                feed_iter = prepared(feeder.feed(b) for b in src())
                gen = self.exe.run_pipelined(
                    feed_iter, self.main_program, fetch_list=sfetch,
                    steps_per_dispatch=K, prefetch_depth=depth)
                try:
                    for batch_id, out in enumerate(gen, start=skip):
                        out = finish(out)
                        event_handler(events.BeginIteration(pass_id,
                                                            batch_id))
                        emit_end(pass_id, batch_id, out)
                finally:
                    # close the pipelined generator first (it joins the
                    # staging thread that may be running feed_iter), then
                    # the feed source
                    gen.close()
                    feed_iter.close()
                event_handler(events.EndPass(pass_id))
            return

        feeder = self._feeder(feeding, feed_list)

        def flush(pass_id, first_id, chunk):
            if len(chunk) == 1:
                event_handler(events.BeginIteration(pass_id, first_id))
                out = finish(self.exe.run(self.main_program, feed=chunk[0],
                                          fetch_list=sfetch))
                emit_end(pass_id, first_id, out)
                return
            outs = self.exe.run_steps(
                len(chunk), self.main_program, feed=stack_feeds(chunk),
                fetch_list=sfetch, feeds_stacked=True)
            for i in range(len(chunk)):
                event_handler(events.BeginIteration(pass_id, first_id + i))
                emit_end(pass_id, first_id + i,
                         finish([o[i] for o in outs]))

        for pass_id in range(start_pass, num_passes):
            event_handler(events.BeginPass(pass_id))
            if ckpt is not None:
                ckpt.resync()
            r, skip = pass_reader(pass_id)
            if steps_per_dispatch <= 1 and (
                    sess is None
                    or getattr(sess, "prefetch_depth", 0) <= 0):
                # the synchronous rim: pull, step, push a batch
                for batch_id, batch in enumerate(r(), start=skip):
                    event_handler(events.BeginIteration(pass_id, batch_id))
                    feed = feeder.feed(batch)
                    if sess is not None:
                        feed = sess.prepare_feed(feed)
                    out = finish(self.exe.run(self.main_program, feed=feed,
                                              fetch_list=sfetch))
                    emit_end(pass_id, batch_id, out)
                event_handler(events.EndPass(pass_id))
                continue
            # chunked, or the session's pull-ahead worker: all K pulls of
            # a chunk precede its dispatch (async-pserver staleness)
            feed_src = prepared(feeder.feed(b) for b in r())
            chunk, first_id, sig = [], 0, None
            try:
                for batch_id, feed in enumerate(feed_src, start=skip):
                    fsig = _feed_signature(feed)
                    if chunk and fsig != sig:
                        flush(pass_id, first_id, chunk)
                        chunk = []
                    if not chunk:
                        first_id, sig = batch_id, fsig
                    chunk.append(feed)
                    if len(chunk) >= steps_per_dispatch:
                        flush(pass_id, first_id, chunk)
                        chunk = []
                if chunk:
                    flush(pass_id, first_id, chunk)
            finally:
                feed_src.close()
            event_handler(events.EndPass(pass_id))

    def test(self, reader: Callable, feeding=None, feed_list=None,
             sparse_tables=None):
        """Average cost (and extras) over a reader, without updating the
        parameters: the program pruned to them, in test mode.
        ``sparse_tables``: the training session, whose tables are read
        only (no gradient fetch, no push)."""
        feeder = self._feeder(feeding, feed_list)
        test_prog = self.main_program.prune(
            [self.cost] + self.extra).clone(for_test=True)
        if sparse_tables is not None:
            sparse_tables.bind(test_prog)
        totals, count = None, 0
        for batch in reader():
            feed = feeder.feed(batch)
            if sparse_tables is not None:
                feed = sparse_tables.prepare_feed(feed, is_test=True)
            out = self.exe.run(test_prog, feed=feed,
                               fetch_list=[self.cost] + self.extra,
                               is_test=True)
            vals = [np.asarray(o, np.float64) for o in out]
            totals = vals if totals is None else [
                t + v for t, v in zip(totals, vals)]
            count += 1
        if count == 0:
            return None
        return [t / count for t in totals]

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _dispatch_k(opts, steps_per_dispatch):
        """Steps per pipelined dispatch."""
        return int(opts.get("steps_per_dispatch",
                            steps_per_dispatch if steps_per_dispatch > 1
                            else 8))

    def _feeder(self, feeding, feed_list, staging_slots: int = 0):
        if feed_list is None:
            gb = self.main_program.global_block()
            if feeding is not None:
                order = sorted(feeding, key=lambda k: feeding[k])
                feed_list = [gb.var(n) for n in order]
            else:
                feed_list = [v for v in gb.vars.values()
                             if v.is_data and not v.session_feed]
        return DataFeeder(feed_list, staging_slots=staging_slots)

    def save_parameter_to_tar(self, f=None, dirname=None):
        """Save the parameters (``io.save_params``) into ``dirname`` (or
        ``f``, a directory path)."""
        from . import io
        io.save_params(self.exe, dirname or f, self.main_program)


def infer(output_layer, parameters=None, input=None, feeding=None,
          feed_list=None, executor=None, program: Optional[Program] = None):
    """v2 ``paddle.infer``: run the pruned inference slice on one batch
    (a list of rows); ``executor`` defaults to ``Executor()`` (the
    card)."""
    outputs = output_layer if isinstance(output_layer, (list, tuple)) \
        else [output_layer]
    program = program or outputs[0].block.program
    infer_prog = program.prune(outputs).clone(for_test=True)
    exe = executor or Executor()
    gb = program.global_block()
    if feed_list is None:
        if feeding is not None:
            order = sorted(feeding, key=lambda k: feeding[k])
            feed_list = [gb.var(n) for n in order]
        else:
            feed_list = [v for v in gb.vars.values()
                         if v.is_data and not v.session_feed]
    # only the feeds the pruned program reads
    needed = set()
    for op in infer_prog.global_block().ops:
        needed.update(op.input_names)
    feed_list = [v for v in feed_list if v.name in needed]
    res = exe.run(infer_prog, feed=DataFeeder(feed_list).feed(input),
                  fetch_list=outputs, is_test=True)
    return res if len(res) > 1 else res[0]
