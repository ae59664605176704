"""Fake tenants of the port's serving tests (the counterparts of
``tests/test_serving.py``'s ``FakeModel``, ``_mk_server``, ``_req`` and
``_soak_pipeline``), over ``paddle_tpu_torch.serving``: a gated fake makes
"the dispatcher is busy" a fact, not a race."""
from __future__ import annotations

import threading
import time

import numpy as np

from paddle_tpu_torch.serving import Model, Server


class FakeModel:
    """Row-wise fake tenant: output = feeds['x'] * 2.  ``gate`` (when
    set) blocks each dispatch until released; ``fail`` is a list of
    exceptions to raise, one per dispatch, None = succeed."""

    def __init__(self, name="fake", gate=False, fail=None):
        self.calls = []                  # list of batch sizes dispatched
        self.rows = []                   # all rows ever computed
        self.gate = threading.Event() if gate else None
        self.release_all = False
        self.fail = list(fail or [])
        self.model = Model(name, self._fn,
                           example={"x": np.zeros(2, "float32")})

    def _fn(self, feeds):
        if self.gate is not None and not self.release_all:
            if not self.gate.wait(timeout=10):
                raise RuntimeError("FakeModel gate never released")
            self.gate.clear()
        if self.fail:
            err = self.fail.pop(0)
            if err is not None:
                self.calls.append(int(feeds["x"].shape[0]))
                raise err
        x = np.asarray(feeds["x"])
        self.calls.append(int(x.shape[0]))
        self.rows.extend(x[:, 0].tolist())
        return [x * 2.0]

    def open_gate_forever(self):
        self.release_all = True
        self.gate.set()


def mk_server(fake, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("deadline_ms", 5000.0)
    kw.setdefault("queue_capacity", 16)
    kw.setdefault("warmup", False)
    srv = Server(**kw)
    models = fake if isinstance(fake, (list, tuple)) else [fake]
    for m in models:
        srv.add_model(m.model if isinstance(m, FakeModel) else m)
    srv.start()
    return srv


def req(i, dim=2):
    return {"x": np.full(dim, float(i), "float32")}


def soak_pipeline(srv, n=3, deadline_ms=60000.0):
    """Fill the dispatcher (gated model), the staging queue and the
    batcher's hands, so subsequent submits ACCUMULATE in the admission
    queue.  With max_batch=1 and staging_depth=1 that is 3 requests: one
    dispatching, one staged, one held by the blocked batcher."""
    held = []
    for i in range(n):
        held.append(srv.submit(req(1000 + i), deadline_ms=deadline_ms))
        time.sleep(0.05)
    return held
