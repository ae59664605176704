"""Built-in measurement targets for ``python -m paddle_tpu_torch tune`` and
``benchmark.autotune`` (counterpart of ``paddle_tpu/tuning/targets.py``).

A target binds a registered tunable to a self-contained workload whose
one-window run ``measure(config)`` the search engine times: the
subsystem's representative loop, sized so a full grid takes minutes
(``smoke=True`` shrinks it to seconds).  Each builder makes its fixture
once (programs, weights from a seed, data) and returns the closure; a
config's one-time costs (a build, a capture) land in the engine's
discarded warm-up windows.  Every ``measure`` ends on the card's
completion: a fetched numpy value, or ``torch.cuda.synchronize()``.

Host targets run anywhere, on the card where one is present (the
executor's default place) and on the CPU otherwise.  The device targets
time K1's launch plans (``cuda/conv1x1_plan``) and K2-K4's ring depths
(``cuda/flash_attention``) on the card; ``search.tune`` answers them
with the pending-hardware stub where ``torch.cuda.is_available()`` is
false.  A device ``measure`` counts its completed windows in
``measure.windows`` (each ``measure.steps`` kernel launches), so a
caller can hold the kernels' launch counters to the search.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["TARGETS", "build_target", "target_names", "ensure_registered"]


def _on_card() -> bool:
    return torch.cuda.is_available()


def _place():
    from ..core.executor import CPUPlace, CUDAPlace
    return CUDAPlace(0) if _on_card() else CPUPlace()


def _sync():
    if _on_card():
        torch.cuda.synchronize()


def _clients(n: int, name: str, work):
    """Run ``work(ci)`` on ``n`` client threads and re-raise the first
    error."""
    errors = []

    def client(ci):
        try:
            work(ci)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"pt-tune-{name}-{c}")
               for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _mlp(in_dim: int, hidden: int, classes: int, loss: bool):
    """(main, startup, pred, loss or None) of a small MLP classifier in a
    fresh program pair; with ``loss``, a label input and the mean cross
    entropy."""
    from .. import core, layers
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        x = layers.data("x", shape=[in_dim], dtype="float32")
        h = layers.fc(x, size=hidden, act="relu")
        pred = layers.fc(h, size=classes, act="softmax")
        cost = None
        if loss:
            y = layers.data("y", shape=[1], dtype="int64")
            cost = layers.mean(layers.cross_entropy(pred, y))
    return main, startup, pred, cost


# ---------------------------------------------------------------------------
# Host-side targets
# ---------------------------------------------------------------------------
def _target_run_pipelined(smoke: bool) -> Callable[[dict], None]:
    """Pipelined dispatch chunking on a dispatch-bound workload: a small
    MLP whose step is tiny on the device, so steps_per_dispatch (host
    dispatches per captured K-step run) and prefetch_depth (staging
    overlap) are the knobs that bind."""
    from ..core import Executor, Scope
    main, startup, _, loss = _mlp(64, 64, 8, loss=True)
    scope = Scope()
    exe = Executor(_place())
    exe.run(startup, feed={}, fetch_list=[], scope=scope)

    rng = np.random.RandomState(0)
    n = 8 if smoke else 48
    feeds = [{"x": rng.rand(32, 64).astype(np.float32),
              "y": rng.randint(0, 8, (32, 1))} for _ in range(n)]

    def measure(cfg: dict):
        outs = list(exe.run_pipelined(
            iter(feeds), main, fetch_list=[loss], scope=scope,
            is_test=True, steps_per_dispatch=cfg["steps_per_dispatch"],
            prefetch_depth=cfg["prefetch_depth"]))
        # numpy fetches are the completion barrier
        assert len(outs) == n
    return measure


def _target_reader_prefetch(smoke: bool) -> Callable[[dict], None]:
    """Reader-engine worker and buffer sizing on real decode work (string
    parsing, the CTR recipe's shape) with a consumer that also costs host
    time: the overlap the workers exist to buy."""
    rng = np.random.RandomState(0)
    n = 128 if smoke else 2048
    lines = ["%d," % rng.randint(0, 2)
             + " ".join("%d" % v for v in rng.randint(0, 65536, 13))
             for _ in range(n)]

    def decode(line):
        lab, _, dense_s = line.partition(",")
        return np.array([np.log1p(float(t)) for t in dense_s.split()],
                        np.float32), np.float32(int(lab))

    def reader():
        return iter(lines)

    sink = np.zeros(13, np.float32)

    def measure(cfg: dict):
        from ..reader.pipeline import prefetch
        src = prefetch(reader, buffer_size=cfg["buffer_size"],
                       num_workers=cfg["num_workers"], mapper=decode)
        acc = sink.copy()
        for dense, _lab in src():
            acc += dense            # the consumer's host work
        assert acc.shape == (13,)
    return measure


def _target_serving_batcher(smoke: bool) -> Callable[[dict], None]:
    """The batcher's coalescing policy under closed-loop concurrent load
    on a live-program model: max_batch / max_wait_ms trade a dispatch's
    amortization against waiting for the batch to fill."""
    from ..core import Executor, Scope
    from ..serving.model import Model

    main, startup, pred, _ = _mlp(32, 32, 4, loss=False)
    scope = Scope()
    exe = Executor(_place())
    exe.run(startup, feed={}, fetch_list=[], scope=scope)
    model = Model.from_program(
        exe, main, fetch_list=[pred], scope=scope, name="tune-mlp",
        example={"x": np.zeros(32, np.float32)})

    rng = np.random.RandomState(0)
    n_requests = 24 if smoke else 240
    clients = 4 if smoke else 8
    examples = [{"x": rng.rand(32).astype(np.float32)} for _ in range(16)]

    def measure(cfg: dict):
        from ..serving.server import Server
        srv = Server(max_batch=cfg["max_batch"],
                     max_wait_ms=cfg["max_wait_ms"],
                     deadline_ms=None, queue_capacity=None, warmup=True)
        srv.add_model(model)
        srv.start()
        per_client = n_requests // clients
        try:
            _clients(clients, "client", lambda ci: [
                srv.infer(examples[(ci + i) % len(examples)], timeout=60.0)
                for i in range(per_client)])
        finally:
            srv.shutdown(drain=True, timeout=30.0)
    return measure


def _sparse_fixture(smoke: bool):
    """A one-table sparse program, a zipf feed list, an executor and a
    session factory (a fresh session a config, so a knob takes effect;
    the table persists, so only the first config pays cold-row init)."""
    from .. import core, layers, optimizer
    from ..core import Executor, Scope
    from ..sparse import SparseSession, SparseTable

    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        ids = layers.data("ids", shape=[1], dtype="int64")
        label = layers.data("label", shape=[1], dtype="float32")
        emb = layers.embedding(ids, size=[20_000, 16], sparse=True,
                               name="tune_tbl")
        fc = layers.fc(emb, size=16, act="relu")
        loss = layers.mean(layers.square(layers.fc(fc, size=1) - label))
        optimizer.SGD(learning_rate=0.05).minimize(loss)
    table = SparseTable("tune_tbl", 20_000, 16, num_shards=4, seed=1,
                        learning_rate=0.05)

    rng = np.random.RandomState(0)
    B = 64 if smoke else 256
    n = 6 if smoke else 32
    draws = rng.zipf(1.3, size=(n, B, 1)).astype(np.int64)
    feeds = [{"ids": (draws[i] - 1) % 20_000,
              "label": rng.rand(B, 1).astype(np.float32)}
             for i in range(n)]
    scope = Scope()
    exe = Executor(_place())
    exe.run(startup, feed={}, fetch_list=[], scope=scope)

    def make_session(**kw):
        s = SparseSession(table, bucket_floor=B, **kw)
        s.bind(main)
        return s
    return main, loss, exe, scope, feeds, make_session


def _target_sparse_hot_rows(smoke: bool) -> Callable[[dict], None]:
    """Hot-rows LRU capacity on read-only zipf traffic: the cache-first
    pull loop the capacity bounds."""
    _, _, _, _, feeds, make_session = _sparse_fixture(smoke)

    def measure(cfg: dict):
        sess = make_session(cache_rows=cfg["cache_rows"])
        for f in feeds:
            sess.prepare_feed(f, is_test=True)
    return measure


def _target_sparse_prefetch(smoke: bool) -> Callable[[dict], None]:
    """Pull-ahead depth on a real training loop (pull, step, push): the
    overlap pays only when the host has parallelism to spare, which the
    paired gate decides."""
    main, loss, exe, scope, feeds, make_session = _sparse_fixture(smoke)

    def measure(cfg: dict):
        sess = make_session(prefetch_depth=cfg["depth"])
        fetch = [loss] + sess.grad_fetch_list
        feed_it = sess.prefetch_feeds(iter(feeds))
        try:
            for feed in feed_it:
                out = exe.run(main, feed=feed, fetch_list=fetch,
                              scope=scope)
                sess.complete(out[1:])
        finally:
            feed_it.close()
        sess.flush()
    return measure


def _target_sparse_push_flush(smoke: bool) -> Callable[[dict], None]:
    """Async-push drain size on a push-only loop (prepare and complete,
    no step): the worker wake-up and lock amortization the knob is
    for."""
    _, _, _, _, feeds, make_session = _sparse_fixture(smoke)
    rng = np.random.RandomState(1)
    grads = {}

    def measure(cfg: dict):
        sess = make_session(async_push=8, push_flush_batch=cfg["batch"])
        for f in feeds:
            prepared = sess.prepare_feed(f)
            shape = prepared["tune_tbl@ROWS"].shape
            if shape not in grads:
                grads[shape] = rng.randn(*shape).astype(np.float32)
            sess.complete([grads[shape]])
        sess.flush()
    return measure


def _target_decode_slots(smoke: bool) -> Callable[[dict], None]:
    """Decode slot-pool sizing under closed-loop generate load: slots is
    the captured decode batch (a step's amortization against padded rows
    at partial occupancy), step_wait_ms the idle pool's poll."""
    from ..serving.decode import DecodeEngine, DecodeRuntime

    V = 64
    rng = np.random.RandomState(0)
    n_requests = 8 if smoke else 64
    clients = 2 if smoke else 4
    prompts = [[int(t) for t in rng.randint(1, V, rng.randint(3, 9))]
               for _ in range(16)]
    max_news = [int(rng.randint(4, 17)) for _ in range(16)]
    place = _place()
    # one engine a slot count, built and warmed at first use, so no
    # timed window pays a build or a capture
    engines: Dict[int, DecodeEngine] = {}

    def measure(cfg: dict):
        s = int(cfg["slots"])
        if s not in engines:
            engines[s] = DecodeEngine(
                vocab_size=V, hidden_dim=32, n_layers=1, slots=s,
                max_len=32, seed=0, name=f"tune-dec{s}", place=place)
            rt0 = DecodeRuntime(engines[s], step_wait_ms=1.0)
            rt0.start(warmup=True)
            rt0.shutdown()
        rt = DecodeRuntime(engines[s], step_wait_ms=cfg["step_wait_ms"])
        rt.start(warmup=False)
        per_client = n_requests // clients

        def work(ci):
            for i in range(per_client):
                j = (ci * per_client + i) % len(prompts)
                rt.submit(prompts[j], max_news[j]).result(60.0)
        try:
            _clients(clients, "dec", work)
        finally:
            rt.shutdown(drain=True, timeout=30.0)
    return measure


# ---------------------------------------------------------------------------
# Device-side targets (searched on the card; the pending-hardware stub
# where no card is present)
# ---------------------------------------------------------------------------
#: ResNet-50's stage-2 wgrad: dw[M, C] = gout[P, M]^T x[P, C], K = P =
#: 128 * 28 * 28 (the JAX target's shape, tuning/targets.py:379)
CONV_WGRAD = (100352, 512, 128)
CONV_SMOKE = (2048, 256, 128)


def _target_conv1x1_plan(smoke: bool, shape=None, dtype=torch.bfloat16,
                         steps=None) -> Callable[[dict], None]:
    """K1's wgrad at one (P, C, M) (default ResNet-50's stage-2 wgrad)
    under a ``cuda/conv1x1_plan`` config: ``steps`` launches a window.
    A config ``conv1x1.check_launch`` refuses raises in ``conv1x1.mm``
    before it launches (a failed trial).  ``measure.operands`` are (gout, x), for
    the caller's check against ``mm_reference``."""
    from ..ops import conv1x1

    P, C, M = shape or (CONV_SMOKE if smoke else CONV_WGRAD)
    dev = "cuda" if _on_card() else "cpu"
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(P, C, generator=g, device=dev).to(dtype)
    gout = torch.randn(P, M, generator=g, device=dev).to(dtype)
    steps = steps or (2 if smoke else 10)

    def measure(cfg: dict):
        for _ in range(steps):
            conv1x1.mm(gout, x, True, False, config=cfg)
        _sync()
        measure.windows += 1
    measure.windows = 0
    measure.steps = steps
    measure.operands = (gout, x)
    # the record's context: the form and (M, N, K, dtype)
    measure.context = f"wgrad M={M} N={C} K={P} {str(dtype)[6:]}"
    return measure


def _target_flash_attention(smoke: bool, T=None, heads: int = 8,
                            dim: int = 64,
                            steps: int = 1) -> Callable[[dict], None]:
    """K2, then K3 and K4, at ``heads`` x ``T`` x ``dim`` causal bf16
    (default 8 x 32768 x 64, the longctx sweep's point) under a
    ``cuda/flash_attention`` config: ``steps`` forwards and backwards a
    window (default one).  ``measure.operands`` are (q, k, v, g)."""
    from ..ops import flash_attention as fa

    T = T or (256 if smoke else 32768)
    dev = "cuda" if _on_card() else "cpu"
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(heads, T, dim, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))

    def measure(cfg: dict):
        for _ in range(steps):
            out, lse = fa.flash_fwd(q, k, v, True, stages=cfg["fwd_stages"])
            fa.flash_bwd(q, k, v, out, lse, g, True,
                         stages=cfg["bwd_stages"])
        _sync()
        measure.windows += 1
    measure.windows = 0
    measure.steps = steps
    measure.operands = (q, k, v, g)
    # no context: layers.flash_attention replays the record at any shape
    return measure


TARGETS: Dict[str, Callable[..., Callable[[dict], None]]] = {
    "executor/run_pipelined": _target_run_pipelined,
    "reader/prefetch": _target_reader_prefetch,
    "serving/batcher": _target_serving_batcher,
    "serving/decode_slots": _target_decode_slots,
    "sparse/hot_rows": _target_sparse_hot_rows,
    "sparse/prefetch": _target_sparse_prefetch,
    "sparse/push_flush": _target_sparse_push_flush,
    "cuda/conv1x1_plan": _target_conv1x1_plan,
    "cuda/flash_attention": _target_flash_attention,
}

#: tunable -> the module whose import declares it (subsystems the
#: package import does not load)
_REGISTERING_MODULE = {
    "serving/batcher": "paddle_tpu_torch.serving.server",
    "serving/decode_slots": "paddle_tpu_torch.serving.decode",
    "sparse/hot_rows": "paddle_tpu_torch.sparse.session",
    "sparse/prefetch": "paddle_tpu_torch.sparse.session",
    "sparse/push_flush": "paddle_tpu_torch.sparse.session",
}


def ensure_registered(name: str):
    """Import the subsystem that declares ``name`` (a no-op for the
    tunables the package import declares)."""
    mod = _REGISTERING_MODULE.get(name)
    if mod is not None:
        import importlib
        importlib.import_module(mod)


def target_names():
    return sorted(TARGETS)


def build_target(name: str, smoke: bool = False,
                 **options) -> Callable[[dict], None]:
    """The measurement closure of a built-in target (importing whatever
    subsystem declares the tunable); ``options`` go to the device
    targets' builders (``shape``/``dtype``/``steps``, ``T``)."""
    try:
        builder = TARGETS[name]
    except KeyError:
        raise KeyError(f"no built-in tune target for {name!r}; "
                       f"available: {target_names()}") from None
    ensure_registered(name)
    t0 = time.perf_counter()
    measure = builder(smoke, **options)
    measure.build_seconds = round(time.perf_counter() - t0, 3)
    return measure
