"""HTTP/1.1 serving front: the network rim over the in-process serving
runtime (or a fleet router — anything with the ``submit``/``health``
surface).  Counterpart of ``paddle_tpu/serving/http.py``: the same
routes, status matrix, headers and wire schema.

The stdio protocol (``serving/cli.py``) is the process form; this module
is the "web service in front of the C inference API" half of the
reference's deployment story, built on stdlib ``http.server`` /
``socketserver`` only — no new dependencies.  One POST body carries one
or more newline-delimited JSON requests (the exact stdio line schema),
and replies stream back as newline-delimited JSON in completion order:

  POST /v1/infer                  body: {"id", "model"?, "feeds",
                                         "deadline_ms"?}  (1+ lines)
  GET  /healthz                   backend health() JSON (200 ready / 503)
  GET  /metrics                   Prometheus text exposition

**Deadline propagation** — the ``X-Paddle-Deadline-Ms`` request header
becomes the per-request deadline for every body line that does not carry
its own ``deadline_ms``; it flows into the server's deadline machinery
and expires at its two rims (batch formation and dispatch).  A request
that expires maps to 504.

**Typed rejections → status codes** (single-request bodies; multi-line
bodies stream per-line error objects under a 200):

  ============================  ======  =====================
  Overloaded                     429    Retry-After: 1
  DeadlineExceeded               504
  ModelUnavailable               503    Retry-After: cooldown
  ServerClosed                   503    Connection: close
  ModelError                     500
  BadRequest (parse/feeds)       400
  auth (missing/unknown token)   401/403
  ============================  ======  =====================

**Per-tenant auth → model routing** — an optional ``tokens`` map
(``{token: model_name-or-None}``) gates admission: requests authenticate
with ``Authorization: Bearer <token>`` (or ``X-Paddle-Token``); a token
bound to a model routes every line to that model and 403s an explicit
mismatch, a ``None`` binding admits any tenant.

ZERO COST WHEN UNUSED: nothing in ``paddle_tpu_torch`` — including
``paddle_tpu_torch.serving`` itself — imports this module at top level
(``tests/test_torch_imports.py`` enforces it); only the CLI's ``--http``
/ ``fleet`` branches and an explicit ``from
paddle_tpu_torch.serving.http import HttpFront`` pay for it.
"""
from __future__ import annotations

import json
import logging
import queue as _queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from .. import faults as _faults
from .. import observability as obs

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["HttpFront", "DEADLINE_HEADER", "TOKEN_HEADER", "status_for"]

DEADLINE_HEADER = "X-Paddle-Deadline-Ms"
TOKEN_HEADER = "X-Paddle-Token"


def status_for(exc: BaseException) -> int:
    """Map a typed serving rejection to its HTTP status."""
    if isinstance(exc, _faults.Overloaded):
        return 429
    if isinstance(exc, _faults.DeadlineExceeded):
        return 504
    if isinstance(exc, (_faults.ModelUnavailable, _faults.ServerClosed)):
        return 503
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return 400                  # unknown model / malformed feeds
    return 500                      # ModelError and anything else


def _error_obj(req_id, exc: BaseException) -> dict:
    return {"id": req_id, "error": type(exc).__name__, "message": str(exc)}


def _response_obj(pending) -> dict:
    """Wire form of one completed request (same schema as the stdio
    protocol's response lines)."""
    if pending.error is not None:
        return _error_obj(pending.id, pending.error)
    # outputs are numpy rows from an in-process Server, but already
    # nested lists when the backend is a fleet router over process
    # replicas (they arrived as wire JSON)
    return {"id": pending.id, "model": pending.model,
            "outputs": [o.tolist() if hasattr(o, "tolist") else o
                        for o in pending.outputs],
            "ms": round((time.monotonic() - pending.t_admit) * 1e3, 3),
            "dispatch_ms": None if pending.dispatch_ms is None
            else round(pending.dispatch_ms, 3)}


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: keep-alive + chunked transfer encoding for streamed
    # multi-request replies
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------
    def log_message(self, fmt, *args):          # quiet by default
        logger.debug("http: %s", fmt % args)

    @property
    def front(self) -> "HttpFront":
        return self.server.front                # type: ignore[attr-defined]

    def _send_json(self, status: int, obj: dict, *,
                   headers: Optional[Dict[str, str]] = None,
                   close: bool = False):
        body = (json.dumps(obj, default=repr) + "\n").encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if close:
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _reject(self, status: int, exc_or_msg, req_id=None, *,
                headers=None, close=False, auth=False):
        obs.inc_counter("http/rejected")
        if auth:
            obs.inc_counter("http/auth_failures")
        if isinstance(exc_or_msg, BaseException):
            obj = _error_obj(req_id, exc_or_msg)
        else:
            obj = {"id": req_id, "error": "BadRequest",
                   "message": str(exc_or_msg)}
        self._send_json(status, obj, headers=headers, close=close)
        return status

    # -- GET -----------------------------------------------------------------
    def do_GET(self):
        # W3C traceparent: a valid header parents this request's span
        # onto the edge caller's trace; absent/garbage degrades to a
        # fresh per-request trace (garbage is counted, never fatal)
        parent = obs.tracing.extract_traceparent(
            self.headers.get("traceparent")) or obs.tracing.ROOT
        sp = obs.tracing.start_span("http/request", parent=parent,
                                    method="GET", path=self.path)
        t0 = time.monotonic()
        try:
            status = self._get()
        except BrokenPipeError:                  # client went away
            sp.cancel()
            return
        except Exception as e:                   # noqa: BLE001 — contained
            logger.exception("http: GET %s failed", self.path)
            try:
                status = self._reject(500, e)
            except BrokenPipeError:
                sp.cancel()
                return
        obs.observe_hist("http/request_ms", (time.monotonic() - t0) * 1e3)
        sp.end(status=status)

    def _get(self) -> int:
        if self.path in ("/healthz", "/health"):
            h = self.front.backend.health()
            status = 200 if h.get("ready") else 503
            self._send_json(status, h)
            return status
        if self.path == "/metrics":
            text = obs.to_prometheus(obs.metrics_snapshot())
            body = text.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return 200
        return self._reject(404, f"no such path {self.path!r} "
                            f"(have /v1/infer, /healthz, /metrics)")

    # -- POST /v1/infer ------------------------------------------------------
    def do_POST(self):
        obs.inc_counter("http/requests")
        parent = obs.tracing.extract_traceparent(
            self.headers.get("traceparent")) or obs.tracing.ROOT
        sp = obs.tracing.start_span("http/request", parent=parent,
                                    method="POST", path=self.path)
        t0 = time.monotonic()
        try:
            status = self._post()
        except BrokenPipeError:
            sp.cancel()
            return
        except Exception as e:                   # noqa: BLE001 — contained
            logger.exception("http: POST %s failed", self.path)
            try:
                status = self._reject(500, e)
            except BrokenPipeError:
                sp.cancel()
                return
        obs.observe_hist("http/request_ms", (time.monotonic() - t0) * 1e3)
        sp.end(status=status)

    def _auth(self):
        """(model_bound_by_token, error_status_or_None).  With no token
        table the front is open (None binding)."""
        tokens = self.front.tokens
        if tokens is None:
            return None, None
        tok = self.headers.get(TOKEN_HEADER)
        if tok is None:
            bearer = self.headers.get("Authorization", "")
            if bearer.startswith("Bearer "):
                tok = bearer[len("Bearer "):].strip()
        if tok is None:
            return None, self._reject(
                401, "missing auth token (Authorization: Bearer <token> "
                     f"or {TOKEN_HEADER})", auth=True,
                headers={"WWW-Authenticate": "Bearer"})
        if tok not in tokens:
            return None, self._reject(401, "unknown auth token", auth=True,
                                      headers={"WWW-Authenticate": "Bearer"})
        return tokens[tok], None

    def _post(self) -> int:
        if self.path not in ("/v1/infer", "/infer"):
            return self._reject(404, f"no such path {self.path!r} "
                                f"(POST /v1/infer)")
        token_model, err = self._auth()
        if err is not None:
            return err
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            return self._reject(411, "bad Content-Length")
        if length <= 0:
            return self._reject(411, "Content-Length required")
        raw = self.rfile.read(length).decode("utf-8", errors="replace")
        lines = [ln for ln in raw.splitlines() if ln.strip()]
        if not lines:
            return self._reject(400, "empty body: want newline-delimited "
                                "JSON request objects")
        # the client timeout header is the default deadline for every
        # line that doesn't set its own deadline_ms
        hdr_deadline: Optional[float] = -1.0
        hdr_raw = self.headers.get(DEADLINE_HEADER)
        if hdr_raw is not None:
            try:
                hdr_deadline = float(hdr_raw)
                if hdr_deadline <= 0:
                    hdr_deadline = None        # explicit "no deadline"
            except ValueError:
                return self._reject(
                    400, f"bad {DEADLINE_HEADER}: {hdr_raw!r}")
        if len(lines) == 1:
            return self._post_single(lines[0], token_model, hdr_deadline)
        return self._post_stream(lines, token_model, hdr_deadline)

    def _submit_line(self, line: str, token_model, hdr_deadline):
        """Parse + submit one body line.  Returns (pending, None) on
        admission, (None, (exc, req_id)) on any typed rejection."""
        try:
            msg = json.loads(line)
            if not isinstance(msg, dict) or "feeds" not in msg:
                raise ValueError("want {'id', 'feeds': {...}}")
        except (json.JSONDecodeError, ValueError) as e:
            return None, (ValueError(str(e)), None)
        req_id = msg.get("id")
        model = msg.get("model")
        if token_model is not None:
            if model is not None and model != token_model:
                exc = PermissionError(
                    f"token is bound to model {token_model!r}, "
                    f"not {model!r}")
                return None, (exc, req_id)
            model = token_model
        deadline_ms = msg.get("deadline_ms", hdr_deadline)
        try:
            pending = self.front.backend.submit(
                msg["feeds"], model=model, deadline_ms=deadline_ms,
                req_id=req_id)
        except BaseException as e:     # typed rejection / bad feeds
            return None, (e, req_id)
        return pending, None

    def _post_single(self, line: str, token_model, hdr_deadline) -> int:
        pending, rejected = self._submit_line(line, token_model,
                                              hdr_deadline)
        if rejected is not None:
            exc, req_id = rejected
            if isinstance(exc, PermissionError):
                return self._reject(403, exc, req_id, auth=True)
            return self._finish_error(exc, req_id)
        try:
            pending.result(timeout=self.front.result_timeout_s)
        except TimeoutError as e:
            return self._finish_error(_faults.DeadlineExceeded(str(e)),
                                      pending.id)
        except BaseException as e:     # the request's typed terminal error
            return self._finish_error(e, pending.id)
        self._send_json(200, _response_obj(pending))
        return 200

    def _finish_error(self, exc: BaseException, req_id) -> int:
        status = status_for(exc)
        headers = {}
        close = False
        if isinstance(exc, _faults.Overloaded):
            headers["Retry-After"] = "1"
        elif isinstance(exc, _faults.ModelUnavailable):
            headers["Retry-After"] = "5"
        elif isinstance(exc, _faults.ServerClosed):
            # this replica is going away: the client must reconnect
            # (through its balancer) instead of reusing the connection
            close = True
        return self._reject(status, exc, req_id, headers=headers,
                            close=close)

    def _post_stream(self, lines, token_model, hdr_deadline) -> int:
        """N>1 request lines: stream newline-JSON responses back in
        completion order under a 200 with chunked transfer encoding —
        per-line failures ride as error objects, they don't fail the
        stream."""
        done: _queue_mod.Queue = _queue_mod.Queue()
        expected = 0
        for line in lines:
            pending, rejected = self._submit_line(line, token_model,
                                                  hdr_deadline)
            expected += 1
            if rejected is not None:
                exc, req_id = rejected
                obs.inc_counter("http/rejected")
                if isinstance(exc, PermissionError):
                    # same accounting as the single-line 403 path
                    obs.inc_counter("http/auth_failures")
                done.put(_error_obj(req_id, exc))
            else:
                pending.add_done_callback(
                    lambda p: done.put(_response_obj(p)))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        deadline = time.monotonic() + self.front.result_timeout_s
        for _ in range(expected):
            remaining = deadline - time.monotonic()
            try:
                obj = done.get(timeout=max(0.0, remaining))
            except _queue_mod.Empty:
                obj = {"id": None, "error": "DeadlineExceeded",
                       "message": "response stream timed out"}
            self._write_chunk(json.dumps(obj, default=repr) + "\n")
        self.wfile.write(b"0\r\n\r\n")
        return 200

    def _write_chunk(self, text: str):
        data = text.encode("utf-8")
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()


class _FrontServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class HttpFront:
    """HTTP front over any backend with the server surface
    (``submit(feeds, model=, deadline_ms=, req_id=)`` returning a
    :class:`~paddle_tpu_torch.serving.server.PendingResponse`-shaped
    handle, plus ``health()``) — an in-process
    :class:`~paddle_tpu_torch.serving.server.Server` or a
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`.

    ::

        front = HttpFront(server, port=8000).start()
        ...                       # serve
        front.stop()              # close the socket (backend untouched)

    ``tokens``: optional ``{token: model-or-None}`` auth table;
    ``result_timeout_s`` bounds how long one HTTP exchange may wait on
    a response (deadline-less requests against a wedged backend).
    """

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 tokens: Optional[Dict[str, Optional[str]]] = None,
                 result_timeout_s: float = 120.0):
        self.backend = backend
        self.tokens = dict(tokens) if tokens is not None else None
        self.result_timeout_s = float(result_timeout_s)
        self._httpd = _FrontServer((host, int(port)), _Handler)
        self._httpd.front = self            # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """(host, port) actually bound — port 0 resolves at bind."""
        return self._httpd.server_address[:2]

    def start(self) -> "HttpFront":
        if self._thread is not None:
            raise RuntimeError("HttpFront.start: already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="pt-http-front", daemon=True)
        self._thread.start()
        host, port = self.address
        obs.emit_event("serving", event="http_front", host=host, port=port)
        logger.info("serving: HTTP front listening on %s:%d", host, port)
        return self

    def stop(self):
        """Stop accepting connections and close the socket.  The backend
        (server/router) is the caller's to drain."""
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=10)
        self._httpd.server_close()
        self._thread = None

    def serve_until(self, stop_event: threading.Event,
                    poll_s: float = 0.1):
        """Convenience for CLI mains: start (if needed), then block until
        ``stop_event`` is set."""
        if self._thread is None:
            self.start()
        while not stop_event.wait(poll_s):
            pass
