"""Binary wire framing for the sparse parameter-server tier
(counterpart of ``paddle_tpu/sparse/wire.py``, a copy of it: the frames
are the JAX package's byte for byte, so either package's client talks to
either package's shard server).

The reference's pserver spoke a hand-rolled binary RPC (ProtoServer /
LightNetwork).  At CTR batch sizes the wire hot path is marshalling,
not the table, so the protocol is **one frame per batched request**,
never per row, and the payload is the raw little-endian numpy buffers
scatter-gathered straight out of the arrays (``memoryview`` +
``socket.sendmsg``: zero copies on the send side).

Frame layout (all integers little-endian)::

    offset 0   magic      b"PTPS"                      (4 bytes)
    offset 4   version    u16  (WIRE_VERSION)          (2 bytes)
    offset 6   header_len u32                          (4 bytes)
    offset 10  payload_len u64                         (8 bytes)
    offset 18  header     compact JSON (header_len bytes)
    ...        payload    raw LE numpy buffers, concatenated

The header carries the control fields (op/table/seq/...) plus a
``bufs`` list of ``[dtype_str, shape]`` descriptors, one per payload
array, so the receiver can split the payload without copies
(``np.frombuffer`` over one contiguous read).  ``dtype_str`` is the
numpy descriptor (``"<f4"``, ``"<i8"``, ...); big-endian descriptors
are rejected.

Failure typing:

* peer death mid-frame (EOF before the declared bytes arrive) raises
  :class:`WireTruncatedError`, a ``ConnectionError`` subtype, so
  ``faults.classify`` calls it retryable and the client's
  retry/reconnect rim handles it;
* garbage where a frame boundary should be (bad magic, undecodable
  header, descriptor/payload length disagreement, an insane declared
  length) raises :class:`WireProtocolError`: fatal, since retrying a
  desynchronized stream reproduces it;
* a peer speaking a different frame version raises
  :class:`WireVersionError` (checked before anything else in the frame
  is trusted).

The deliberately naive **per-row control arm** lives here too:
:func:`write_frame_json` encodes the arrays as JSON lists inside the
header and the naive client sends one such frame per row.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "WIRE_VERSION", "MAGIC", "WireError", "WireProtocolError",
    "WireVersionError", "WireTruncatedError", "write_frame",
    "write_frame_json", "read_frame",
]

MAGIC = b"PTPS"
WIRE_VERSION = 1
_PREAMBLE = struct.Struct("<4sHIQ")      # magic, version, header_len, payload_len

# Sanity caps, sized to the largest plausible single frame on this
# tier (a whole-shard export), not "anything addressable".  Module
# knobs: a deployment hosting bigger shards can raise them on both
# ends.  Declared lengths past a cap are a protocol error before any
# receive happens; below it, _recv_exact still grows its buffer
# chunk-wise, so memory tracks the bytes the peer actually sent — a
# torn or hostile preamble alone can never force a large allocation.
MAX_HEADER_BYTES = 1 << 24               # 16 MiB of JSON header
MAX_PAYLOAD_BYTES = 1 << 30              # 1 GiB of row payload


class WireError(RuntimeError):
    """Base for sparse-wire protocol failures."""


class WireProtocolError(WireError):
    """The byte stream is not a valid frame (torn header, descriptor/
    length disagreement, insane declared size).  Fatal: the stream is
    desynchronized and retrying reproduces it."""


class WireVersionError(WireProtocolError):
    """The peer speaks a different frame version.  Fatal by design —
    silently decoding a future layout would corrupt rows."""


class WireTruncatedError(WireError, ConnectionError):
    """The peer died mid-frame (EOF before the declared bytes arrived).

    A ``ConnectionError`` subtype so ``faults.classify`` marks it
    retryable — the client rim reconnects and replays the request."""


def _as_wire_array(a) -> np.ndarray:
    """Contiguous little-endian view/copy of ``a`` ready to scatter."""
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def _sendmsg_all(sock, buffers: List[memoryview]) -> int:
    """Scatter-gather send of every buffer, handling partial sends."""
    bufs = [memoryview(b).cast("B") for b in buffers]
    total = 0
    while bufs:
        n = sock.sendmsg(bufs)
        total += n
        while n:
            if n >= len(bufs[0]):
                n -= len(bufs[0])
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][n:]
                n = 0
    return total


def write_frame(sock, header: Dict, arrays: Sequence[np.ndarray] = ()
                ) -> int:
    """Send ONE frame carrying ``header`` plus the raw buffers of
    ``arrays`` (batched: however many rows the arrays hold, this is a
    single frame and a single scatter-gather syscall path).  Returns
    the bytes written."""
    arrays = [_as_wire_array(a) for a in arrays]
    header = dict(header)
    header["bufs"] = [[a.dtype.str, list(a.shape)] for a in arrays]
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    payload_len = sum(a.nbytes for a in arrays)
    pre = _PREAMBLE.pack(MAGIC, WIRE_VERSION, len(hdr), payload_len)
    bufs = [memoryview(pre + hdr)]
    bufs += [memoryview(a).cast("B") for a in arrays if a.nbytes]
    return _sendmsg_all(sock, bufs)


def write_frame_json(sock, header: Dict, arrays: Sequence[np.ndarray] = ()
                     ) -> int:
    """The NAIVE control arm's encoding: arrays ride the header as JSON
    ``[dtype_name, shape, values]`` lists (every element boxed, parsed,
    and re-boxed — the pickle/JSON-RPC cost shape).  The naive client
    calls this once per ROW; it exists as the benchmark baseline and is
    never the served hot path."""
    header = dict(header)
    header["json_arrays"] = [
        [a2.dtype.name, list(a2.shape), a2.ravel().tolist()]
        for a2 in (np.ascontiguousarray(a) for a in arrays)]
    return write_frame(sock, header, ())


def decode_json_arrays(header: Dict) -> List[np.ndarray]:
    """Rebuild the arrays a :func:`write_frame_json` frame carries."""
    out = []
    for name, shape, values in header.get("json_arrays", ()):
        out.append(np.asarray(values, dtype=np.dtype(name)).reshape(shape))
    return out


_RECV_CHUNK = 1 << 20                    # grow receive buffers 1 MiB at a time


def _recv_exact(sock, n: int, what: str, *, eof_ok: bool = False
                ) -> Optional[memoryview]:
    """Receive exactly ``n`` bytes.  The buffer grows in
    ``_RECV_CHUNK`` steps as bytes arrive, never ``n`` up-front, so a
    declared length only costs memory once the peer actually sends the
    bytes."""
    buf = bytearray(min(n, _RECV_CHUNK))
    got = 0
    while got < n:
        if got == len(buf):
            buf += bytes(min(n - got, _RECV_CHUNK))
        view = memoryview(buf)[got:]
        try:
            r = sock.recv_into(view)
        finally:
            view.release()       # else the next resize would fail
        if r == 0:
            if got == 0 and eof_ok:
                return None      # clean close at a frame boundary
            raise WireTruncatedError(
                f"peer closed mid-{what}: got {got}/{n} bytes")
        got += r
    return memoryview(buf)


def read_frame(sock, *, eof_ok: bool = False
               ) -> Optional[Tuple[Dict, List[np.ndarray]]]:
    """Receive ONE frame: ``(header, arrays)``, or ``None`` on a clean
    EOF at a frame boundary when ``eof_ok`` (the server's idle-close
    path).  The received byte count is recorded in
    ``header["_wire_nbytes"]`` for the wire-bytes counters."""
    pre = _recv_exact(sock, _PREAMBLE.size, "frame preamble",
                      eof_ok=eof_ok)
    if pre is None:
        return None
    magic, version, header_len, payload_len = _PREAMBLE.unpack(pre)
    if magic != MAGIC:
        raise WireProtocolError(
            f"torn header: expected frame magic {MAGIC!r}, got "
            f"{bytes(magic)!r} — the stream is desynchronized")
    if version != WIRE_VERSION:
        raise WireVersionError(
            f"peer frame version {version} != this runtime's wire "
            f"version {WIRE_VERSION} — refusing to decode a different "
            f"layout")
    if header_len > MAX_HEADER_BYTES:
        raise WireProtocolError(
            f"declared header length {header_len} exceeds the "
            f"{MAX_HEADER_BYTES}-byte cap")
    if payload_len > MAX_PAYLOAD_BYTES:
        raise WireProtocolError(
            f"declared payload length {payload_len} exceeds the "
            f"{MAX_PAYLOAD_BYTES}-byte cap")
    hdr = _recv_exact(sock, header_len, "frame header")
    try:
        header = json.loads(bytes(hdr).decode("utf-8"))
        if not isinstance(header, dict):
            raise ValueError("frame header must be a JSON object")
        bufs = header.get("bufs", [])
        if not isinstance(bufs, list):
            raise ValueError("frame header 'bufs' must be a list")
    except (ValueError, UnicodeDecodeError) as e:
        raise WireProtocolError(f"undecodable frame header: {e}") from e
    payload = _recv_exact(sock, payload_len, "frame payload") \
        if payload_len else memoryview(b"")
    arrays, off = [], 0
    for desc in bufs:
        try:
            dtype_str, shape = desc
            dtype = np.dtype(str(dtype_str))
            shape = tuple(int(s) for s in shape)
        except (TypeError, ValueError) as e:
            raise WireProtocolError(
                f"bad payload descriptor {desc!r}: {e}") from e
        if dtype.byteorder == ">":
            raise WireProtocolError(
                f"payload descriptor {dtype_str!r} is big-endian — the "
                f"wire is little-endian by definition")
        count = 1
        for s in shape:
            count *= s
        nbytes = count * dtype.itemsize
        if off + nbytes > payload_len:
            raise WireProtocolError(
                f"payload descriptors declare more bytes than the "
                f"payload holds ({off + nbytes} > {payload_len})")
        arrays.append(np.frombuffer(payload, dtype=dtype, count=count,
                                    offset=off).reshape(shape))
        off += nbytes
    if off != payload_len:
        raise WireProtocolError(
            f"payload descriptors cover {off} of {payload_len} payload "
            f"bytes — descriptor/length disagreement")
    header["_wire_nbytes"] = _PREAMBLE.size + header_len + payload_len
    return header, arrays
