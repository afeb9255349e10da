"""Length-prefixed wire protocol of the CATE serving daemon.

Port of ``ate_replication_causalml_tpu/serving/protocol.py``, byte for
byte: the same frames, so the JAX package's client, its load generator
and its router drive the port's daemon unchanged, and the port's client
drives the JAX package's. One frame carries one JSON header plus zero or
more raw array buffers::

    [total_len u32][header_len u32][header JSON][array payload bytes]

All length prefixes are big-endian u32; ``total_len`` counts everything
after itself. Arrays travel as contiguous raw buffers after the header,
in the order of the header's ``arrays`` entry (``{name: {"dtype": ...,
"shape": [...]}}``); no pickle, so a peer in any language with JSON and
``struct`` can speak it.

A reader that hits EOF *inside* a frame gets :class:`ProtocolError`
naming how much arrived (the artifact a killed peer leaves); EOF
*between* frames is a clean close (:func:`read_frame` returns None).
Length fields are validated before any allocation. The module itself
uses numpy only.
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np

#: Refuse frames beyond this before allocating (a corrupt/hostile
#: length prefix must not look like a 4 GB allocation request). 256 MB
#: comfortably covers the largest declared batch bucket at serving
#: dtypes.
MAX_FRAME_BYTES = 256 << 20

_U32 = struct.Struct("!I")


class ProtocolError(ValueError):
    """Malformed or torn frame. A ValueError — framing bugs and torn
    streams are terminal for the connection, never retried blindly."""


def encode_frame(
    header: dict, arrays: dict[str, np.ndarray] | None = None
) -> bytes:
    """Serialize ``header`` (+ named arrays) into one wire frame."""
    meta: dict[str, dict] = {}
    payload: list[bytes] = []
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        meta[name] = {"dtype": str(a.dtype), "shape": list(a.shape)}
        payload.append(a.tobytes())
    hdr = dict(header)
    if meta:
        hdr["arrays"] = meta
    hb = json.dumps(hdr, separators=(",", ":")).encode()
    body = _U32.pack(len(hb)) + hb + b"".join(payload)
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {len(body)} bytes exceeds MAX_FRAME_BYTES"
        )
    return _U32.pack(len(body)) + body


def decode_frame(body: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    """Parse a frame body (everything after the ``total_len`` prefix)
    back into ``(header, arrays)``. Every declared array must be fully
    present and the frame fully consumed — trailing or missing bytes
    are a :class:`ProtocolError`, never a silent partial decode."""
    if len(body) < _U32.size:
        raise ProtocolError("frame shorter than its header-length field")
    (hlen,) = _U32.unpack_from(body)
    off = _U32.size + hlen
    if off > len(body):
        raise ProtocolError(
            f"header length {hlen} exceeds frame body of {len(body)} bytes"
        )
    try:
        header = json.loads(body[_U32.size:off].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"frame header is not valid JSON ({e})") from e
    if not isinstance(header, dict):
        raise ProtocolError("frame header is not a JSON object")
    arrays: dict[str, np.ndarray] = {}
    for name, m in (header.pop("arrays", None) or {}).items():
        try:
            dt = np.dtype(m["dtype"])
            shape = tuple(int(s) for s in m["shape"])
        except (TypeError, KeyError, ValueError) as e:
            raise ProtocolError(
                f"array {name!r} has malformed metadata {m!r}"
            ) from e
        if dt.kind not in "biufc":
            # Object/str/datetime dtypes have no raw-buffer wire form
            # (np.frombuffer on dtype "O" raises a PLAIN ValueError that
            # would escape the protocol layer and kill the connection
            # thread replyless).
            raise ProtocolError(
                f"array {name!r} has non-numeric dtype {dt!r}"
            )
        if any(s < 0 for s in shape):
            raise ProtocolError(f"array {name!r} has negative dims {shape}")
        nbytes = dt.itemsize * math.prod(shape)
        if off + nbytes > len(body):
            raise ProtocolError(
                f"array {name!r} truncated: needs {nbytes} bytes, "
                f"{len(body) - off} left in frame"
            )
        try:
            arrays[name] = (
                np.frombuffer(body[off:off + nbytes], dtype=dt)
                .reshape(shape)
                .copy()  # own the memory; the frame buffer is transient
            )
        except ValueError as e:
            raise ProtocolError(
                f"array {name!r} does not decode as {dt!r}{shape} ({e})"
            ) from e
        off += nbytes
    if off != len(body):
        raise ProtocolError(
            f"{len(body) - off} trailing bytes after declared arrays"
        )
    return header, arrays


def _read_exact(stream, n: int, *, allow_eof: bool = False) -> bytes | None:
    """Read exactly ``n`` bytes. EOF before the first byte returns None
    when ``allow_eof`` (a clean close between frames); EOF mid-read is
    always a torn frame."""
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            if allow_eof and not buf:
                return None
            raise ProtocolError(
                f"torn frame: EOF after {len(buf)}/{n} bytes"
            )
        buf += chunk
    return buf


def read_frame(stream) -> tuple[dict, dict[str, np.ndarray]] | None:
    """Read one frame from a binary stream (``.read(n)``), or None on a
    clean EOF at a frame boundary."""
    head = _read_exact(stream, _U32.size, allow_eof=True)
    if head is None:
        return None
    (total,) = _U32.unpack(head)
    if total > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"declared frame of {total} bytes exceeds MAX_FRAME_BYTES"
        )
    if total < _U32.size:
        raise ProtocolError(f"declared frame of {total} bytes is too short")
    return decode_frame(_read_exact(stream, total))


def write_frame(
    stream, header: dict, arrays: dict[str, np.ndarray] | None = None
) -> None:
    stream.write(encode_frame(header, arrays))
    stream.flush()
