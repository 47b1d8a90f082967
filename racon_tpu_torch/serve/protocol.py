"""Newline-JSON wire helpers of the serve daemon and its client.

A copy of the JAX package's framing (racon_tpu/serve/protocol.py): one
JSON object per line in each direction.

* ``MAX_LINE`` bounds a single message (a line that long without a
  terminating newline is an oversized or garbage frame, not a request);
* ``read_message`` returns the parsed dict, ``None`` on a clean EOF, and
  raises ``ValueError`` on malformed JSON, a non-object payload, or an
  oversized frame — the caller decides whether that kills the
  connection (client) or just the request (server);
* ``write_message`` frames and flushes one object.

Only the stdlib and obs are imported; the helpers operate on any
buffered binary file object (``socket.makefile("rwb")``). Armed, each
receive and send is stamped as an ``rpc.recv`` / ``rpc.send`` span with
its byte size.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from .. import obs

#: Protocol guard: one message line must fit comfortably in memory.
MAX_LINE = 1 << 20


def read_message(f) -> Optional[dict]:
    """Read one newline-framed JSON object.  None = clean EOF.  The
    ``rpc.recv`` stamp covers the blocking read, so on a server
    connection it includes the wait for the next request."""
    t0 = time.monotonic_ns()
    line = f.readline(MAX_LINE)
    if not line:
        return None
    if len(line) >= MAX_LINE and not line.endswith(b"\n"):
        raise ValueError(f"message exceeds MAX_LINE ({MAX_LINE} bytes)")
    msg = json.loads(line)
    if not isinstance(msg, dict):
        raise ValueError("message must be a JSON object")
    obs.add_complete("rpc.recv", t0, time.monotonic_ns(), cat="rpc",
                     bytes=len(line), op=msg.get("op"))
    return msg


def write_message(f, msg: dict) -> None:
    """Frame and flush one object (the flush is the send)."""
    t0 = time.monotonic_ns()
    data = json.dumps(msg).encode() + b"\n"
    f.write(data)
    f.flush()
    obs.add_complete("rpc.send", t0, time.monotonic_ns(), cat="rpc",
                     bytes=len(data), op=msg.get("op"))
