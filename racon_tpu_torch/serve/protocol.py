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

``COMMON_RESP``, ``PROTOCOL`` and ``PAYLOADS`` declare the serve and
distrib wire protocol, field for field, for the contract auditor
(``python -m racon_tpu_torch.analysis --contracts``).
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


# ---------------------------------------------------------------------------
# Declared wire-protocol spec.
#
# The JAX package's declaration (racon_tpu/serve/protocol.py) with one
# port change, below. The static contract auditor
# (analysis/concurrency/contracts.py) extracts every producer's sent
# fields and every consumer's read fields from serve/server.py,
# serve/client.py, distrib/coordinator.py and distrib/worker.py and
# cross-checks them against these literals, so the four surfaces cannot
# drift apart silently. Keep the dicts pure literals: they are read by
# `ast.literal_eval`, not imported, when the tree is audited.
#
# Shapes: req = fields a request MUST carry; opt = fields it MAY carry;
# resp = fields an ok-response may carry beyond COMMON_RESP.
# ---------------------------------------------------------------------------

#: Fields every response may carry regardless of op: the ok flag and
#: the error envelope the server attaches on any failure path.
COMMON_RESP = ("ok", "error", "rejected")

PROTOCOL = {
    "serve": {
        "ping": {"req": (), "opt": (),
                 "resp": ("pid", "backend", "port")},
        "submit": {"req": ("sequences", "overlaps", "target"),
                   "opt": ("args", "include_unpolished", "backend",
                           "job_id", "submitter", "window_budget",
                           "priority", "trace"),
                   "resp": ("job_id", "lane", "demotions")},
        "status": {"req": ("job_id",), "opt": (),
                   "resp": ("job_id", "state", "lane", "submitter",
                            "demotions", "error", "queued_s",
                            "running_s")},
        "result": {"req": ("job_id",), "opt": ("wait", "timeout"),
                   "resp": ("job_id", "state", "lane", "submitter",
                            "demotions", "error", "queued_s",
                            "running_s", "result")},
        "cancel": {"req": ("job_id",), "opt": (),
                   "resp": ("job_id", "state", "lane", "submitter",
                            "demotions", "error", "queued_s",
                            "running_s")},
        "stats": {"req": (), "opt": (),
                  "resp": ("jobs", "queued", "queue_depth", "max_jobs",
                           "window_budget", "session", "telemetry",
                           "admission", "fleet")},
        "metrics": {"req": (), "opt": (), "resp": ("text", "slo")},
        "shutdown": {"req": (), "opt": (), "resp": ("bye",)},
    },
    "distrib": {
        # the port's change: a worker's hello may carry `start`, the
        # seconds its imports and its kernels' load took, which the
        # coordinator keeps a worker (Coordinator._hello) to say where a
        # fleet run's start-up goes; the JAX worker sends no such field
        "hello": {"req": ("worker",), "opt": ("start",),
                  "resp": ("lease_ttl", "heartbeat")},
        "fetch": {"req": ("worker",), "opt": (),
                  "resp": ("drain", "wait", "poll_s", "chunk")},
        "heartbeat": {"req": ("worker", "chunk", "attempt"), "opt": (),
                      "resp": ("cancel",)},
        "result": {"req": ("worker", "chunk", "attempt", "output"),
                   "opt": ("stats", "obs"), "resp": ("accepted",)},
        "error": {"req": ("worker", "chunk", "attempt"),
                  "opt": ("error",), "resp": ()},
        "stats": {"req": (), "opt": (),
                  "resp": ("chunks", "leases", "workers", "served",
                           "staleness_s", "counters", "telemetry")},
    },
}

#: Nested message payloads: "<surface>.<op>.<field>" -> the exact field
#: set of the nested object. The producer's literal must match this set
#: exactly; the consumer may only read declared fields.
PAYLOADS = {
    "distrib.fetch.chunk": ("index", "attempt", "sequences", "overlaps",
                            "target", "args", "include_unpolished",
                            "backend", "journal", "output", "trace"),
}
