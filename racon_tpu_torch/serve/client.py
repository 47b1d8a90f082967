"""Thin client for the serve daemon (newline-JSON over a localhost TCP
socket; protocol documented in server.py). A copy of the JAX package's
client (racon_tpu/serve/client.py)."""

from __future__ import annotations

import json
import os
import socket
from typing import Optional

from .protocol import read_message, write_message


class ServeError(RuntimeError):
    """The daemon answered ``ok: false``; the message is its error."""


class ServeClient:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rwb")

    @classmethod
    def from_state_dir(cls, state_dir: str,
                       timeout: float = 600.0) -> "ServeClient":
        """Connect to the daemon whose ``serve.json`` lives in
        ``state_dir`` (how port-0 daemons advertise their bound port)."""
        with open(os.path.join(state_dir, "serve.json")) as f:
            info = json.load(f)
        return cls(info["port"], host=info.get("host", "127.0.0.1"),
                   timeout=timeout)

    # -- plumbing ----------------------------------------------------------

    def rpc(self, **req) -> dict:
        """One request/response exchange; raises ServeError on
        ``ok: false`` (the raw response rides on the exception)."""
        write_message(self._f, req)
        try:
            resp = read_message(self._f)
        except (ValueError, json.JSONDecodeError) as e:
            raise ServeError(f"malformed daemon response: {e}") from None
        if resp is None:
            raise ServeError("daemon closed the connection")
        if not resp.get("ok"):
            err = ServeError(resp.get("error", "request failed"))
            err.response = resp
            raise err
        return resp

    def close(self) -> None:
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- operations --------------------------------------------------------

    def ping(self) -> dict:
        return self.rpc(op="ping")

    def submit(self, sequences: str, overlaps: str, target: str,
               args: Optional[dict] = None, include_unpolished: bool = False,
               backend: str = "", job_id: str = "",
               submitter: str = "", window_budget: int = 0,
               priority: int = 0,
               trace: Optional[dict] = None) -> str:
        resp = self.rpc(op="submit", sequences=sequences, overlaps=overlaps,
                        target=target, args=args or {},
                        include_unpolished=include_unpolished,
                        backend=backend, job_id=job_id,
                        submitter=submitter or f"pid{os.getpid()}",
                        window_budget=window_budget,
                        priority=priority,
                        trace=trace)
        return resp["job_id"]

    def status(self, job_id: str) -> dict:
        return self.rpc(op="status", job_id=job_id)

    def result(self, job_id: str, wait: bool = False,
               timeout: Optional[float] = None) -> dict:
        return self.rpc(op="result", job_id=job_id, wait=wait,
                        timeout=timeout)

    def wait(self, job_id: str, timeout: Optional[float] = None) -> dict:
        """Block until the job is terminal; returns the result response.
        Raises ServeError if the job failed/was cancelled/timed out."""
        return self.result(job_id, wait=True, timeout=timeout)

    def cancel(self, job_id: str) -> dict:
        return self.rpc(op="cancel", job_id=job_id)

    def stats(self) -> dict:
        return self.rpc(op="stats")

    def metrics(self) -> dict:
        """Prometheus exposition text + SLO snapshot (``text``/``slo``
        response fields)."""
        return self.rpc(op="metrics")

    def shutdown(self) -> dict:
        return self.rpc(op="shutdown")
