"""The load generator: a child process of the run, over HTTP/1.1 keep-alive.

Run as ``python loadgen.py '<job JSON>'``. The job names the server's
host and port, the traffic mix, the configuration's ``serving`` section,
the seed and the window's seconds. The child opens one keep-alive
connection a client before it sends anything, then drives
``POST /v1/generate`` in a closed loop: each client sends its next
request when its previous one has answered. Each record keeps the time
its request fell due (here: when its client became free) beside the time
it was sent.

Requests take indices in the order they are sent; request ``i`` is
``Traffic.body(i)``. The window opens when the
first ``clients`` requests have all answered, and closes ``seconds``
later; then no new request is sent and the child waits for those in
flight. It prints JSON lines on its standard output: ``{"event": "open",
"t": ...}``, ``{"event": "close", "t": ...}`` (``time.monotonic()``,
which the parent process shares) and last ``{"event": "results",
"requests": [...]}``, one record a request.

Imports numpy and the standard library only, never torch.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness.traffic import Traffic  # noqa: E402

#: Past its deadline, how long a client still waits for an answer.
GRACE_S = 60.0


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


class Client:
    """One keep-alive connection and the requests it carries."""

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, port, timeout
        self.conn = None

    def connect(self) -> None:
        self.conn = http.client.HTTPConnection(self.host, self.port,
                                               timeout=self.timeout)
        self.conn.connect()

    def post(self, payload: bytes):
        """(status, body dict or None); status -1 when the connection
        failed, and the connection is opened anew for the next request."""
        try:
            if self.conn is None:
                self.connect()
            self.conn.request("POST", "/v1/generate", body=payload,
                              headers={"Content-Type": "application/json"})
            resp = self.conn.getresponse()
            data = resp.read()
            if resp.getheader("Connection", "").lower() == "close":
                self.conn.close()
                self.conn = None
            try:
                return resp.status, json.loads(data)
            except ValueError:
                return resp.status, None
        except (OSError, http.client.HTTPException):
            if self.conn is not None:
                self.conn.close()
            self.conn = None
            return -1, None

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()


def record(i: int, client: int, t_due: float, t_send: float, t_done: float,
           status: int, body) -> dict:
    rec = {"i": i, "client": client, "t_due": t_due, "t_send": t_send,
           "t_done": t_done, "status": status}
    if status == 200 and isinstance(body, dict):
        rec["tokens"] = body.get("tokens", [])
        rec["truncated"] = bool(body.get("truncated"))
        rec["timings"] = body.get("timings", {})
        kv = body.get("kv")
        if kv:
            rec["cached_tokens"] = int(kv.get("cached_tokens", 0))
    elif isinstance(body, dict):
        rec["error"] = str(body.get("error"))[:200]
    return rec


class Run:
    def __init__(self, job: dict):
        self.traffic = Traffic(job["mix"], job["serving"], job["seed"])
        self.seconds = float(job["seconds"])
        loop = job["mix"].get("loop", "closed")
        if loop != "closed":
            raise ValueError(f"unknown loop {loop!r}: only 'closed'")
        n = self.traffic.clients
        timeout = self.traffic.deadline_ms / 1000.0 + GRACE_S
        self.clients = [Client(job["host"], job["port"], timeout)
                        for _ in range(n)]
        for c in self.clients:
            c.connect()
        self.lock = threading.Lock()
        self.next_i = 0
        self.stop = threading.Event()
        self.records: list = []
        self.first = threading.Event()   # the first cohort has answered
        self.first_left = n
        self.payloads: dict = {}

    def _done(self, rec: dict) -> None:
        with self.lock:
            self.records.append(rec)
            if rec["i"] < len(self.clients):
                self.first_left -= 1
                if self.first_left == 0:
                    self.first.set()

    def _send(self, k: int, i: int, t_due: float) -> None:
        payload = json.dumps(self.traffic.body(i)).encode()
        t_send = time.monotonic()
        status, body = self.clients[k].post(payload)
        self._done(record(i, k, t_due, t_send, time.monotonic(), status,
                          body))

    def _closed(self, k: int) -> None:
        t_due = time.monotonic()
        while not self.stop.is_set():
            with self.lock:
                i = self.next_i
                self.next_i += 1
            self._send(k, i, t_due)
            t_due = time.monotonic()

    def go(self) -> None:
        n = len(self.clients)
        threads = [threading.Thread(target=self._closed, args=(k,),
                                    daemon=True) for k in range(n)]
        for t in threads:
            t.start()
        self.first.wait()
        t_open = time.monotonic()
        emit({"event": "open", "t": t_open})
        time.sleep(max(0.0, t_open + self.seconds - time.monotonic()))
        self.stop.set()
        emit({"event": "close", "t": time.monotonic()})
        for t in threads:
            t.join()
        for c in self.clients:
            c.close()
        emit({"event": "results", "requests": self.records})


def main() -> int:
    job = json.loads(sys.argv[1])
    Run(job).go()
    return 0


if __name__ == "__main__":
    sys.exit(main())
