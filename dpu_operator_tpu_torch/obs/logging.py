"""Structured logging unification: JSON lines with request context.

Library code across serving/ and daemon/ logs through stdlib
``logging`` — this module is the one place that decides what a log
LINE is: a single JSON object carrying ``ts``/``level``/``logger``/
``msg`` plus the request-scoped context (``request_id``, ``replica``,
``component``) that turns grep-by-request into a one-liner and gives
graftlint GL008 a mechanical target (request-path log calls must bind
request context — see docs/static-analysis.md).

Two ways context reaches a record, in precedence order:

  * ``extra={"request_id": ..., "replica": ...}`` on the call — the
    explicit form request-path code uses;
  * ``with obs.logging.context(replica="replica0"):`` — a thread-local
    binding the ``ContextFilter`` stamps onto every record the thread
    emits inside the scope (the batcher thread binds its replica once
    instead of repeating it at every call site).

``setup()`` installs the formatter+filter on the root logger — the
app-level entry points (daemon/main.py, serving __main__s) call it;
library modules just log.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from contextlib import contextmanager
from datetime import datetime, timezone
from typing import Iterator, Optional

CONTEXT_FIELDS = ("request_id", "replica", "component", "rank")

_ctx = threading.local()


def bound_context() -> dict:
    return dict(getattr(_ctx, "fields", ()) or {})


@contextmanager
def context(**fields) -> Iterator[None]:
    """Bind context fields for every record this thread emits inside
    the scope; nests (inner bindings shadow, outer restored)."""
    prev = getattr(_ctx, "fields", None)
    merged = dict(prev or {})
    merged.update(fields)
    _ctx.fields = merged
    try:
        yield
    finally:
        _ctx.fields = prev


class ContextFilter(logging.Filter):
    """Stamp thread-local context onto records that don't already carry
    the field via ``extra=`` (explicit wins)."""

    def filter(self, record: logging.LogRecord) -> bool:
        bound = getattr(_ctx, "fields", None)
        if bound:
            for k, v in bound.items():
                if getattr(record, k, None) is None:
                    setattr(record, k, v)
        return True


class JsonLinesFormatter(logging.Formatter):
    """One JSON object per line; context fields included only when
    present (absent != empty — a replica-lifecycle line has no
    request_id and shouldn't pretend otherwise)."""

    def __init__(self, component: Optional[str] = None):
        super().__init__()
        self.component = component

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": datetime.fromtimestamp(
                record.created, timezone.utc).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if self.component is not None:
            out["component"] = self.component
        for k in CONTEXT_FIELDS:
            v = getattr(record, k, None)
            if v is not None:
                out[k] = v
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup(component: str, level: int = logging.INFO,
          stream=None) -> logging.Handler:
    """Install JSON-lines logging on the root logger (replacing any
    handler a previous setup() installed — idempotent for the daemon's
    restart-in-process tests). Returns the installed handler."""
    root = logging.getLogger()
    for h in list(root.handlers):
        if getattr(h, "_dpu_obs_handler", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonLinesFormatter(component=component))
    handler.addFilter(ContextFilter())
    handler._dpu_obs_handler = True
    root.addHandler(handler)
    root.setLevel(level)
    return handler
