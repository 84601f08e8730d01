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

import logging
import threading
from contextlib import contextmanager
from typing import Iterator

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
