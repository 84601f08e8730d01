"""Observability plane (copied from the reference's ``obs``): request
tracing, the flight recorder, logging context, and cross-process span
shipping and clock alignment (``xproc``)."""

from .flight import FlightRecorder, default_flight_dir
from .trace import Span, Tracer, get_tracer, scoped, set_tracer
from .xproc import ClockSync, SpanShip

__all__ = [
    "ClockSync",
    "FlightRecorder",
    "Span",
    "SpanShip",
    "Tracer",
    "default_flight_dir",
    "get_tracer",
    "scoped",
    "set_tracer",
]
