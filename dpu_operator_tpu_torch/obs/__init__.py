"""Observability plane (copied from the reference's ``obs``): request
tracing, the flight recorder and logging context."""

from .flight import FlightRecorder, default_flight_dir
from .trace import Span, Tracer, get_tracer, scoped, set_tracer

__all__ = [
    "FlightRecorder",
    "Span",
    "Tracer",
    "default_flight_dir",
    "get_tracer",
    "scoped",
    "set_tracer",
]
