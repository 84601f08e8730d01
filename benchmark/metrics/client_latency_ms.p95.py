"""The client-side p95 of ``latency_p95_ms``, read per layer, where it
moves ``tokens_per_s``: in a closed loop the clients' latency and the
replica's tokens per second are one another's inverse (clients over
latency). It is read in every cell, also in those whose host-clock tail
spreads too widely between runs to hold a bound end to end."""

from harness.readers import load_reader

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "host_clock", \
    "HTTP front door (serving/server.py)", "tokens_per_s"


def read(w):
    return load_reader("latency_p95_ms").read(w)
