"""Share of the requests' time in a batch slot that the server's
interpreter spent in cyclic-GC pauses: 100 * sum(``timings.gc_ms``) /
sum(``timings.decode_ms``) over the answered requests.

``gc_ms`` is the pause between a request's admission and its end (the
``host.gc`` spans of the server's ``gc.callbacks`` hook); every thread
stops for a collection, the batcher's too. Each request sums the pauses
over its own slot time, so a pause counts once for each request it
held up. ``None`` where no answer carries the field (no hook)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "lower", "program_span", \
    "host interpreter (the server's process)", "tokens_per_s"


def read(w):
    gc_ms = slot_ms = 0.0
    for r in w.answered:
        t = r.get("timings", {})
        if "gc_ms" in t and "decode_ms" in t:
            gc_ms += t["gc_ms"]
            slot_ms += t["decode_ms"]
    return 100.0 * gc_ms / slot_ms if slot_ms > 0 else None
