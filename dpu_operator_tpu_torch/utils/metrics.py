"""Prometheus-text-format metrics registry + HTTP exposition.

The reference gets controller-runtime's prometheus registry for free
(operator :18090 with authn/authz filter, cmd/main.go:82-86; DPU-side
manager :18001, dpusidemanager.go:315-319). This is the dependency-free
equivalent: counters/gauges/histograms rendered in the Prometheus text
exposition format on /metrics, plus /healthz."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape_label_value(value: str) -> str:
    """Prometheus text exposition format: inside a label value,
    backslash, double-quote and line-feed must be escaped (in that
    order — escaping the escape char first keeps it idempotent-safe)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(val)}"' for k, val in labels)
    return "{" + inner + "}"


def _fmt_bucket_bound(b: float) -> str:
    """str(float) — 'le="1.0"', the python-client form. le is a
    SERIES-IDENTITY label: the pre-existing histograms already scrape
    with these spellings, so custom buckets must render the same way or
    existing series silently end and restart under new names."""
    return str(float(b))


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[tuple, float]] = {}
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        self._hists: Dict[str, Dict[tuple, dict]] = {}
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}
        self._help: Dict[str, str] = {}

    def counter_inc(self, name: str, labels: Optional[dict] = None, by: float = 1.0,
                    help: str = "") -> None:
        key = tuple(sorted(labels.items())) if labels else ()
        with self._lock:
            self._help.setdefault(name, help)
            self._counters.setdefault(name, {})
            self._counters[name][key] = self._counters[name].get(key, 0.0) + by

    def gauge_set(self, name: str, value: float, labels: Optional[dict] = None,
                  help: str = "") -> None:
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            self._help.setdefault(name, help)
            self._gauges.setdefault(name, {})[key] = value

    def observe(self, name: str, value: float, labels: Optional[dict] = None,
                help: str = "", buckets: Optional[tuple] = None) -> None:
        """Cumulative bucket counts + sum + count, prometheus-style — O(1)
        memory per series regardless of observation volume.

        `buckets` sets this METRIC's upper bounds (ascending) on first
        use; later observations reuse them (per-metric, like
        promclient's histogram registration — a histogram cannot change
        buckets mid-flight without corrupting the cumulative counts)."""
        # No-label fast path: the shard worker observes its two step
        # histograms every decode step (section 10 prices this call).
        key = tuple(sorted(labels.items())) if labels else ()
        if buckets:
            import math

            bs_new = tuple(float(b) for b in buckets)
            # Finite and ascending, no trailing +Inf: render() appends
            # the +Inf line itself (from count), and a non-finite bound
            # would break both the le= formatting and quantile()'s
            # interpolation.
            if (not all(math.isfinite(b) for b in bs_new)
                    or list(bs_new) != sorted(set(bs_new))):
                raise ValueError(
                    f"buckets must be finite, ascending and distinct "
                    f"(+Inf is implicit): {buckets}")
        with self._lock:
            self._help.setdefault(name, help)
            bs = self._hist_buckets.setdefault(
                name, bs_new if buckets else _BUCKETS)
            if buckets and bs != bs_new:
                # Changing buckets mid-flight would corrupt the
                # cumulative counts; a silently-ignored spec would make
                # resolution depend on call order. Same-spec repeats
                # (the hot observe path) pass untouched.
                raise ValueError(
                    f"{name} already registered with buckets {bs}, "
                    f"got conflicting {bs_new}")
            series = self._hists.setdefault(name, {})
            state = series.get(key)
            if state is None:
                state = {"buckets": [0] * len(bs), "sum": 0.0, "count": 0}
                series[key] = state
            for i, b in enumerate(bs):
                if value <= b:
                    state["buckets"][i] += 1
            state["sum"] += value
            state["count"] += 1

    def counter_value(self, name: str,
                      labels: Optional[dict] = None) -> float:
        """Read one counter series (0.0 when never incremented) — for
        tests and in-process consumers (the bench's recovery section),
        instead of re-parsing render() output."""
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            return self._counters.get(name, {}).get(key, 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across ALL label sets (e.g. requeues over
        every replica × outcome)."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def gauge_value(self, name: str,
                    labels: Optional[dict] = None) -> Optional[float]:
        """Read one gauge series; None when the series doesn't exist
        (unlike counters, an absent gauge is 'never published', not 0)."""
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            return self._gauges.get(name, {}).get(key)

    def quantile(self, name: str, q: float,
                 labels: Optional[dict] = None) -> Optional[float]:
        """Estimate the q-quantile (0 < q <= 1) of a histogram series
        from its cumulative bucket counts — the server-side twin of
        PromQL's histogram_quantile, for in-process p99 (the serving
        plane's latency SLO check). Linear interpolation within the
        containing bucket, 0 as the implicit lower bound of the first;
        observations past the last finite bucket clamp to that bound
        (exactly histogram_quantile's convention). None when the series
        has no observations."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            state = self._hists.get(name, {}).get(key)
            if state is None or state["count"] == 0:
                return None
            bs = self._hist_buckets.get(name, _BUCKETS)
            target = q * state["count"]
            prev_cum, prev_bound = 0, 0.0
            for i, b in enumerate(bs):
                cum = state["buckets"][i]
                if cum >= target:
                    in_bucket = cum - prev_cum
                    frac = ((target - prev_cum) / in_bucket
                            if in_bucket else 1.0)
                    return prev_bound + (b - prev_bound) * frac
                prev_cum, prev_bound = cum, b
            return float(bs[-1])

    def counter_set(self, name: str, value: float,
                    labels: Optional[dict] = None,
                    help: str = "") -> None:
        """Metric federation: SET a counter series to an
        authoritative total published by another process (a shard
        worker's piggybacked snapshot). The SOURCE owns monotonicity;
        a worker restart resets its totals exactly like a scraped
        process restart resets a Prometheus counter — consumers handle
        it with rate()/increase(), so the re-export must not paper
        over it by clamping."""
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            self._help.setdefault(name, help)
            self._counters.setdefault(name, {})[key] = float(value)

    def histogram_set(self, name: str, labels: Optional[dict],
                      bounds, bucket_counts, total: float,
                      count: int, help: str = "") -> None:
        """Metric federation: replace one histogram series' state with
        an authoritative snapshot from another process (cumulative
        per-bound counts + sum + count, exactly the internal state
        observe() accumulates). Bounds register on first use and must
        match thereafter — same contract as observe(buckets=)."""
        key = tuple(sorted((labels or {}).items()))
        bs_new = tuple(float(b) for b in bounds)
        counts = [int(c) for c in bucket_counts]
        if len(counts) != len(bs_new):
            raise ValueError(
                f"{name}: {len(counts)} bucket counts for "
                f"{len(bs_new)} bounds")
        with self._lock:
            self._help.setdefault(name, help)
            bs = self._hist_buckets.setdefault(name, bs_new)
            if bs != bs_new:
                raise ValueError(
                    f"{name} already registered with buckets {bs}, "
                    f"got conflicting {bs_new}")
            self._hists.setdefault(name, {})[key] = {
                "buckets": counts, "sum": float(total),
                "count": int(count)}

    def federated_snapshot(self) -> dict:
        """JSON-able snapshot of every counter and histogram — what a
        shard worker piggybacks onto its reply frames. Labels travel
        as sorted [k, v] pairs; histogram entries carry their bounds
        so the consumer can register them faithfully."""
        with self._lock:
            return {
                "counters": [
                    [name, [list(kv) for kv in key], val]
                    for name, series in self._counters.items()
                    for key, val in series.items()],
                "hists": [
                    [name, [list(kv) for kv in key],
                     list(self._hist_buckets.get(name, _BUCKETS)),
                     list(st["buckets"]), st["sum"], st["count"]]
                    for name, series in self._hists.items()
                    for key, st in series.items()],
            }

    def apply_federated(self, snap: dict,
                        extra_labels: Optional[dict] = None) -> None:
        """Re-export a federated_snapshot(), merging ``extra_labels``
        into every series (the coordinator stamps rank/codec/replica
        here — a label the source also set loses to the stamp: the
        consumer's identity wins over self-description)."""
        extra = dict(extra_labels or {})
        for name, key, val in snap.get("counters", ()):
            labels = dict(key)
            labels.update(extra)
            self.counter_set(name, val, labels)
        for name, key, bounds, counts, total, count in snap.get(
                "hists", ()):
            labels = dict(key)
            labels.update(extra)
            self.histogram_set(name, labels, bounds, counts, total,
                               count)

    def histogram_totals(self, name: str
                         ) -> Dict[tuple, Tuple[float, int]]:
        """(sum, count) per label-set of a histogram — for derived
        scrape-time gauges (e.g. the serving plane's host-gap fraction)
        computed where the series live instead of in PromQL. Keys are
        the sorted (label, value) tuples the registry stores."""
        with self._lock:
            return {key: (state["sum"], state["count"])
                    for key, state in self._hists.get(name, {}).items()}

    def render(self) -> str:
        # Snapshot-then-format: the lock is held ONLY to copy the
        # series state, never while formatting. Formatting calls
        # str()/escape on arbitrary label values and builds a string
        # proportional to the whole registry — held under the lock, a
        # slow scraper (or merely a big registry) would stall every
        # hot-path observe()/counter_inc() in the batcher for the full
        # render (regression-tested in tests/test_obs.py with a
        # deliberately slow label __str__).
        with self._lock:
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}
            hists = {
                n: {key: (list(st["buckets"]), st["sum"], st["count"])
                    for key, st in s.items()}
                for n, s in self._hists.items()
            }
            helps = dict(self._help)
            hist_buckets = dict(self._hist_buckets)

        lines: List[str] = []
        for name, series in sorted(counters.items()):
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} counter")
            for key, val in sorted(series.items()):
                lines.append(f"{name}{_fmt_labels(key)} {val}")
        for name, series in sorted(gauges.items()):
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} gauge")
            for key, val in sorted(series.items()):
                lines.append(f"{name}{_fmt_labels(key)} {val}")
        for name, series in sorted(hists.items()):
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} histogram")
            bs = hist_buckets.get(name, _BUCKETS)
            for key, (bucket_counts, total, count) in sorted(
                    series.items()):
                for i, b in enumerate(bs):
                    bl = key + (("le", _fmt_bucket_bound(b)),)
                    lines.append(
                        f"{name}_bucket{_fmt_labels(bl)} {bucket_counts[i]}"
                    )
                bl = key + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_fmt_labels(bl)} {count}")
                lines.append(f"{name}_sum{_fmt_labels(key)} {total}")
                lines.append(f"{name}_count{_fmt_labels(key)} {count}")
        return "\n".join(lines) + "\n"


# Default process-wide registry (controller-runtime has the same shape).
default_registry = Registry()
