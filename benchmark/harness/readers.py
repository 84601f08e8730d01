"""Load a metric's reader, ``benchmark/metrics/<name>.py``, by its name.

A reader module declares ``UNIT``, ``BETTER``, ``SOURCE``, ``LAYER``
(``None`` for an end-to-end metric) and ``MOVES`` (the end-to-end metric
it should move; ``None`` for an end-to-end metric), and defines
``read(window)``, which returns the value, or ``None`` where it finds
nothing to read.
"""

from __future__ import annotations

import importlib.util

from .spec import METRICS_DIR


def load_reader(name: str):
    path = METRICS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r}: no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
