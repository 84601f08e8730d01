"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the ``file`` of its ``configs`` entry;
the traffic mix is ``benchmark/traffic/<traffic>.json``; each metric is
``benchmark/metrics/<name>.py``. Adding a configuration, a mix or a metric
is adding a file and an entry: nothing here names one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

#: The benchmark's own folder and the checkout's root.
BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
TRAFFIC_DIR = BENCH_DIR / "traffic"
METRICS_DIR = BENCH_DIR / "metrics"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    #: metric name -> its BENCHMARK.json entry, for the metrics this cell
    #: reports with --trace 0 (end to end) and --trace 1 (per layer).
    end_to_end: Dict[str, dict] = field(default_factory=dict)
    per_layer: Dict[str, dict] = field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from a checkout "
                                f"that holds the benchmark")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = load_traffic(w["traffic"])
    e2e = {m["name"]: m for m in bench["end_to_end"] if _applies(m, name)}
    per = {m["name"]: m for m in bench["per_layer"] if _applies(m, name)}
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=e2e, per_layer=per)


def load_traffic(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"traffic mix {name!r}: {path} not found")
    return json.loads(path.read_text())


def list_metric_files() -> List[str]:
    return sorted(p.stem for p in METRICS_DIR.glob("*.py")
                  if not p.stem.startswith("_"))
