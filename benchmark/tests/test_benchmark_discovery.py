"""A new traffic mix, configuration or metric is a new file and an entry:
the harness finds it by name, with no existing file edited."""

import json
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT


def copy_checkout(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_files_are_found_by_name(tmp_path):
    root = copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "benchmark/traffic/fixed100.json").write_text(json.dumps(
        {"loop": "closed", "clients": 4,
         "prompt_len": {"dist": "fixed", "lo": 100},
         "max_tokens": {"dist": "fixed", "lo": 8}}))
    (root / "benchmark/metrics/answers_per_s.py").write_text(
        'UNIT, BETTER, SOURCE, LAYER, MOVES = "1/s", "higher", '
        '"host_clock", "HTTP front door (serving/server.py)", '
        '"tokens_per_s"\n\n'
        "def read(w):\n    return len(w.answered) / w.seconds\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "paged-olmo17-7b.fixed100",
                               "config": "paged-olmo17-7b",
                               "traffic": "fixed100", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "answers_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "HTTP front door "
                                        "(serving/server.py)",
                               "moves": "tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, 'benchmark')\n"
        "from harness.spec import load_cell\n"
        "from harness.readers import load_reader\n"
        "from harness.traffic import Traffic\n"
        "c = load_cell('paged-olmo17-7b.fixed100')\n"
        "t = Traffic(c.traffic, c.config['serving'], 1)\n"
        "r = load_reader('answers_per_s')\n"
        "print(c.traffic['loop'], t.request(0).prompt_len, "
        "'answers_per_s' in c.per_layer, r.UNIT)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out == ["closed", "100", "True", "1/s"]
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


def test_every_metric_in_the_benchmark_has_a_matching_reader():
    sys.path.insert(0, BENCH)
    from harness.readers import load_reader
    bench = json.loads(open(f"{ROOT}/BENCHMARK.json").read())
    for m in bench["end_to_end"] + bench["per_layer"]:
        r = load_reader(m["name"])
        assert (r.UNIT, r.BETTER, r.SOURCE) == (
            m["unit"], m["better"], m["source"]), m["name"]
        assert r.LAYER == m.get("layer"), m["name"]
        assert r.MOVES == m.get("moves"), m["name"]


def test_every_cell_finds_its_configuration_and_mix():
    sys.path.insert(0, BENCH)
    from harness.spec import load_benchmark, load_cell
    from harness.systems import load_system
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = load_cell(w["name"], bench)
        assert load_system(cell.config["executor"])
        assert {"setup_s"} <= set(cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
