"""Nothing the benchmark imports is ``jax``, ``jaxlib``, ``flax`` or the JAX
package; names are compared whole, since the port's package name begins
with the JAX package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dpu_operator_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    return sorted((Path(BENCH) / sub).rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    for p in sources():
        bad = set(imported_tops(p)) & FORBIDDEN
        assert not bad, f"{p} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        tops = set(imported_tops(p))
        assert "dpu_operator_tpu_torch" not in tops, p
        assert tops <= {"__future__", "contextlib", "hashlib", "math",
                        "sys", "typing", "numpy", "torch"}, (p, tops)


def test_the_load_generator_imports_no_torch():
    for name in ("loadgen.py", "traffic.py"):
        tops = set(imported_tops(Path(BENCH) / "harness" / name))
        assert "torch" not in tops and not tops & FORBIDDEN


def run_py(code: str) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout.strip()


def test_a_run_loads_no_jax_module():
    out = run_py(
        "import sys; sys.path[:0] = ['benchmark', '.']\n"
        "import run\n"
        "from harness.core import run_cell\n"
        "import harness.systems.paged_kv, harness.systems.row_plane\n"
        "import harness.profile\n"
        "from dpu_operator_tpu_torch.serving.server import ServingServer\n"
        "from dpu_operator_tpu_torch.serving.kvcache.executor import "
        "PagedKVExecutor\n"
        "from dpu_operator_tpu_torch.serving.executor import "
        "LocalExecutor\n"
        "print(run.forbidden_modules())")
    assert out == "[]"


def test_the_check_compares_whole_top_level_names():
    out = run_py(
        "import sys, types; sys.path[:0] = ['benchmark', '.']\n"
        "import run\n"
        "sys.modules['dpu_operator_tpu_torch_x'] = types.ModuleType('x')\n"
        "a = run.forbidden_modules()\n"
        "sys.modules['dpu_operator_tpu.serving'] = types.ModuleType('y')\n"
        "print(a, run.forbidden_modules())")
    assert out == "[] ['dpu_operator_tpu']"


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "paged-olmo17-7b.longctx", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr
