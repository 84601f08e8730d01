"""The port stands alone: importing all of it loads neither jax nor any
module of the JAX package, and its entry point never falls back to the
CPU on its own. The host-plane modules it keeps its own copies of stay
the reference's code: every definition a copy keeps is the reference's,
statement for statement (docstrings and comments aside).

The import check runs in a fresh interpreter: this test process has jax
loaded already (tests/conftest.py). Module names are matched exactly or
by the ``dpu_operator_tpu.`` prefix, since the port's own name,
``dpu_operator_tpu_torch``, starts with ``dpu_operator_tpu``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from dpu_operator_tpu_torch.serving import PagedKVExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import dpu_operator_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "dpu_operator_tpu" or m.startswith("dpu_operator_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_importing_the_whole_port_loads_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("serving.server", "serving.kvcache.executor",
                "serving.kvcache.paged", "parallel.paged_attn",
                "parallel.burn", "parallel.mxu_bench", "parallel.bench_gpu",
                "parallel.fabric_probe", "parallel.tile_mma",
                "parallel.ring_attention", "parallel.ring_probe",
                "parallel.ulysses_attention", "parallel.collective_matmul",
                "parallel.mesh", "device",
                "cuda_build", "serving.kvcache.sharded",
                "serving.disagg.spec", "serving.sharded.shard_worker",
                "serving.infer", "parallel.moe", "parallel.train_step",
                "parallel.pipeline", "parallel.pipeline_1f1b",
                "parallel.topology", "parallel.fabric_collectives",
                "parallel.quantize", "obs.xproc", "serving.sharded",
                "serving.sharded.shard_math", "serving.sharded.executor",
                "serving.sharded.procset", "serving.sharded.synthetic"):
        assert f"dpu_operator_tpu_torch.{mod}" in out["imported"]


def test_executor_without_device_needs_cuda():
    kw = dict(slots=2, vocab=16, d=8, heads=2, block_size=4,
              num_blocks=32, max_blocks_per_req=4, prefill_chunk=4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVExecutor(**kw)
    with pytest.raises(ValueError, match="CUDA"):
        PagedKVExecutor(**kw, kernel="cuda", device="cpu")
    assert PagedKVExecutor(**kw, device="cpu")._paged.kernel == "torch"


# Copied jax-free modules (path under either package) -> definitions the
# port adds or rewrites there on top of the reference's: a whole
# definition by its name, or one method as ``Class.method``.
COPIES = {
    "faults.py": (),
    "obs/flight.py": (),
    "obs/logging.py": (),
    "obs/trace.py": (),
    "obs/xproc.py": (),
    "parallel/fabric_collectives.py": (),
    "parallel/fabric_worker.py": (),
    "parallel/mesh.py": ("build_mesh", "ring_is_ici_adjacent",
                         "mesh_from_topology", "build_hybrid_mesh"),
    "parallel/quantize.py": ("int8_block_encode", "int8_block_decode"),
    "parallel/pipeline_1f1b.py": ("_take", "interleave_stack", "uninterleave",
                                  "run_schedule", "make_1f1b",
                                  "sequential_loss"),
    "parallel/ring_attention.py": ("MAX_DIM", "KERNEL_DTYPES",
                                   "_online_update", "_scores", "_pack_kv",
                                   "_shards", "_ring_fold",
                                   "ring_attention_plain", "key_tile",
                                   "tf32_split", "split_matmul",
                                   "ring_attention_split", "_launcher",
                                   "ring_attention_cuda",
                                   "make_ring_attention",
                                   "ring_attention_batched"),
    "parallel/topology.py": (),
    "parallel/ulysses_attention.py": ("_heads_to_rows", "_seq_to_head_shard",
                                      "_full_attention", "_ulysses_body",
                                      "make_ulysses_attention",
                                      "dense_attention_reference"),
    "serving/api.py": (),
    "serving/disagg/spec.py": (),
    "serving/executor.py": ("LocalExecutor",),
    "serving/kvcache/allocator.py": (),
    "serving/kvcache/executor.py": ("PagedKVExecutor",),
    "serving/kvcache/sharded.py": ("_on_stream", "_dev", "_after",
                                   "_new_stream", "_write_pages",
                                   "_RankState.__init__",
                                   "SyntheticKVShardSet.__init__",
                                   "SyntheticKVShardSet._rank_loop",
                                   "SyntheticKVShardSet._merge_and_finish",
                                   "SyntheticKVShardSet.export_rank_pages",
                                   "SyntheticKVShardSet.import_rank_pages",
                                   "KVShardProcessSet.__init__",
                                   "serve_kv_rank",
                                   "ShardedPagedKVExecutor.__init__"),
    "serving/kvcache/tiering.py": (),
    "serving/queue.py": (),
    "serving/scheduler.py": (),
    "serving/server.py": ("ServingServer.__init__",),
    "serving/sharded/executor.py": (),
    "serving/sharded/procset.py": ("ShardProcessSet.__init__",
                                   "ShardProcessSet._spawn"),
    "serving/sharded/protocol.py": (),
    "serving/sharded/shard_worker.py": ("_kv_main", "_load_slice",
                                        "_maybe_jit", "main", "_serve"),
    "serving/sharded/synthetic.py": ("SyntheticShardSet.__init__",
                                     "SyntheticShardSet._make_slice"),
    "serving/spec.py": ("TruncatedDraft",),
    "utils/metrics.py": (),
}


def _definitions(path):
    """name -> AST dump, docstrings dropped: each top-level function and
    assignment; each class without its methods (bases, decorators, class
    attributes) under its name, and each method as ``Class.method``, so a
    class that lost whole methods still compares member by member."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            methods = [b for b in node.body if isinstance(b, ast.FunctionDef)]
            for m in methods:
                out[f"{node.name}.{m.name}"] = ast.dump(m)
            node.body = [b for b in node.body if b not in methods]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_keeps_the_reference_code(rel):
    ref = _definitions(os.path.join(ROOT, "dpu_operator_tpu", rel))
    port = _definitions(os.path.join(ROOT, "dpu_operator_tpu_torch", rel))
    own = COPIES[rel]
    kept = [n for n in port if n not in own and n.split(".")[0] not in own]
    assert kept, rel
    for name in kept:
        assert name in ref, f"{rel}: {name} is not in the reference"
        assert port[name] == ref[name], f"{rel}: {name} differs"
