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
import functools
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
                "serving.sharded.procset", "serving.sharded.synthetic",
                "serving.disagg.stream", "serving.disagg.pool",
                "serving.router", "serving.router.router",
                "serving.router.gossip", "serving.autoscale",
                "parallel.fabric_worker", "serving.bench_serving"):
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
    "obs/trace.py": ("Tracer.__init__", "Tracer._record",
                     "Tracer.record_loose", "Tracer._take_loose",
                     "Tracer.drain", "Tracer.drain_take_wire",
                     "Tracer.dropped_total", "GcPauses", "_FIRST",
                     "gc_pauses"),
    "obs/xproc.py": (),
    "parallel/fabric_collectives.py": (),
    "parallel/fabric_worker.py": ("_GLOO_TIMEOUT", "_init_gloo",
                                  "_psum_bench", "_train_slice", "main"),
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
    "serving/api.py": ("GenerateRequest", "GenerateRequest.timings_ms"),
    "serving/autoscale.py": (),
    "serving/bench_serving.py": ("paged_attn_equiv_lane", "paged_attn_bench",
                                 "sharded_kv_scaling", "decode_loop_rates",
                                 "trace_overhead", "sharded_decode",
                                 "sharded_trace_overhead", "main"),
    "serving/disagg/pool.py": (),
    "serving/disagg/spec.py": (),
    "serving/disagg/stream.py": (),
    "serving/executor.py": ("LocalExecutor", "_Pending", "_run_timed",
                            "_GuardedWorker.__init__", "_GuardedWorker._run",
                            "_GuardedWorker.submit", "Executor.step_clock",
                            "SyntheticExecutor.__init__",
                            "SyntheticExecutor.step",
                            "SyntheticExecutor.step_clock"),
    "serving/kvcache/allocator.py": (),
    "serving/kvcache/executor.py": ("PagedKVExecutor",
                                    "KVExecutorBase.step_clock",
                                    "KVExecutorBase._raw_clock",
                                    "SyntheticKVExecutor.__init__",
                                    "SyntheticKVExecutor._dispatch",
                                    "SyntheticKVExecutor._materialize",
                                    "SyntheticKVExecutor._raw_clock"),
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
    "serving/router/gossip.py": (),
    "serving/router/router.py": (),
    # The batcher's definitions the step timeline rewrites are checked
    # against the reference's below (test_batcher_*), all but the
    # timeline's own helpers.
    "serving/scheduler.py": ("CPU_EVERY", "_Submitted",
                             "ContinuousBatcher.__init__",
                             "ContinuousBatcher._observe_step",
                             "ContinuousBatcher._submit_step",
                             "ContinuousBatcher._collect_step",
                             "ContinuousBatcher._step_spans",
                             "ContinuousBatcher._sync_step",
                             "ContinuousBatcher._pop_admissions",
                             "ContinuousBatcher._run_sync",
                             "ContinuousBatcher._run_pipelined",
                             "ContinuousBatcher._drain_stopped",
                             "ContinuousBatcher._collect_retire_kv",
                             "ContinuousBatcher._run_kv"),
    "serving/server.py": ("ServingServer.__init__", "ServingServer.start",
                          "ServingServer.stop"),
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
    class that lost whole methods still compares member by member. An
    absolute import of the port's package reads as the same import of
    the reference's (the one line a copy changes to use the port's
    module of that name)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.split(".")[0] == "dpu_operator_tpu_torch"):
            node.module = "dpu_operator_tpu" + node.module[len(
                "dpu_operator_tpu_torch"):]
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


# The step timeline's helpers: each stands in a batcher definition for a
# run of the reference's statements that drives the executor.
_HELPERS = {"_submit_step", "_collect_step", "_sync_step"}
_DRIVES = {"submit", "collect", "step"}
# The timeline's own state: a statement on it alone is added to the
# reference's.
_TIMELINE = {"_log", "_clock_of", "_cpu_mark"}


def _attrs(node):
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _drives_executor(stmts):
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr in _DRIVES
               and ast.unparse(n.func.value) in ("ex", "self.executor")
               for s in stmts for n in ast.walk(s))


@functools.lru_cache(maxsize=None)
def _port_series():
    """Every string constant in the port's batcher: the series it
    observes among them."""
    tree = ast.parse(open(os.path.join(
        ROOT, "dpu_operator_tpu_torch", "serving/scheduler.py")).read())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _observed(stmt):
    """(series, value expression) of a ``self._observe`` statement."""
    if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "_observe"
            and len(stmt.value.args) >= 2
            and isinstance(stmt.value.args[0], ast.Constant)):
        return stmt.value.args[0].value, ast.dump(stmt.value.args[1])
    return None


def _dropped(stmt, siblings):
    """A second observation of a value that a kept series already records,
    under a series the port's batcher no longer has at all (the
    reference's blocked-time alias)."""
    got = _observed(stmt)
    if got is None or got[0] in _port_series():
        return False
    return any(o is not None and o[1] == got[1] and o[0] in _port_series()
               for o in map(_observed, siblings))


def _same_stmts(port, ref, block=None):
    """``port`` is ``ref`` statement for statement, but that a statement
    calling one of the timeline's helpers stands for a run of ``ref``'s
    that drives the executor, a statement on the timeline's own state
    is added, and the alias is dropped. ``block``: all of ``ref``'s
    block, where ``ref`` is its tail."""
    block = ref if block is None else block
    if ref and _dropped(ref[0], block) and _same_stmts(port, ref[1:],
                                                       block):
        return True
    if not port:
        return not ref
    head, rest = port[0], port[1:]
    if isinstance(head, (ast.Assign, ast.AnnAssign, ast.Expr)):
        names = _attrs(head)
        if names & _HELPERS:
            return any(_drives_executor(ref[:k])
                       and _same_stmts(rest, ref[k:], block)
                       for k in range(1, len(ref) + 1))
        if names & _TIMELINE:
            return _same_stmts(rest, ref, block)
    return (bool(ref) and _same_node(head, ref[0])
            and _same_stmts(rest, ref[1:], block))


def _same_node(p, r):
    if type(p) is not type(r):
        return False
    for field in p._fields:
        a, b = getattr(p, field), getattr(r, field)
        if isinstance(a, list) and all(isinstance(x, ast.stmt)
                                       for x in a + b) and (a or b):
            if not _same_stmts(a, b):
                return False
        elif isinstance(a, list):
            if len(a) != len(b) or not all(
                    _same_node(x, y) if isinstance(x, ast.AST) else x == y
                    for x, y in zip(a, b)):
                return False
        elif isinstance(a, ast.AST):
            if not isinstance(b, ast.AST) or not _same_node(a, b):
                return False
        elif a != b:
            return False
    return True


def _batcher_defs(name):
    rel = "serving/scheduler.py"
    out = []
    for pkg in ("dpu_operator_tpu_torch", "dpu_operator_tpu"):
        tree = ast.parse(open(os.path.join(ROOT, pkg, rel)).read())
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "ContinuousBatcher")
        fn = next(n for n in cls.body
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        if isinstance(fn.body[0], ast.Expr) and isinstance(
                fn.body[0].value, ast.Constant):
            fn.body = fn.body[1:]
        out.append(fn)
    return out


@pytest.mark.parametrize("loop", ["_run_pipelined", "_run_kv", "_run_sync",
                                  "_collect_retire_kv"])
def test_batcher_loop_is_the_reference_s_but_its_drain(loop):
    """The port's batcher loops are the reference's, statement for
    statement, but that they submit and collect each step through the
    step timeline's helpers (``_submit_step`` and ``_collect_step``, or
    ``_sync_step`` for the synchronous row loop), each in place of the
    reference's run of statements that drives the executor, and that the
    two pipelined loops end in ``self._drain_stopped(prev)`` (the step
    left in flight by a stop is collected)."""
    port, ref = _batcher_defs(loop)
    if loop in ("_run_pipelined", "_run_kv"):
        assert ast.unparse(port.body[-1]) == "self._drain_stopped(prev)"
        port.body = port.body[:-1]
    assert _attrs(port) & _HELPERS
    assert _same_stmts(port.body, ref.body)


@pytest.mark.parametrize("name", ["__init__", "_pop_admissions",
                                  "_observe_step"])
def test_batcher_definition_is_the_reference_s_but_the_timeline(name):
    """The rest of the batcher the step timeline touches is the
    reference's, statement for statement, but for statements on the
    timeline's own state (its step log, the executor's step clock, the
    thread's CPU clock mark) and the reference's observation of a series
    the port no longer has (the blocked-time alias)."""
    port, ref = _batcher_defs(name)
    assert _same_stmts(port.body, ref.body)
    assert ast.dump(port.args) == ast.dump(ref.args)
