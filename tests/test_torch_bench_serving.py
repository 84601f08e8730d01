"""The port's serving bench (``dpu_operator_tpu_torch/serving/bench_serving.py``)
against the JAX package's, on the CPU.

  * the percentile helpers on seeded lists: equal;
  * every section the port rewrites (sections 5, 7, 9, 10, 11 and 14), run
    in both packages at small arguments: the same keys, with section 11's
    renames (``_xla_ms`` -> ``_torch_ms``, ``_pallas_ms`` -> ``_cuda_ms``);
    on the CPU the port's section 11 has no kernel to compare, so it lacks
    ``serving_paged_attn_equiv_ok``;
  * ``main``'s own sections (1-4) with every other section stubbed in both
    packages: the same keys;
  * the residency keys (32 896 / 131 200 / 3.99) and the context-scaling
    keys (2.0 / 3.997): equal to the reference's, exactly;
  * the equivalence lane's plain arm against the reference's XLA lane and
    its interpret-mode Pallas lane, at the reduced shapes, seeds and 4
    steps: tokens and int8 code pools exact; the per-block scales within
    1e-6 absolute (the q/k/v projections are float32 matmuls in two
    libraries, whose sums may differ in the last bit; see
    ``tests/test_torch_paged_step.py``);
  * ``main``: exit 2 and nothing on stdout without a card and without
    ``--device cpu``; with sections stubbed, the reference's section
    order, ``device`` handed to every section that takes one, and exit 1
    after printing the object when a section fails.

No rate or latency is asserted.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpu_operator_tpu.serving import bench_serving as ref
from dpu_operator_tpu.serving.kvcache.paged import PagedDecodeStep as RefStep
from dpu_operator_tpu_torch.serving import bench_serving as port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
RENAMES = {"serving_paged_attn_xla_ms": "serving_paged_attn_torch_ms",
           "serving_paged_attn_pallas_ms": "serving_paged_attn_cuda_ms"}
SCALE_ATOL = 1e-6
MODEL = dict(S=1, d=8, h=8, E=1)


def _quiet(msg):
    pass


# Each rewritten section at small arguments: (module -> keyword arguments
# of its call). The port's calls add device="cpu".
SECTIONS = {
    "decode_loop_rates": lambda m, **kw: m.decode_loop_rates(
        2, MODEL, 2, 2, _quiet, repeats=1, **kw),
    "trace_overhead": lambda m, **kw: m.trace_overhead(
        2, MODEL, 2, 2, _quiet, repeats=1, **kw),
    "sharded_decode": lambda m, **kw: m.sharded_decode(
        2, _quiet, n_req=2, toks=2, step_ms=0.2, coll_ms=0.1, repeats=1,
        **kw),
    "sharded_trace_overhead": lambda m, **kw: m.sharded_trace_overhead(
        2, _quiet, world=1, iters=20, step_ms=0.0, coll_ms=0.0, **kw),
    "paged_attn_bench": lambda m, **kw: m.paged_attn_bench(
        _quiet, iters=1, repeats=1, **kw),
    "sharded_kv_scaling": lambda m, **kw: m.sharded_kv_scaling(
        _quiet, n_req=2, toks=2, repeats=1, **kw),
}

_runs: dict = {}


def _run(name):
    """(reference's output, port's output) of one section, run once a
    test session."""
    if name not in _runs:
        _runs[name] = (SECTIONS[name](ref), SECTIONS[name](port, **CPU))
    return _runs[name]


def _renamed(keys):
    return {RENAMES.get(k, k) for k in keys}


def test_nearest_rank_and_quantiles_match_reference():
    rng = np.random.RandomState(23)
    for n in (1, 2, 7, 99, 100, 101, 1000):
        lat = [float(x) for x in rng.exponential(20.0, size=n)]
        s = sorted(lat)
        for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
            assert port.nearest_rank(s, q) == ref.nearest_rank(s, q)
        assert port._quantiles(lat) == ref._quantiles(lat)
    assert port._quantiles([]) == ref._quantiles([])


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_rewritten_section_keys_match_reference(name):
    want, got = _run(name)
    expect = _renamed(want)
    if name == "paged_attn_bench":
        assert want["serving_paged_attn_equiv_ok"] is True
        assert want["serving_paged_attn_kernel"] == "xla"
        assert got["serving_paged_attn_kernel"] == "torch"
        # No kernel on the CPU: nothing to compare it with.
        expect.discard("serving_paged_attn_equiv_ok")
    assert set(got) == expect


def test_residency_keys_equal_reference():
    want, got = _run("paged_attn_bench")
    keys = ("serving_kv_bytes_per_slot", "serving_kv_bytes_per_slot_fp32",
            "serving_kv_bytes_reduction")
    assert [got[k] for k in keys] == [want[k] for k in keys] == \
        [32896, 131200, 3.99]


def test_context_scaling_keys_equal_reference():
    want, got = _run("sharded_kv_scaling")
    keys = ("serving_ctx_per_replica_scaling",
            "serving_ctx_per_replica_scaling_w4")
    assert [got[k] for k in keys] == [want[k] for k in keys] == [2.0, 3.997]


def _ref_lane(kernel):
    """The reference's interpret-mode lane (its ``paged_attn_bench``,
    CPU branch), for one kernel."""
    small = dict(slots=2, vocab=32, d=16, heads=2, block_size=4,
                 num_blocks=32, max_blocks_per_req=4, chunk=4, seed=5)
    st = RefStep(kernel=kernel, pool_dtype="int8", interpret=True, **small)
    p = st.init_pools()
    prev = st.init_prev()
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    ctx = np.zeros((2,), np.int32)
    rng = np.random.RandomState(11)
    emitted = []
    for stepno in range(4):
        host = rng.randint(0, 32, size=(2, 4)).astype(np.int32)
        n_new = np.full((2,), 4 if stepno == 0 else 1, np.int32)
        use_host = np.ones((2,), bool)
        r = st(*p, prev, host, use_host, ctx, n_new, tables)
        p, tok = r[:4], r[4]
        ctx = ctx + n_new
        prev = tok
        emitted.append(np.asarray(tok).tolist())
    return emitted, [np.asarray(a) for a in p]


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_equivalence_lane_matches_reference_lane(kernel):
    want_toks, want_pools = _ref_lane(kernel)
    toks, pools = port.paged_attn_equiv_lane("torch", "cpu")
    assert toks == want_toks
    assert len(set(map(tuple, toks))) > 1, "a constant stream proves nothing"
    (kp, ks, vp, vs), (rkp, rks, rvp, rvs) = pools, want_pools
    assert kp.dtype == vp.dtype == np.int8
    np.testing.assert_array_equal(kp, rkp)
    np.testing.assert_array_equal(vp, rvp)
    assert np.any(kp != 0) and np.any(vp != 0)
    for a, b in ((ks, rks), (vs, rvs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=SCALE_ATOL)


def test_equivalence_lane_cuda_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        port.paged_attn_equiv_lane("cuda", "cpu")


def test_full_width_layouts_keep_the_section_keys():
    """Section 11 and 14 at the shapes the card's smoke run hands them,
    cut to a narrow width: blocks of 16 with the steady plan's half-full
    table, and section 14 at blocks of 16 with 48-token prompts. The
    residency keys follow the layout handed in."""
    _, base = _run("paged_attn_bench")
    dims = dict(slots=2, vocab=64, d=16, heads=2, block_size=16,
                num_blocks=64, max_blocks_per_req=8, chunk=16, seed=0)
    got = port.paged_attn_bench(_quiet, iters=1, repeats=1, dims=dims,
                                **CPU)
    assert set(got) == set(base)
    assert got["serving_kv_bytes_per_slot"] == 8 * 2 * (16 * 16 + 4)
    _, base = _run("sharded_kv_scaling")
    dims = dict(slots=2, vocab=64, d=16, heads=2, block_size=16,
                num_blocks=64, max_blocks_per_req=8, prefill_chunk=8,
                seed=0)
    got = port.sharded_kv_scaling(_quiet, n_req=2, toks=2, repeats=1,
                                  dims=dims, prompt_len=48, **CPU)
    assert set(got) == set(base)


def test_main_without_a_card_exits_2_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "dpu_operator_tpu_torch.serving.bench_serving"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert res.stdout == ""
    assert "--device cpu" in res.stderr


# main's sections besides 1-4, in the reference's order, with their error
# keys; the last four are skipped by --skip-local.
STUBBED = (("fault_recovery", "serving_fault_error"),
           ("kv_paged_serving", "serving_kv_error"),
           ("sharded_decode", "serving_sharded_error"),
           ("sharded_trace_overhead", "serving_sharded_trace_error"),
           ("disagg_serving", "serving_disagg_error"),
           ("speculative_decode", "serving_spec_error"),
           ("pipelined_speculative_decode", "serving_pspec_error"),
           ("cluster_prefix", "serving_cluster_prefix_error"),
           ("multi_tenant_qos", "serving_qos_error"),
           ("decode_loop_rates", "serving_decode_error"),
           ("trace_overhead", "serving_trace_error"),
           ("paged_attn_bench", "serving_paged_attn_error"),
           ("sharded_kv_scaling", "serving_shard_kv_error"))
LOCAL = ("decode_loop_rates", "trace_overhead", "paged_attn_bench",
         "sharded_kv_scaling")
SMALL_MAIN = ["--slots", "2", "--step-ms", "0.5", "--clients", "2",
              "--per-client", "1", "--max-tokens", "2",
              "--overload-seconds", "0.2", "--overload-deadline-ms", "500"]


def _stub(monkeypatch, module, calls, fail=None):
    for name, _ in STUBBED:
        def fn(*a, _name=name, **kw):
            calls.append((_name, kw.get("device")))
            if _name == fail:
                raise RuntimeError(f"{_name}: injected")
            return {f"stub_{_name}": 1}
        monkeypatch.setattr(module, name, fn)


def _main(module, argv, capsys):
    capsys.readouterr()
    rc = module.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_main_own_sections_keys_match_reference(monkeypatch, capsys):
    """Sections 1-4 run for real (section 4's model on the CPU in both
    packages); every other section is stubbed."""
    calls_ref, calls_port = [], []
    _stub(monkeypatch, ref, calls_ref)
    _stub(monkeypatch, port, calls_port)
    rc_ref, want = _main(ref, SMALL_MAIN, capsys)
    rc, got = _main(port, SMALL_MAIN + ["--device", "cpu"], capsys)
    _runs["main"] = (want, got)
    assert rc_ref == 0 and rc == 0
    assert set(got) == set(want)
    assert "serving_local_reqs_per_s" in got
    assert [n for n, _ in calls_port] == [n for n, _ in calls_ref] == \
        [n for n, _ in STUBBED]
    takes_device = {"sharded_decode", "sharded_trace_overhead", *LOCAL}
    for name, device in calls_port:
        assert device == ("cpu" if name in takes_device else None), name


@pytest.mark.parametrize("fail", ["fault_recovery", "paged_attn_bench"])
def test_main_prints_the_error_key_and_returns_1(monkeypatch, capsys, fail):
    """A host section fails in a ``--skip-local`` run (which calls no
    model section), a model section in a whole one."""
    calls = []
    _stub(monkeypatch, port, calls, fail=fail)
    skip = fail not in LOCAL
    argv = SMALL_MAIN + ["--device", "cpu"] + (["--skip-local"] if skip
                                               else [])
    rc, got = _main(port, argv, capsys)
    err = dict(STUBBED)[fail]
    assert rc == 1
    assert got[err] == f"{fail}: injected"
    assert [k for k in got if k.endswith("_error")] == [err]
    # The other sections' numbers still stand.
    called = [n for n, _ in calls]
    assert called == [n for n, _ in STUBBED if not (skip and n in LOCAL)]
    assert all(f"stub_{n}" in got for n in called if n != fail)
    assert any(k.startswith("serving_local_") for k in got) != skip


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_stop_in_the_retire_window_leaves_no_step_in_flight(pkg):
    """Section 14 asserts ``outstanding() == 0`` right after its
    batcher's ``stop()``. A stop that lands between the retire settling
    the last request and the pipelined loop's next check used to end the
    loop with the step submitted after that retire uncollected (seen in
    about one section run in ten under a loaded CPU). Forced here: the
    stop is set inside that window. The port's batcher collects the step
    on its way out; the reference's, whose loop is unchanged, leaves it
    in flight, which shows the forcing bites."""
    if pkg == "port":
        from dpu_operator_tpu_torch.serving import (
            AdmissionQueue, ContinuousBatcher, GenerateRequest,
            ShardedPagedKVExecutor)
        kw = CPU
    else:
        from dpu_operator_tpu.serving import (
            AdmissionQueue, ContinuousBatcher, GenerateRequest)
        from dpu_operator_tpu.serving.kvcache.sharded import (
            ShardedPagedKVExecutor)
        kw = {}
    import time

    ex = ShardedPagedKVExecutor(
        world=2, shard_axis="page", mode="pipelined", slots=2, vocab=32,
        d=16, heads=2, block_size=4, num_blocks=64, max_blocks_per_req=8,
        prefill_chunk=8, seed=0, **kw)
    q = AdmissionQueue(max_depth=4)
    b = ContinuousBatcher(ex, q)
    reqs = [GenerateRequest(prompt_vec=None, max_tokens=3,
                            deadline=time.monotonic() + 120,
                            prompt_tokens=[(5 * i + j) % 32
                                           for j in range(12)])
            for i in range(2)]
    retire = b._collect_retire_kv
    forced = []

    def retire_then_stop(submitted):
        t = retire(submitted)
        if not forced and all(r.done for r in reqs):
            forced.append(True)
            b._stop.set()
        return t

    b._collect_retire_kv = retire_then_stop
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        assert all(r.wait(timeout=120) for r in reqs)
        b._thread.join(timeout=60)
        assert not b._thread.is_alive() and forced
        assert all(r.error is None and len(r.tokens) == 3 for r in reqs)
        ex.allocator.assert_clean()
        assert ex.shards.outstanding() == (0 if pkg == "port" else 1)
    finally:
        b.stop()
        ex.close()


def test_chip_smoke_bench_keys_hold_every_reference_key_seen_here():
    """``chip_smoke.py`` phase 21 holds the bench's output on the card to
    the reference's 113 CPU keys, renamed, plus the cuda arm's time. Every
    key the reference's rewritten sections and ``main``'s own sections
    print here is in that list, by its reference name, and the renames
    are the port's."""
    import chip_smoke

    keys = set(chip_smoke.BENCH_REF_CPU_KEYS)
    assert len(keys) == len(chip_smoke.BENCH_REF_CPU_KEYS) == 113
    assert chip_smoke.BENCH_RENAMES == RENAMES
    assert chip_smoke.BENCH_CARD_KEYS == (
        _renamed(keys) | {"serving_paged_attn_cuda_ms"})
    assert len(chip_smoke.BENCH_CARD_KEYS) == 114
    for name in SECTIONS:
        assert set(_run(name)[0]) <= keys, name
    if "main" in _runs:
        own = {k for k in _runs["main"][0] if not k.startswith("stub_")}
        assert own and own <= keys
    _, paged = _run("paged_attn_bench")
    _, shard = _run("sharded_kv_scaling")
    for key, want in chip_smoke.BENCH_ARITHMETIC.items():
        assert (paged if key in paged else shard)[key] == want, key
