"""The port's benchmark matmul and microbench plumbing against the JAX
package's.

``pallas_matmul``'s plain version (what the port's wrappers run for
tensors on the CPU) is held against the reference's ``pallas_matmul`` in
interpret mode, on both of its routes: ``bk == K`` (the full-K kernel)
and ``bk < K`` (the K-blocked kernel with its f32 accumulator). Inputs
are seeded numpy, rounded to bf16 by JAX and carried over as float32.

Bar: at most 1 bf16 ulp (``burn.bf16_ulps``, the ulp at the larger
magnitude, at 2**-5 where both are smaller). Both sum exact f32 products
in f32, in another order (the reference by K blocks), and round once to
bf16, so a value near a rounding boundary may land on either side.

The timing functions run here only to check their plumbing, at toy
sizes on an explicitly requested CPU: their numbers are not device
metrics.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpu_operator_tpu.parallel import mxu_bench as ref_mxu
from dpu_operator_tpu_torch.parallel import bench_gpu, burn, mxu_bench
from dpu_operator_tpu_torch.parallel.fabric_probe import burn_args_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_ULPS = 1.0
M, K, N = 256, 512, 384


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    return tuple(np.array(jnp.asarray(a).astype(jnp.bfloat16)
                            .astype(jnp.float32)) for a in (x, w))


def _reference(x, w, bm, bn, bk):
    out = ref_mxu.pallas_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(w).astype(jnp.bfloat16),
                                bm=bm, bn=bn, bk=bk, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bk", [K, 128], ids=["full_k", "k_blocked"])
def test_plain_matches_pallas_matmul(bk, seed):
    x, w = _inputs(seed)
    want = _reference(x, w, 128, 128, bk)
    xt, wt = burn_args_from_numpy(x, w, device="cpu")
    got = mxu_bench.matmul_plain(xt, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert burn.bf16_ulps(got, want) <= STEP_ULPS


@pytest.mark.parametrize("bk", [K, 128], ids=["full_k", "k_blocked"])
def test_wrapper_runs_plain_version_on_cpu_tensors(bk):
    """Given CPU tensors, ``pallas_matmul`` runs the plain version on
    either route and counts no launch."""
    xt, wt = burn_args_from_numpy(*_inputs(0), device="cpu")
    before = (mxu_bench.mm_fullk.launches, mxu_bench.mm_kblocked.launches)
    got = mxu_bench.pallas_matmul(xt, wt, bm=128, bn=128, bk=bk)
    assert torch.equal(got, mxu_bench.matmul_plain(xt, wt))
    assert (mxu_bench.mm_fullk.launches,
            mxu_bench.mm_kblocked.launches) == before


@pytest.mark.parametrize("bk,route", [(K, "mm_fullk"), (256, "mm_kblocked"),
                                      (128, "mm_kblocked")])
def test_route_follows_the_number_of_k_blocks(bk, route, monkeypatch):
    calls = []
    monkeypatch.setattr(mxu_bench, route,
                        lambda x, w: calls.append(route) or x @ w)
    xt, wt = burn_args_from_numpy(*_inputs(0), device="cpu")
    mxu_bench.pallas_matmul(xt, wt, bm=128, bn=128, bk=bk)
    assert calls == [route]


@pytest.mark.parametrize("k_rows,blocks", [
    (K, (100, 128, 128)), (K, (128, 100, 128)), (K, (128, 128, 100)),
    (K, (512, 128, 128)), (256, (128, 128, 128))])
def test_blocks_must_divide_the_shapes(k_rows, blocks):
    """Blocks that do not divide m, n or k, and a k that x and w do not
    share, are refused."""
    xt, wt = burn_args_from_numpy(*_inputs(0), device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        mxu_bench.pallas_matmul(xt, wt[:k_rows], *blocks)


def test_kernel_wrappers_refuse_other_devices_and_shapes():
    meta = torch.empty((256, 256), dtype=torch.bfloat16, device="meta")
    for fn in (mxu_bench.mm_fullk, mxu_bench.mm_kblocked):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(meta, meta)


def test_measure_functions_run_on_an_explicit_cpu():
    mm = lambda x, w: mxu_bench.pallas_matmul(x, w, 128, 128, 128)  # noqa
    r = mxu_bench.measure_matmul_tflops(mm, n=128, l_short=1, l_long=3,
                                        reps=1, device="cpu")
    assert set(r) == {"n", "seconds_per_matmul", "tflops",
                      "utilization_vs_peak", "device"}
    assert r["device"] == "cpu" and r["tflops"] > 0
    h = mxu_bench.measure_hbm_gbps(mbytes=1, l_short=1, l_long=3, reps=1,
                                   device="cpu")
    assert set(h) == {"mbytes", "seconds_per_pass", "gbps",
                      "utilization_vs_peak", "device"}
    assert h["device"] == "cpu" and h["gbps"] > 0
    cfg, res = mxu_bench.best_pallas_config(
        n=256, configs=((128, 128, 256), (128, 128, 128), (512, 512, 512)),
        reps=1, device="cpu")
    assert cfg in ((128, 128, 256), (128, 128, 128)) and res["n"] == 256
    with pytest.raises(RuntimeError, match="no block config"):
        mxu_bench.best_pallas_config(n=256, configs=((512, 512, 512),),
                                     device="cpu")


def test_chained_runs_l_dependent_matmuls():
    calls = []

    def mm(h, w):
        calls.append(1)
        return h + w

    run = mxu_bench._chained(mm, 5)
    out = run(torch.zeros(2, 2, dtype=torch.bfloat16),
              torch.ones(2, 2, dtype=torch.bfloat16))
    assert len(calls) == 5 and float(out) == 20.0


def test_measurements_want_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mxu_bench.measure_matmul_tflops(torch.matmul, n=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mxu_bench.measure_hbm_gbps(mbytes=1)


def test_peaks_are_the_h100s():
    assert mxu_bench.H100_PEAK_BF16_TFLOPS == 989.0
    assert mxu_bench.H100_PEAK_HBM_GBPS == 3350.0


def test_record_keeps_median_and_minmax():
    out = {}
    bench_gpu._record(out, "x_tflops", [3.04, 1.01, 2.06])
    assert out == {"x_tflops": 2.1, "x_tflops_minmax": [1.0, 3.0]}
    assert bench_gpu._runs(lambda: 7, n=3) == [7, 7, 7]


def test_bench_gpu_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench measures it")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "dpu_operator_tpu_torch.parallel.bench_gpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
