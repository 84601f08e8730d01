"""The port's ``PagedDecodeStep`` against the JAX package's, step by step.

Two executors, one of each package, are driven in lock step over the same
prompts: the reference ``PagedKVExecutor(kernel="xla")`` and the port's
``PagedKVExecutor(device="cpu")`` (its plain attention). Both plan every
step with the same host plane, so each step's inputs are the same; after
each step the collected tokens, the resident pools and the per-block
scales are compared.

Bars:
  * tokens exact, every step;
  * int8 codes exact (the divide is IEEE, the rounding half to even);
  * fp32 pool rows and int8 scales within 1e-6 absolute: the q/k/v
    projections are float32 matmuls in two libraries, whose sums may
    differ in the last bit.

Shapes: the reference's own paged-attention test widths
(``tests/test_paged_attn.py``) and a larger one (d=32, 4 slots, prompts
of 5-30 tokens, 20 tokens out).
"""

import time

import numpy as np
import pytest
import torch

from dpu_operator_tpu.serving import GenerateRequest as RefRequest
from dpu_operator_tpu.serving import PagedKVExecutor as RefExecutor
from dpu_operator_tpu.serving.kvcache.paged import (
    build_paged_params as ref_build_params)
from dpu_operator_tpu.serving.kvcache.paged import (
    kv_bytes_per_slot as ref_kv_bytes_per_slot)
from dpu_operator_tpu_torch.serving import GenerateRequest, PagedKVExecutor
from dpu_operator_tpu_torch.serving.kvcache.paged import (
    PARAM_NAMES, PagedDecodeStep, build_paged_params, kv_bytes_per_slot,
    paged_kv_error_bound, params_from_numpy)

torch.set_num_threads(1)

SMALL = dict(slots=2, vocab=16, d=8, heads=2, block_size=4,
             num_blocks=32, max_blocks_per_req=4, prefill_chunk=4, seed=0)
SMALL_PROMPTS = [[1, 2, 3, 4, 5, 6], [7, 8, 9]]

LARGE = dict(slots=4, vocab=64, d=32, heads=4, block_size=4,
             num_blocks=128, max_blocks_per_req=16, prefill_chunk=8,
             seed=3)
_rng = np.random.RandomState(7)
LARGE_PROMPTS = [_rng.randint(0, 64, n).tolist() for n in (5, 30, 17, 11)]

SHAPES = {"small": (SMALL, SMALL_PROMPTS, 4),
          "large": (LARGE, LARGE_PROMPTS, 20)}
FLOAT_ATOL = 1e-6


def _attach(ex, req_cls, prompts, max_tokens):
    reqs = [req_cls(prompt_vec=None, max_tokens=max_tokens,
                    deadline=time.monotonic() + 120,
                    prompt_tokens=list(p)) for p in prompts]
    for s, r in enumerate(reqs):
        ex.kv_attach(s, r)
    return reqs


def _check_pools(ref, port, pool_dtype, step):
    for name in ("_kpool", "_vpool"):
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).numpy()
        if pool_dtype == "int8":
            np.testing.assert_array_equal(b, a, err_msg=f"{name} step {step}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f"{name} step {step}")
    for name in ("_kscale", "_vscale"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=FLOAT_ATOL,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_step_matches_reference_step_by_step(shape, pool_dtype):
    dims, prompts, max_tokens = SHAPES[shape]
    ref = RefExecutor(**dims, kernel="xla", pool_dtype=pool_dtype,
                      mode="sync")
    port = PagedKVExecutor(**dims, pool_dtype=pool_dtype, mode="sync",
                           device="cpu")
    ref_reqs = _attach(ref, RefRequest, prompts, max_tokens)
    port_reqs = _attach(port, GenerateRequest, prompts, max_tokens)
    steps = 0
    while not all(len(r.tokens) >= max_tokens for r in port_reqs):
        steps += 1
        assert steps < 500, "decode never finished"
        t_ref = ref.collect(ref.submit((), gen=ref.kv_gen()))
        t_port = port.collect(port.submit((), gen=port.kv_gen()))
        np.testing.assert_array_equal(t_port, t_ref, err_msg=f"step {steps}")
        _check_pools(ref, port, pool_dtype, steps)
        for reqs, toks in ((ref_reqs, t_ref), (port_reqs, t_port)):
            for s, r in enumerate(reqs):
                if toks[s] >= 0 and len(r.tokens) < max_tokens:
                    r.tokens.append(int(toks[s]))
    streams = [list(r.tokens) for r in port_reqs]
    assert streams == [list(r.tokens) for r in ref_reqs]
    assert any(len(set(s)) > 1 for s in streams), \
        "degenerate streams would make the equality vacuous"
    for ex, reqs in ((ref, ref_reqs), (port, port_reqs)):
        for s, r in enumerate(reqs):
            ex.kv_release_slot(s, cache=False)
            r.finish()
        ex.allocator.assert_clean()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_build_paged_params_bitwise_equal_to_reference(shape):
    dims = SHAPES[shape][0]
    args = (dims["seed"], dims["vocab"], dims["d"],
            dims["max_blocks_per_req"] * dims["block_size"])
    ref = ref_build_params(*args)
    port = build_paged_params(*args)
    assert list(port) == list(PARAM_NAMES) == list(ref)
    for k in PARAM_NAMES:
        a = np.asarray(ref[k])
        assert port[k].dtype == np.float32 and port[k].shape == a.shape
        np.testing.assert_array_equal(port[k], a, err_msg=k)


def test_params_from_numpy_gives_the_seeded_weights():
    """A step built from the reference's arrays holds exactly the weights
    the same seed draws in the port."""
    dims = dict(SMALL)
    seed = dims.pop("seed")
    chunk = dims.pop("prefill_chunk")
    ref = ref_build_params(seed, dims["vocab"], dims["d"],
                           dims["max_blocks_per_req"] * dims["block_size"])
    given = params_from_numpy({k: np.asarray(v) for k, v in ref.items()},
                              "cpu")
    a = PagedDecodeStep(**dims, chunk=chunk, params=given, device="cpu")
    b = PagedDecodeStep(**dims, chunk=chunk, seed=seed, device="cpu")
    for k in PARAM_NAMES:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_kernel_selection_rules():
    dims = dict(SMALL)
    dims.pop("seed")
    chunk = dims.pop("prefill_chunk")
    assert PagedDecodeStep(**dims, chunk=chunk, device="cpu").kernel == \
        "torch"
    if torch.cuda.is_available():
        step = PagedDecodeStep(**dims, chunk=chunk)
        assert step.device.type == "cuda" and step.kernel == "cuda"
    else:
        # No device given means the card: with none, it raises rather
        # than run on the CPU.
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedDecodeStep(**dims, chunk=chunk)
    with pytest.raises(ValueError, match="CUDA"):
        PagedDecodeStep(**dims, chunk=chunk, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        PagedDecodeStep(**dims, chunk=chunk, kernel="pallas", device="cpu")


def _decode(ex, prompts, max_tokens):
    reqs = _attach(ex, GenerateRequest, prompts, max_tokens)
    while not all(len(r.tokens) >= max_tokens for r in reqs):
        toks = ex.collect(ex.submit((), gen=ex.kv_gen()))
        for s, r in enumerate(reqs):
            if toks[s] >= 0 and len(r.tokens) < max_tokens:
                r.tokens.append(int(toks[s]))
    blocks = [list(r.kv_lease.blocks) for r in reqs]
    for s, r in enumerate(reqs):
        ex.kv_release_slot(s, cache=False)
        r.finish()
    ex.allocator.assert_clean()
    return [list(r.tokens) for r in reqs], blocks


def test_int8_residency_error_bounded_and_streams_match_fp32():
    """The reference's int8 quality lane on the port: the dequantized
    int8 pools (the host view, ``dequantized_pools``) sit within the
    documented ``paged_kv_error_bound`` of the fp32-resident truth in
    every written block, and the streams agree."""
    dims, prompts, max_tokens = SHAPES["large"]
    ex_f = PagedKVExecutor(**dims, pool_dtype="fp32", mode="sync",
                           device="cpu")
    ex_q = PagedKVExecutor(**dims, pool_dtype="int8", mode="sync",
                           device="cpu")
    streams_f, blocks_f = _decode(ex_f, prompts, max_tokens)
    streams_q, blocks_q = _decode(ex_q, prompts, max_tokens)
    assert blocks_q == blocks_f and streams_q == streams_f
    kq, vq = ex_q._paged.dequantized_pools(ex_q._kpool, ex_q._kscale,
                                           ex_q._vpool, ex_q._vscale)
    checked = 0
    for deq, ref, scales in ((kq, ex_f._kpool.numpy(), ex_q._kscale),
                             (vq, ex_f._vpool.numpy(), ex_q._vscale)):
        for b in sorted({b for bl in blocks_f for b in bl}):
            err = float(np.max(np.abs(deq[b] - ref[b])))
            bound = paged_kv_error_bound(float(scales[b]),
                                         float(np.max(np.abs(ref[b]))))
            assert err <= bound + 1e-6, (b, err, bound)
            checked += 1
    assert checked >= 16


def test_kv_bytes_per_slot_equals_reference():
    for args in ((4, 4, 2, 4), (256, 16, 32, 128)):
        for pool_dtype in ("int8", "fp32"):
            assert kv_bytes_per_slot(*args, pool_dtype) == \
                ref_kv_bytes_per_slot(*args, pool_dtype)
