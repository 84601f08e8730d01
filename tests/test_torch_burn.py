"""The port's health burn against the JAX package's.

The same seeded numpy inputs, rounded to bf16 by JAX and carried over as
float32 (exact for bf16 values), go through the reference's Pallas burn
kernels (in interpret mode, as its own CPU tests run them) or its jnp
``burn_step``, and through the port's plain PyTorch versions, which are
what its kernel wrappers run for tensors on the CPU.

Bars, in bf16 ulps (``burn.bf16_ulps``: the ulp at the larger magnitude,
at 2**-5 where both are smaller, since below it the two f32 sums' order
alone moves a value by more than its own ulp):
  * one burn step: at most 1 ulp. Both sum f32 products, in another
    order, then take an f32 tanh and round once to bf16, so a value
    near a rounding boundary may land on either side;
  * the 8-step chain: at most 2**-7 absolute (2 ulps at the top of
    tanh's range), and at most 10 % of elements differing. A flip at one
    step reaches the next step's inputs as an absolute perturbation, so
    after the first step the error is absolute, not relative. Measured at
    256^2, seed 0: 2**-9 (one ulp in [0.25, 0.5)), 2.8 % differing;
  * the f32 signature sum(h**2): relative 1e-4. Its per-element flips
    have random signs and mostly cancel in the sum; the jnp burn, which
    rounds twice per step, stays within it too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpu_operator_tpu.parallel import fabric_probe as ref_probe
from dpu_operator_tpu.parallel import pallas_burn as ref_burn
from dpu_operator_tpu_torch.parallel import burn, fabric_probe

torch.set_num_threads(1)

STEP_ULPS = 1.0
CHAIN_ATOL = 2.0 ** -7
CHAIN_DIFFER_SHARE = 0.10
SIG_RTOL = 1e-4


def _inputs(m, n, seed, w_scale=0.05):
    """x [m, n] and w [n, n] as float32 arrays holding bf16 values (the
    reference's rounding), for both packages."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, n).astype(np.float32)
    w = (rng.randn(n, n) * w_scale).astype(np.float32)
    return tuple(np.array(jnp.asarray(a).astype(jnp.bfloat16)
                            .astype(jnp.float32)) for a in (x, w))


def _jax(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _port(x, w):
    return fabric_probe.burn_args_from_numpy(x, w, device="cpu")


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("length", [1, 8])
def test_chain_plain_matches_pallas_chain(length, seed):
    x, w = _inputs(256, 256, seed)
    want = np.asarray(ref_burn.burn_chain_pallas(
        _jax(x), _jax(w), length=length, interpret=True)
        .astype(jnp.float32))
    got = burn.burn_chain_plain(*_port(x, w), length=length)
    assert got.dtype == torch.bfloat16 and got.shape == (256, 256)
    want_t = torch.from_numpy(np.array(want))
    if length == 1:
        assert burn.bf16_ulps(got, want_t) <= STEP_ULPS
    else:
        assert float((got.float() - want_t).abs().max()) <= CHAIN_ATOL
    differ = float((got.float() != want_t).float().mean())
    assert differ <= CHAIN_DIFFER_SHARE
    # the chain really ran: h moved away from x
    assert not torch.equal(got.float(), torch.from_numpy(x))


def test_chain_wrapper_runs_plain_version_on_cpu_tensors():
    x, w = _port(*_inputs(256, 256, 0))
    before = burn.burn_chain.launches
    assert torch.equal(burn.burn_chain(x, w, length=3),
                       burn.burn_chain_plain(x, w, length=3))
    assert burn.burn_chain.launches == before


def test_tile_wrapper_runs_plain_version_on_cpu_tensors():
    x, w = _port(*_inputs(256, 128, 0))
    before = burn.burn_tile.launches
    out = burn.burn_tile(x, w)
    assert out.shape == (256, 128) and out.dtype == torch.bfloat16
    assert torch.equal(out, burn.burn_tile_plain(x, w))
    assert burn.burn_tile.launches == before


def _spy(monkeypatch, name):
    """Count the calls ``burn_step_kernel`` makes to ``burn.<name>``."""
    calls = []
    real = getattr(burn, name)

    def spy(*args, **kw):
        calls.append(kw.get("length", 1))
        return real(*args, **kw)

    monkeypatch.setattr(burn, name, spy)
    return calls


@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_branch_matches_pallas_burn_step(seed, monkeypatch):
    """x 256x128 against square w 128x128: m != n, so both packages take
    the tiled branch, eight one-step launches."""
    x, w = _inputs(256, 128, seed)
    tiles, chains = _spy(monkeypatch, "burn_tile"), _spy(monkeypatch,
                                                         "burn_chain")
    want = float(ref_burn.burn_step_pallas(_jax(x), _jax(w),
                                           interpret=True))
    got = burn.burn_step_kernel(*_port(x, w))
    assert len(tiles) == 8 and not chains
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.isfinite(want) and _rel(float(got), want) <= SIG_RTOL


def test_chain_branch_matches_pallas_burn_step(monkeypatch):
    """Square and within the budget: one 8-step chain in both packages."""
    x, w = _inputs(256, 256, 2)
    tiles, chains = _spy(monkeypatch, "burn_tile"), _spy(monkeypatch,
                                                         "burn_chain")
    want = float(ref_burn.burn_step_pallas(_jax(x), _jax(w),
                                           interpret=True))
    got = float(burn.burn_step_kernel(*_port(x, w)))
    assert chains == [8] and not tiles
    assert _rel(got, want) <= SIG_RTOL


def test_chain_budget_is_the_references():
    for m, n in ((1024, 1024), (1152, 1152), (1280, 1280), (2048, 2048),
                 (256, 128)):
        assert burn.chain_fits(m, n) == ref_burn.chain_fits_vmem(m, n)


@pytest.mark.parametrize("n", [256, 1024])
def test_burn_step_matches_reference_jnp_burn(n):
    x, w = _inputs(n, n, 3)
    want = float(ref_probe.burn_step(_jax(x), _jax(w)))
    got = fabric_probe.burn_step(*_port(x, w))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _rel(float(got), want) <= SIG_RTOL


def test_best_burn_step_on_cpu_matches_reference_best_burn_step():
    """The slice as a whole: the burn each package picks on the CPU (the
    reference's is its jnp burn) gives the same signature."""
    x, w = _inputs(512, 512, 4)
    step = burn.best_burn_step(device="cpu")
    assert step is fabric_probe.burn_step
    want = float(ref_burn.best_burn_step()(_jax(x), _jax(w)))
    assert _rel(float(step(*_port(x, w))), want) <= SIG_RTOL


def test_example_args_give_a_finite_signature_on_cpu():
    x, w = fabric_probe.burn_example_args(device="cpu")
    assert x.shape == w.shape == (fabric_probe.BURN_DIM,) * 2
    assert x.dtype == w.dtype == torch.bfloat16
    x2, w2 = fabric_probe.burn_example_args(device="cpu")
    assert torch.equal(x, x2) and torch.equal(w, w2)  # seeded
    sig = burn.best_burn_step(device="cpu")(x, w)
    assert torch.isfinite(sig) and float(sig) > 0


def test_constants_are_the_references():
    for name in ("BLOCK_BATCH", "BLOCK_SEQ", "DIM", "HIDDEN", "BURN_DIM",
                 "LR"):
        assert getattr(fabric_probe, name) == getattr(ref_probe, name)


def test_burn_args_from_numpy_are_exact_for_bf16_values():
    x, w = _inputs(128, 128, 5)
    xt, wt = _port(x, w)
    assert xt.dtype == wt.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.float().numpy(), x)
    np.testing.assert_array_equal(wt.float().numpy(), w)


def test_device_rules():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    for call in (burn.best_burn_step, fabric_probe.burn_example_args):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
    x, w = _inputs(128, 128, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fabric_probe.burn_args_from_numpy(x, w)
    with pytest.raises(ValueError, match="no burn for device meta"):
        burn.best_burn_step(device="meta")


def test_wrappers_refuse_other_devices_and_bad_shapes():
    meta = torch.empty((256, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        burn.burn_tile(meta, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        burn.burn_chain(meta, meta)
    x, w = _port(*_inputs(256, 128, 0))
    with pytest.raises(ValueError, match="square"):
        burn.burn_chain(x, w)
    sq, _ = _port(*_inputs(128, 128, 0))
    with pytest.raises(ValueError, match="length"):
        burn.burn_chain(sq, sq, length=0)
    with pytest.raises(ValueError, match="tile-aligned"):
        burn.burn_step_kernel(torch.zeros(100, 128), torch.zeros(128, 128))
    with pytest.raises(ValueError, match="tile-aligned"):
        burn.burn_step_kernel(torch.zeros(128, 128), torch.zeros(64, 64))


def test_bf16_ulps():
    one = torch.tensor([1.0, -0.75, 0.001], dtype=torch.bfloat16)
    assert burn.bf16_ulps(one, one) == 0.0
    up = torch.tensor([1.0 + 2.0 ** -7, -0.75, 0.001],
                      dtype=torch.bfloat16)
    assert burn.bf16_ulps(up, one) == 1.0
    # below the floor the ulp at 2**-5 (2**-12) is the unit
    tiny = torch.tensor([1.0, -0.75, 0.001 + 2.0 ** -12],
                        dtype=torch.bfloat16)
    assert 0.5 <= burn.bf16_ulps(tiny, one) <= 1.5
