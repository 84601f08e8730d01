"""The port's ring attention against the JAX package's.

The same seeded numpy inputs go through the reference's
``make_ring_attention`` on the 8-device virtual CPU mesh (its XLA path
in-process; its Pallas kernel in interpret mode in a subprocess, as the
reference's own tests run it) and through the port's plain version,
which is what ``ring_attention_cuda`` runs for tensors on the CPU.

Bars:
  * f32: ``rtol=atol=2e-5``, the reference's own bar between its ring
    and a dense softmax (``tests/test_ring_attention.py``). Port and
    reference fold the same blocks in the same order; they differ by
    float reassociation inside the products and sums only;
  * bf16 against the f32 dense reference: the reference's own bf16 bar,
    ``rtol=0.1, atol=0.06`` (q and k rounded to bf16 move the scores);
  * bf16 port against bf16 reference: at most 1 bf16 ulp, both rounding
    the same f32 value, up to reassociation, once.

The kernel's own arithmetic (products on TF32 tensor cores, each operand
split into hi + lo) is written out in ``tf32_split`` /
``split_matmul`` / ``ring_attention_split``; those are held here to the
same bars, and to the card's smoke run's f32 bar (``RING_RTOL`` /
``RING_ATOL``), which one TF32 pass must miss.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpu_operator_tpu.parallel.ring_attention import (
    make_ring_attention as ref_make_ring_attention)
from dpu_operator_tpu_torch.parallel import burn
from dpu_operator_tpu_torch.parallel import ring_attention as ra
from dpu_operator_tpu_torch.parallel.ring_probe import _ring_ids
from chip_smoke import RING_ATOL, RING_Q_SCALE, RING_RTOL
from virtual_mesh import REPO, run_virtual

torch.set_num_threads(1)

TOL = 2e-5
BF16_RTOL, BF16_ATOL = 0.1, 0.06
MESHES = ((1, 8, 1), (2, 4, 1), (1, 2, 4))
AXES = ("dp", "sp", "tp")


def _inputs(S, dk, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(S, dk).astype(np.float32),
            rng.randn(S, dk).astype(np.float32),
            rng.randn(S, dv).astype(np.float32))


def _dense(q, k, v, causal):
    s = (q.astype(np.float32) @ k.astype(np.float32).T) / np.sqrt(q.shape[1])
    if causal:
        sq, sk = s.shape
        mask = np.arange(sk)[None, :] <= np.arange(sq)[:, None]
        s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v.astype(np.float32)


def _reference(shape, q, k, v, causal, dtype=jnp.float32):
    """The reference's XLA ring on the virtual mesh of ``shape``."""
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axis_names=AXES)
    sh = NamedSharding(mesh, P("sp", None))
    args = [jax.device_put(jnp.asarray(a).astype(dtype), sh)
            for a in (q, k, v)]
    fn = ref_make_ring_attention(mesh, "sp", causal=causal, use_pallas=False)
    return np.array(fn(*args).astype(jnp.float32))


def _port(shape, q, k, v, causal, dtype=torch.float32):
    fn = ra.make_ring_attention(dict(zip(AXES, shape)), "sp", causal,
                                device="cpu")
    return fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_plain_matches_reference_xla_ring(shape, causal):
    n = shape[1]
    q, k, v = _inputs(4 * n, 16, 8, seed=n)
    got = _port(shape, q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == (4 * n, 8)
    np.testing.assert_allclose(got.numpy(), _reference(shape, q, k, v, causal),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plain_matches_dense(n, causal):
    q, k, v = _inputs(4 * n, 16, 8, seed=10 + n)
    got = _port((1, n, 1), q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), _dense(q, k, v, causal),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_wide_shards_match_reference(causal):
    """S = 256 over 8 ranks, dk = dv = 32: 32-row shards, so the
    cross-shard mask cuts inside and between many rows."""
    q, k, v = _inputs(256, 32, 32, seed=7)
    got = _port((1, 8, 1), q, k, v, causal).numpy()
    np.testing.assert_allclose(got, _reference((1, 8, 1), q, k, v, causal),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bf16_matches_reference(causal):
    q, k, v = _inputs(32, 16, 8, seed=3)
    got = _port((1, 8, 1), q, k, v, causal, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _dense(q, k, v, causal),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    want = torch.from_numpy(_reference((1, 8, 1), q, k, v, causal,
                                       dtype=jnp.bfloat16))
    assert burn.bf16_ulps(got, want.to(torch.bfloat16)) <= 1.0


def test_plain_matches_pallas_kernel_in_interpret_mode(tmp_path):
    """The reference's Pallas ring kernel, executed in interpret mode on
    the 8-wide ring (the widest skew the credit protocol absorbs), gives
    the port's plain version's output."""
    q, k, v = _inputs(32, 16, 8, seed=5)
    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    np.savez(src, q=q, k=k, v=v)
    r = run_virtual(
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, jax, jax.numpy as jnp\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "from jax.experimental.pallas import tpu as pltpu\n"
        "from dpu_operator_tpu.parallel.ring_attention import "
        "make_ring_attention\n"
        "a = np.load(%r)\n"
        "mesh = Mesh(np.array(jax.devices()).reshape(1, 8, 1),\n"
        "            axis_names=('dp', 'sp', 'tp'))\n"
        "sh = NamedSharding(mesh, P('sp', None))\n"
        "q, k, v = (jax.device_put(jnp.asarray(a[n]), sh) for n in 'qkv')\n"
        "out = {}\n"
        "with pltpu.force_tpu_interpret_mode():\n"
        "    for causal in (False, True):\n"
        "        fn = make_ring_attention(mesh, 'sp', causal=causal,\n"
        "                                 use_pallas=True)\n"
        "        out[str(causal)] = np.asarray(fn(q, k, v))\n"
        "np.savez(%r, **out)\n" % (REPO, str(src), str(dst)))
    assert r.returncode == 0, r.stdout + r.stderr
    ref = np.load(dst)
    for causal in (False, True):
        got = _port((1, 8, 1), q, k, v, causal).numpy()
        np.testing.assert_allclose(got, ref[str(causal)], rtol=TOL, atol=TOL)


def test_cuda_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(32, 16, 8, seed=9))
    before = ra.ring_attention_cuda.launches
    got = ra.ring_attention_cuda(q, k, v, 8, True)
    assert torch.equal(got, ra.ring_attention_plain(q, k, v, 8, True))
    assert ra.ring_attention_cuda.launches == before


def test_check_qkv_errors():
    q = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="k feature dim 3 != q feature dim 4"):
        ra._check_qkv(q, torch.zeros(8, 3), torch.zeros(8, 2))
    with pytest.raises(ValueError, match=r"k rows 8 != v rows 6 \(same shard\)"):
        ra._check_qkv(q, torch.zeros(8, 4), torch.zeros(6, 2))
    fn = ra.make_ring_attention({"sp": 2}, device="cpu")
    with pytest.raises(ValueError, match="k rows"):
        fn(q, torch.zeros(8, 4), torch.zeros(6, 2))
    with pytest.raises(ValueError, match="equal shards"):
        ra.make_ring_attention({"sp": 3}, device="cpu")(
            q, torch.zeros(8, 4), torch.zeros(8, 2))


def test_pack_kv_promotes_mixed_dtypes():
    k = torch.randn(4, 3).to(torch.bfloat16)
    v = torch.randn(4, 2)
    kv = ra._pack_kv(k, v)
    assert kv.dtype == torch.float32 and kv.shape == (4, 5)
    assert torch.equal(kv[:, :3], k.float()) and torch.equal(kv[:, 3:], v)
    both = ra._pack_kv(k, k[:, :2])
    assert both.dtype == torch.bfloat16


def test_mixed_dtype_ring_matches_reference():
    """bf16 k with f32 v circulates as f32, on both sides."""
    q, k, v = _inputs(16, 16, 8, seed=4)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4, 2), axis_names=AXES)
    sh = NamedSharding(mesh, P("sp", None))
    args = [jax.device_put(jnp.asarray(a).astype(t), sh)
            for a, t in ((q, jnp.float32), (k, jnp.bfloat16),
                         (v, jnp.float32))]
    want = np.asarray(ref_make_ring_attention(
        mesh, "sp", causal=True, use_pallas=False)(*args))
    fn = ra.make_ring_attention({"dp": 1, "sp": 4, "tp": 2}, causal=True,
                                device="cpu")
    got = fn(torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
             torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_kernel_and_device_selection():
    with pytest.raises(ValueError, match="CUDA"):
        ra.make_ring_attention({"sp": 2}, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        ra.make_ring_attention({"sp": 2}, kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="axis"):
        ra.make_ring_attention({"dp": 2}, device="cpu")
    fn = ra.make_ring_attention({"sp": 2}, kernel="torch", device="cpu")
    assert fn(*(torch.zeros(4, 2) for _ in range(3))).shape == (4, 2)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ra.make_ring_attention({"sp": 2})


@pytest.mark.parametrize("n", [1, 2, 8])
def test_ring_ids(n):
    names = ("dp", "sp", "tp")
    for rank in range(n):
        my_id, right, left = _ring_ids("sp", n, names, (1, rank, 3))
        assert my_id == rank
        assert right == (1, (rank + 1) % n, 3)
        assert left == (1, (rank - 1) % n, 3)
    with pytest.raises(ValueError):
        _ring_ids("sp", n, names, (0, n, 0))


# -- the kernel's arithmetic: TF32 split products ------------------------------

# Finite f32 values below the point where hi would round up to inf,
# subnormals included, and exact ties of the 13 bits that hi drops.
_F32_MAX = float(np.nextafter(np.float32(2.0 ** 128 - 2.0 ** 116),
                              np.float32(0)))
_F32 = st.floats(min_value=-_F32_MAX, max_value=_F32_MAX, width=32,
                 allow_nan=False, allow_infinity=False)
_TIES = st.tuples(st.integers(0, 1), st.integers(0, 253),
                  st.integers(0, 1023)).map(
    lambda t: np.array([(t[0] << 31) | (t[1] << 23) | (t[2] << 13) | 0x1000],
                       dtype=np.uint32).view(np.float32)[0].item())
_VALUES = st.lists(st.one_of(_F32, _TIES), min_size=1, max_size=64)


def _f32(values):
    return torch.tensor(values, dtype=torch.float32)


@settings(max_examples=200, deadline=None)
@given(_VALUES)
def test_tf32_split_hi_has_ten_mantissa_bits(values):
    hi, lo = ra.tf32_split(_f32(values))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()


@settings(max_examples=200, deadline=None)
@given(_VALUES)
def test_tf32_split_reconstructs_x(values):
    """hi + lo is x within 2**-22 of |x|; where x - hi is subnormal, lo
    rounds on the subnormal grid, so within 2**-137."""
    x = _f32(values)
    hi, lo = ra.tf32_split(x)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -22 + 2.0 ** -137).all()


@settings(max_examples=200, deadline=None)
@given(_TIES)
def test_tf32_split_rounds_ties_away_from_zero(tie):
    x = _f32([tie])
    hi, _ = ra.tf32_split(x)
    assert hi.abs().item() > x.abs().item()
    assert (hi.abs() - x.abs()).item() == (x.abs() - (x.abs().view(
        torch.int32) & ~0x1FFF).view(torch.float32)).item()


@settings(max_examples=200, deadline=None)
@given(_VALUES)
def test_tf32_split_of_bf16_has_no_lo(values):
    x = _f32(values).to(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    hi, lo = ra.tf32_split(x)
    assert torch.equal(hi, x) and not lo.any()


def _split_bound(a, b):
    """The split product's error bound: the dropped lo.lo and the two
    residuals, < 2**-20 of each |a_i b_i|, and f32 sums over the d terms
    of three passes and two adds, (d + 2) 2**-24."""
    d = a.shape[1]
    return (2.0 ** -20 + (d + 2) * 2.0 ** -24) * (a.abs().double()
                                                  @ b.abs().double())


@pytest.mark.parametrize("S,d", [(4 * n, 16) for n in (1, 2, 4, 8)]
                         + [(256, 32), (256, 128)])
def test_split_matmul_within_f32_error(S, d):
    """Three passes hold q . k and p . v at the tier-1 shapes to f32's
    error bound against float64; one pass does not."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(S, d, d, seed=S + d))
    p = torch.softmax(q @ k.T / np.sqrt(d), dim=1)
    for a, b in ((q, k.T), (p, v)):
        exact = a.double() @ b.double()
        bound = _split_bound(a, b)
        got = ra.split_matmul(a, b, False, False)
        assert got.dtype == torch.float32
        assert ((got.double() - exact).abs() <= bound).all()
        one = ra.split_matmul(a, b, False, False, single=True)
        assert ((one.double() - exact).abs() > bound).any()


def test_split_matmul_drops_only_zero_passes_for_bf16():
    """The pass the rule drops for a bf16 operand is its lo times the
    other's hi, which is exactly zero: dropping it changes no bit."""
    q, k, _ = _inputs(64, 32, 8, seed=21)
    a = torch.from_numpy(q).to(torch.bfloat16).float()
    b = torch.from_numpy(k).T.contiguous()
    a_hi, a_lo = ra.tf32_split(a)
    b_hi, _ = ra.tf32_split(b)
    assert not (a_lo @ b_hi).any()
    assert torch.equal(ra.split_matmul(a, b, True, False),
                       ra.split_matmul(a, b, False, False))
    assert torch.equal(ra.split_matmul(b.T, a.T, False, True),
                       ra.split_matmul(b.T, a.T, False, False))
    b16 = b.to(torch.bfloat16).float()
    assert torch.equal(ra.split_matmul(a, b16, True, True),
                       ra.split_matmul(a, b16, False, False))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_split_ring_matches_reference_xla_ring(shape, causal):
    n = shape[1]
    q, k, v = _inputs(4 * n, 16, 8, seed=n)
    got = ra.ring_attention_split(*(torch.from_numpy(a) for a in (q, k, v)),
                                  n, causal)
    assert got.dtype == torch.float32 and got.shape == (4 * n, 8)
    np.testing.assert_allclose(got.numpy(), _reference(shape, q, k, v, causal),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,d", [(256, 32), (512, 144)])
def test_split_ring_wide_shards_match_reference(S, d, causal):
    """32- and 64-row shards cut into the kernel's key tiles (64 keys, 16
    where d exceeds 128), folded in turn."""
    q, k, v = _inputs(S, d, d, seed=7)
    got = ra.ring_attention_split(*(torch.from_numpy(a) for a in (q, k, v)),
                                  8, causal).numpy()
    np.testing.assert_allclose(got, _reference((1, 8, 1), q, k, v, causal),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_split_ring_bf16_matches_reference(causal):
    q, k, v = _inputs(32, 16, 8, seed=3)
    got = ra.ring_attention_split(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), 8,
        causal)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(_reference((1, 8, 1), q, k, v, causal,
                                       dtype=jnp.bfloat16))
    assert burn.bf16_ulps(got, want.to(torch.bfloat16)) <= 1.0


def test_split_ring_mixed_types_match_reference():
    """bf16 q and k with f32 v (K/V circulate as f32, 3 passes) and f32 q
    with bf16 K/V (2 passes each)."""
    q, k, v = _inputs(16, 16, 8, seed=4)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4, 2), axis_names=AXES)
    sh = NamedSharding(mesh, P("sp", None))
    for types in ((jnp.bfloat16, jnp.bfloat16, jnp.float32),
                  (jnp.float32, jnp.bfloat16, jnp.bfloat16)):
        args = [jax.device_put(jnp.asarray(a).astype(t), sh)
                for a, t in zip((q, k, v), types)]
        want = np.asarray(ref_make_ring_attention(
            mesh, "sp", causal=True, use_pallas=False)(*args).astype(
                jnp.float32))
        torch_types = [torch.bfloat16 if t == jnp.bfloat16 else torch.float32
                       for t in types]
        got = ra.ring_attention_split(
            *(torch.from_numpy(a).to(t) for a, t in zip((q, k, v),
                                                         torch_types)),
            4, True)
        if got.dtype == torch.bfloat16:
            assert burn.bf16_ulps(got, torch.tensor(want).to(
                torch.bfloat16)) <= 1.0
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_pass_misses_the_f32_bar(causal):
    """The smoke run's scaled-q case at d = 128: the split holds
    ``RING_RTOL`` / ``RING_ATOL`` against the plain version, one TF32
    pass does not, so the bar bites."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(256, 128, 128, seed=19))
    q = q * RING_Q_SCALE
    want = ra.ring_attention_plain(q, k, v, 4, causal)
    three = ra.ring_attention_split(q, k, v, 4, causal)
    one = ra.ring_attention_split(q, k, v, 4, causal, single=True)
    assert torch.allclose(three, want, rtol=RING_RTOL, atol=RING_ATOL)
    assert not torch.allclose(one, want, rtol=RING_RTOL, atol=RING_ATOL)


@pytest.mark.parametrize("d_k,d_v,tile", [(16, 8, 64), (128, 128, 64),
                                          (129, 8, 16), (64, 256, 16)])
def test_key_tile_follows_the_kernel_instances(d_k, d_v, tile):
    assert ra.key_tile(d_k, d_v) == tile
