"""The port's Ulysses attention and all-to-all against the JAX package's.

The same seeded numpy inputs go through the reference's
``make_ulysses_attention`` and ``dense_attention_reference`` on the
8-device virtual CPU mesh (its XLA path in-process; its Pallas all-to-all
in interpret mode in a subprocess, as the reference's own tests run it)
and through the port's ``make_ulysses_attention(..., device="cpu")``,
whose exchanges are the plain all-to-all that ``all_to_all_cuda`` runs
for tensors on the CPU.

Bars:
  * f32: ``rtol=atol=2e-5``, the reference's own bar between Ulysses and
    dense attention (``tests/test_ulysses_attention.py``). Both packages
    compute the same f32 products and softmax; they differ by float
    reassociation only;
  * f32 gradients: ``rtol=2e-4, atol=1e-6``, the reference's own bar
    between Ulysses' ``jax.grad`` and the dense reference's;
  * bf16 port against bf16 reference: at most 1 bf16 ulp, both rounding
    the same f32 value, up to reassociation, once;
  * the all-to-all: exact, it only moves data.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpu_operator_tpu.parallel import ulysses_attention as ref
from dpu_operator_tpu_torch.parallel import burn
from dpu_operator_tpu_torch.parallel import ring_attention as ra
from dpu_operator_tpu_torch.parallel import ring_probe as rp
from dpu_operator_tpu_torch.parallel import ulysses_attention as uly
from virtual_mesh import REPO, run_virtual

torch.set_num_threads(1)

TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
AXES = ("dp", "sp", "tp")


def _qkv(S, H, dk, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(S, H, dk).astype(np.float32),
            rng.randn(S, H, dk).astype(np.float32),
            rng.randn(S, H, dv).astype(np.float32))


def _reference(n, q, k, v, causal, dtype=jnp.float32):
    """The reference's XLA Ulysses on a (1, n, 1) virtual mesh."""
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n, 1),
                axis_names=AXES)
    sh = NamedSharding(mesh, P("sp", None, None))
    args = [jax.device_put(jnp.asarray(a).astype(dtype), sh)
            for a in (q, k, v)]
    fn = ref.make_ulysses_attention(mesh, "sp", causal=causal,
                                    use_pallas=False)
    return np.array(fn(*args).astype(jnp.float32))


def _port(n, q, k, v, causal, dtype=torch.float32, **kw):
    fn = uly.make_ulysses_attention({"dp": 1, "sp": n, "tp": 1}, "sp",
                                    causal, device="cpu", **kw)
    return fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_matches_reference_and_dense(n, causal):
    """The reference's proof shapes (S = 4n, H = 2n, dk 16, dv 8), with
    distinct per-head values so a head permutation cannot pass."""
    q, k, v = _qkv(4 * n, 2 * n, 16, 8, seed=n)
    got = _port(n, q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == (4 * n, 2 * n, 8)
    want = _reference(n, q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    dense = np.asarray(ref.dense_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    np.testing.assert_allclose(got.numpy(), dense, rtol=TOL, atol=TOL)
    port_dense = uly.dense_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(port_dense.numpy(), dense, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_within_one_ulp_of_reference(causal):
    """bf16 inputs, f32 softmax and products, one cast before the inverse
    exchange, in both packages."""
    n = 8
    q, k, v = _qkv(4 * n, n, 16, 8, seed=5)
    got = _port(n, q, k, v, causal, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(_reference(n, q, k, v, causal,
                                       dtype=jnp.bfloat16))
    assert burn.bf16_ulps(got, want.to(torch.bfloat16)) <= 1.0


@pytest.mark.parametrize("causal", [False, True])
def test_agrees_with_ring_attention_per_head(causal):
    """The two sequence-parallel decompositions are interchangeable: per
    head, Ulysses gives the port's ring attention's output."""
    n = 4
    q, k, v = _qkv(4 * n, n, 8, 8, seed=3)
    got = _port(n, q, k, v, causal)
    ring = ra.make_ring_attention({"sp": n}, "sp", causal, device="cpu")
    for h in range(n):
        want = ring(*(torch.from_numpy(np.ascontiguousarray(a[:, h]))
                      for a in (q, k, v)))
        np.testing.assert_allclose(got[:, h].numpy(), want.numpy(),
                                   rtol=TOL, atol=TOL)


def test_errors():
    fn = uly.make_ulysses_attention({"sp": 4}, device="cpu")
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 3, 8, 8, seed=0))
    with pytest.raises(ValueError, match="ring attention"):
        fn(q, k, v)  # 3 heads over 4 ranks
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, 8, 8, seed=0))
    with pytest.raises(ValueError, match="k shape"):
        fn(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="v leading dims"):
        fn(q, k, v[:8])
    with pytest.raises(ValueError, match="equal shards"):
        fn(q[:6], k[:6], v[:6])
    with pytest.raises(ValueError, match=r"\[S, H, D\]"):
        fn(q[:, 0], k[:, 0], v[:, 0])
    with pytest.raises(ValueError, match="runs on cpu"):
        fn(q.to("meta"), k, v)


def test_four_exchanges_per_call(monkeypatch):
    """Three exchanges in and one out, each one all-to-all over every
    rank's stacked [n·H, S/n·D] blocks."""
    calls = []
    real = rp.all_to_all_plain

    def counting(x, n):
        calls.append((tuple(x.shape), n))
        return real(x, n)

    monkeypatch.setattr(uly, "all_to_all_plain", counting)
    n, S, H = 4, 16, 8
    q, k, v = _qkv(S, H, 8, 4, seed=2)
    _port(n, q, k, v, True)
    qk, vo = (((n * H, S // n * d), n) for d in (8, 4))  # dk 8, dv 4
    assert calls == [qk, qk, vo, vo]


def _ref_grads(n, q, k, v, causal, dtype=jnp.float32):
    """``jax.grad`` of sum(out**2) through the reference's XLA Ulysses on a
    (1, n, 1) virtual mesh, as its own gradient test takes it."""
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n, 1),
                axis_names=AXES)
    sh = NamedSharding(mesh, P("sp", None, None))
    fn = ref.make_ulysses_attention(mesh, "sp", causal=causal,
                                    use_pallas=False)
    args = [jax.device_put(jnp.asarray(a).astype(dtype), sh)
            for a in (q, k, v)]
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *args)
    return [np.array(g.astype(jnp.float32)) for g in grads]


def _grads(fn, q, k, v, dtype=torch.float32):
    """The gradients of sum(fn(q, k, v)**2) with respect to q, k and v."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    return torch.autograd.grad((fn(*leaves) ** 2).sum(), leaves)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_gradients_match_reference_and_dense(n, causal):
    """Ulysses is differentiable, as the reference is under ``jax.grad``:
    at the reference's gradient-test shapes (S = 4n, H = n, d 8) the
    port's q, k and v gradients match the reference's and its own dense
    reference's within the reference's bar."""
    q, k, v = _qkv(4 * n, n, 8, 8, seed=31 + n)
    fn = uly.make_ulysses_attention({"dp": 1, "sp": n, "tp": 1}, "sp",
                                    causal, device="cpu")
    got = _grads(fn, q, k, v)
    want = _ref_grads(n, q, k, v, causal)
    dense = _grads(functools.partial(uly.dense_attention_reference,
                                     causal=causal), q, k, v)
    for g, w, dn, name in zip(got, want, dense, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), dn.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_gradients_within_one_ulp_of_reference(causal):
    """bf16 inputs: each package's cotangent is 2·out rounded to bf16, its
    backward f32 and its gradients rounded to bf16 once."""
    n = 4
    q, k, v = _qkv(4 * n, n, 8, 8, seed=41)
    fn = uly.make_ulysses_attention({"sp": n}, "sp", causal, device="cpu")
    got = _grads(fn, q, k, v, dtype=torch.bfloat16)
    want = _ref_grads(n, q, k, v, causal, dtype=jnp.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert burn.bf16_ulps(g, torch.from_numpy(w).to(
            torch.bfloat16)) <= 1.0


def test_gradient_makes_four_exchanges_each_way(monkeypatch):
    """With ``kernel="cuda"`` (as on the card; here the factory's pick is
    forced past the CPU check and the all-to-all wrapper runs its plain
    version) a call makes 4 exchanges and its gradient 4 more, one a
    backward of each, and the gradients equal the plain route's bit for
    bit; a call without a gradient makes 4."""
    calls = []
    inner, pick_kernel = rp.all_to_all_cuda, rp.pick_kernel

    def counted(x, n):
        calls.append((tuple(x.shape), n))
        return inner(x, n)

    monkeypatch.setattr(rp, "all_to_all_cuda", counted)
    monkeypatch.setattr(rp, "pick_kernel", lambda kernel, device: (
        "cuda" if kernel == "cuda" else pick_kernel(kernel, device)))
    n, S, H = 4, 16, 8
    q, k, v = _qkv(S, H, 8, 4, seed=2)
    mesh = {"sp": n}
    kernel_fn = uly.make_ulysses_attention(mesh, "sp", True, kernel="cuda",
                                           device="cpu")
    plain_fn = uly.make_ulysses_attention(mesh, "sp", True, kernel="torch",
                                          device="cpu")
    with torch.no_grad():
        kernel_fn(*(torch.from_numpy(a) for a in (q, k, v)))
    assert len(calls) == 4
    calls.clear()
    got = _grads(kernel_fn, q, k, v)
    qk, vo = (((n * H, S // n * d), n) for d in (8, 4))  # dk 8, dv 4
    assert calls == [qk, qk, vo, vo] + [vo, vo, qk, qk]
    calls.clear()
    want = _grads(plain_fn, q, k, v)
    assert calls == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_and_device_selection():
    with pytest.raises(ValueError, match="CUDA"):
        uly.make_ulysses_attention({"sp": 2}, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        uly.make_ulysses_attention({"sp": 2}, kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="axis"):
        uly.make_ulysses_attention({"dp": 2}, device="cpu")
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 2, 4, 4, seed=1))
    fn = uly.make_ulysses_attention({"sp": 2}, kernel="torch", device="cpu")
    assert fn(q, k, v).shape == (8, 2, 4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        uly.make_ulysses_attention({"sp": 2})


def test_concat_head_partials_matches_reference():
    rng = np.random.RandomState(4)
    parts = [rng.randn(3, 2, h, 5).astype(np.float32) for h in (2, 1, 3)]
    got = uly.concat_head_partials(parts)
    want = ref.concat_head_partials(parts)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=">= 1 partial"):
        uly.concat_head_partials([])


def test_plain_versions_match_pallas_kernels_in_interpret_mode(tmp_path):
    """The reference's Pallas all-to-all, executed in interpret mode at the
    mesh shapes of its own test (2n rows of width 8 a rank), and its
    Pallas Ulysses at n = 4: the port's plain all-to-all equals the kernel
    exactly, its Ulysses within the f32 bar."""
    inputs = {f"x{n}": np.random.RandomState(n).randn(
        n * 2 * n, 8).astype(np.float32) for n in (8, 4, 2)}
    q, k, v = _qkv(16, 4, 8, 8, seed=9)
    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    np.savez(src, q=q, k=k, v=v, **inputs)
    r = run_virtual(
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, jax, jax.numpy as jnp\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "from jax.experimental.pallas import tpu as pltpu\n"
        "from dpu_operator_tpu.parallel.ring_probe import make_all_to_all\n"
        "from dpu_operator_tpu.parallel.ulysses_attention import (\n"
        "    make_ulysses_attention)\n"
        "a = np.load(%r)\n"
        "def mesh_of(shape):\n"
        "    n = int(np.prod(shape))\n"
        "    return Mesh(np.array(jax.devices()[:n]).reshape(shape),\n"
        "                axis_names=('dp', 'sp', 'tp'))\n"
        "out = {}\n"
        "with pltpu.force_tpu_interpret_mode():\n"
        "    for shape in ((1, 8, 1), (2, 4, 1), (1, 2, 4)):\n"
        "        m, n = mesh_of(shape), shape[1]\n"
        "        xs = jax.device_put(jnp.asarray(a['x%%d' %% n]),\n"
        "                            NamedSharding(m, P('sp', None)))\n"
        "        fn = make_all_to_all(m, 'sp', use_pallas=True)\n"
        "        out['a2a%%d' %% n] = np.asarray(fn(xs))\n"
        "    m = mesh_of((1, 4, 1))\n"
        "    sh = NamedSharding(m, P('sp', None, None))\n"
        "    args = [jax.device_put(jnp.asarray(a[t]), sh) for t in 'qkv']\n"
        "    for causal in (False, True):\n"
        "        fn = make_ulysses_attention(m, 'sp', causal=causal,\n"
        "                                    use_pallas=True)\n"
        "        out['uly%%s' %% causal] = np.asarray(fn(*args))\n"
        "np.savez(%r, **out)\n" % (REPO, str(src), str(dst)))
    assert r.returncode == 0, r.stdout + r.stderr
    got = np.load(dst)
    for n in (8, 4, 2):
        x = inputs[f"x{n}"]
        plain = rp.all_to_all_plain(torch.from_numpy(x), n).numpy()
        np.testing.assert_array_equal(plain, got[f"a2a{n}"])
        rows = 2 * n
        np.testing.assert_array_equal(
            plain, x.reshape(n, n, rows // n, 8).transpose(1, 0, 2, 3)
            .reshape(n * rows, 8))
    for causal in (False, True):
        np.testing.assert_allclose(_port(4, q, k, v, causal).numpy(),
                                   got[f"uly{causal}"], rtol=TOL, atol=TOL)
