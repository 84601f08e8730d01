"""The port's collective matmuls against the JAX package's.

The same seeded numpy inputs go through the reference's
``make_allgather_matmul`` / ``make_matmul_reduce_scatter`` on the 8-device
virtual CPU mesh (their XLA paths in-process; their Pallas kernels in
interpret mode in a subprocess, as the reference's own tests run them) and
through the port's entry points with ``device="cpu"``, whose wrappers run
the plain versions for tensors on the CPU.

Bars:
  * f32 port against the reference's XLA paths: ``rtol=1e-5, atol=1e-6``.
    Both take f32 products of the same blocks and, in the reduce-scatter,
    sum them in f32; they differ by the order of the sums only (the
    reference's own bar against numpy is ``1e-4``);
  * the overlapped form against the naive one: ``rtol=1e-6``, the
    reference's own bar between the two;
  * bf16 reduce-scatter against the reference's: at most 1 bf16 ulp. Both
    keep the whole reduction in f32 and round once;
  * against the reference's Pallas kernels in interpret mode: the bars of
    ``tests/test_collective_matmul.py`` between those kernels and its XLA
    paths, with the f32 ``atol=1e-6`` above beside the all-gather's
    ``rtol=1e-5``: a product that sums to nearly 0 in another order is
    off by more than 1e-5 of itself (3e-7 absolute, seen);
  * the f32 kernels' split-TF32 arithmetic written out in plain torch
    (``tf32x3_product``): against the reference's XLA paths, the f32 bar
    above plus the split's own bound, 3 * 2**-22 * sum_k |x_ik w_kj|; at
    the path's contraction lengths, ``chip_smoke.CM_F32_REL`` of max |C|
    against float64, the bar the card holds the kernels to, which one
    TF32 pass must miss.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpu_operator_tpu.parallel import collective_matmul as ref
from dpu_operator_tpu_torch.parallel import burn
from dpu_operator_tpu_torch.parallel import collective_matmul as cm
from dpu_operator_tpu_torch.parallel import ring_probe as rp
from virtual_mesh import REPO, run_virtual

import chip_smoke

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
AXES = ("dp", "sp", "tp")


def _mesh(shape):
    devices = np.array(jax.devices()[:int(np.prod(shape))])
    return Mesh(devices.reshape(shape), axis_names=AXES)


def _put(mesh, a, spec, dtype=jnp.float32):
    return jax.device_put(jnp.asarray(a).astype(dtype),
                          NamedSharding(mesh, spec))


def _ag_inputs(n, seed):
    """The reference test's shapes: x [2n, 16], w [16, 8n]."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2 * n, 16).astype(np.float32),
            rng.randn(16, 8 * n).astype(np.float32))


def _rs_inputs(n, seed):
    """The reference test's shapes: x [2n, 8n], w [8n, 16]."""
    rng = np.random.RandomState(seed)
    return (rng.randn(2 * n, 8 * n).astype(np.float32),
            rng.randn(8 * n, 16).astype(np.float32))


def _ref_ag(shape, x, w, overlap=True):
    mesh = _mesh(shape)
    fn = ref.make_allgather_matmul(mesh, "tp", use_pallas=False,
                                   overlap=overlap)
    return np.asarray(fn(_put(mesh, x, P("tp", None)),
                         _put(mesh, w, P(None, "tp"))))


def _ref_rs(shape, x, w, dtype=jnp.float32):
    mesh = _mesh(shape)
    fn = ref.make_matmul_reduce_scatter(mesh, "tp", use_pallas=False)
    out = fn(_put(mesh, x, P(None, "tp"), dtype),
             _put(mesh, w, P("tp", None), dtype))
    return np.array(out.astype(jnp.float32))


def _port(make, shape, x, w, dtype=torch.float32, **kw):
    fn = make(dict(zip(AXES, shape)), "tp", device="cpu", **kw)
    return fn(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype))


# -- all-gather matmul ----------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("shape", [(1, 1, 8), (2, 1, 4), (4, 1, 2)])
def test_allgather_matmul_matches_reference_xla(shape, overlap):
    n = shape[2]
    x, w = _ag_inputs(n, seed=n)
    got = _port(cm.make_allgather_matmul, shape, x, w, overlap=overlap)
    assert got.shape == (2 * n, 8 * n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref_ag(shape, x, w, overlap),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ w,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_allgather_matmul_overlapped_matches_naive(n):
    """The ring's block placement (``(r - k) mod n``) and its rotation are
    what the naive gather-then-product does not share."""
    x, w = _ag_inputs(n, seed=10 + n)
    fused = _port(cm.make_allgather_matmul, (1, 1, n), x, w)
    naive = _port(cm.make_allgather_matmul, (1, 1, n), x, w, overlap=False)
    np.testing.assert_allclose(fused.numpy(), naive.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_allgather_matmul_every_ring_size(n, dtype):
    """Every ring size against the numpy product; in bf16 every block is
    one f32 product rounded once, as the naive form's."""
    x, w = _ag_inputs(n, seed=20 + n)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    got = cm.ag_matmul_plain(xt, wt, n)
    assert got.dtype == dtype and got.shape == (2 * n, 8 * n)
    exact = xt.double() @ wt.double()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-4,
                                   atol=1e-5)
    else:
        assert burn.bf16_ulps(got, exact.to(dtype)) <= 1.0
        assert burn.bf16_ulps(got, cm.ag_matmul_naive(xt, wt)) <= 1.0


def test_allgather_matmul_places_each_block():
    """Rank r's columns hold every block's product: a wrong source index
    or a missed rotation would repeat or drop a block."""
    n = 4
    x = torch.arange(2 * n, dtype=torch.float32).repeat_interleave(3).view(
        2 * n, 3)
    w = torch.ones((3, 2 * n))
    got = cm.ag_matmul_plain(x, w, n)
    want = 3 * torch.arange(2 * n, dtype=torch.float32)[:, None].expand(
        2 * n, 2 * n)
    assert torch.equal(got, want)


# -- matmul reduce-scatter ------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 8), (2, 1, 4)])
def test_matmul_reduce_scatter_matches_reference_xla(shape):
    n = shape[2]
    x, w = _rs_inputs(n, seed=30 + n)
    got = _port(cm.make_matmul_reduce_scatter, shape, x, w)
    assert got.shape == (2 * n, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref_rs(shape, x, w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ w,
                               rtol=1e-4, atol=1e-4)


def test_matmul_reduce_scatter_bf16_matches_reference_within_one_ulp():
    """The reference test's bf16 case on the widest ring: [16, 64] @
    [64, 16], n = 8. Both keep the reduction in f32 and round once."""
    rng = np.random.RandomState(40)
    x = rng.randn(16, 64).astype(np.float32)
    w = rng.randn(64, 16).astype(np.float32)
    got = _port(cm.make_matmul_reduce_scatter, (1, 1, 8), x, w,
                dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(_ref_rs((1, 1, 8), x, w, jnp.bfloat16)).to(
        torch.bfloat16)
    assert burn.bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_matmul_reduce_scatter_every_ring_size(n, dtype):
    x, w = _rs_inputs(n, seed=50 + n)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    got = cm.mm_rs_plain(xt, wt, n)
    assert got.dtype == dtype and got.shape == (2 * n, 16)
    exact = xt.double() @ wt.double()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-4,
                                   atol=1e-5)
    else:
        assert burn.bf16_ulps(got, exact.to(dtype)) <= 1.0


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_matmul_reduce_scatter_sums_f32_partials_in_the_rings_order(n):
    """The partials are f32 whatever the input type, summed by the ring's
    own plain version, and rounded once at the end."""
    x, w = _rs_inputs(n, seed=60 + n)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    kn = x.shape[1] // n
    parts = torch.cat([xt[:, r * kn:(r + 1) * kn].float()
                       @ wt[r * kn:(r + 1) * kn].float() for r in range(n)])
    want = rp.ring_reduce_scatter_plain(parts, n).to(torch.bfloat16)
    assert torch.equal(cm.mm_rs_plain(xt, wt, n), want)


# -- the composed tensor-parallel pair ------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 8), (2, 1, 4)])
def test_tensor_parallel_mlp_pair(shape):
    """Y = RS(relu(AG(X) @ W1) @ W2): the first one's output sharding is
    the second one's input sharding. Port against the reference's
    composition and against the dense numpy product."""
    n = shape[2]
    rng = np.random.RandomState(70 + n)
    X = rng.randn(2 * n, 16).astype(np.float32)
    W1 = rng.randn(16, 8 * n).astype(np.float32)
    W2 = rng.randn(8 * n, 16).astype(np.float32)
    mesh = dict(zip(AXES, shape))
    ag = cm.make_allgather_matmul(mesh, "tp", device="cpu")
    rs = cm.make_matmul_reduce_scatter(mesh, "tp", device="cpu")
    got = rs(torch.relu(ag(torch.from_numpy(X), torch.from_numpy(W1))),
             torch.from_numpy(W2)).numpy()
    jm = _mesh(shape)
    h = ref.make_allgather_matmul(jm, "tp", use_pallas=False)(
        _put(jm, X, P("tp", None)), _put(jm, W1, P(None, "tp")))
    want = np.asarray(ref.make_matmul_reduce_scatter(
        jm, "tp", use_pallas=False)(jax.nn.relu(h),
                                    _put(jm, W2, P("tp", None))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    dense = np.maximum(X.astype(np.float64) @ W1, 0) @ W2
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


# -- the f32 kernels' split-TF32 arithmetic -------------------------------------
#
# ``cm.tf32x3_product`` writes the f32 kernels' product out in plain
# torch: K slices of 16, each split into TF32 hi and lo and multiplied in
# three passes, small terms first, into fresh f32 sums that are added to
# the running sum with one rounding. The ring does not change an
# element's arithmetic: the all-gather matmul's element is one product
# over the whole K, the reduce-scatter's the ring-ordered f32 sum of n
# partials over k / n.


# An operand's hi + lo is within 2**-22 of it and lo_a lo_b is dropped:
# each product term of the split within 3 * 2**-22 of the exact one.
SPLIT_REL = 3 * 2.0 ** -22


def _ag_split_emulation(x, w, single=False):
    return cm.tf32x3_product(torch.from_numpy(x), torch.from_numpy(w),
                                  single)


def _rs_split_emulation(x, w, n, single=False):
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    kn = x.shape[1] // n
    parts = torch.cat([cm.tf32x3_product(x[:, r * kn:(r + 1) * kn],
                                              w[r * kn:(r + 1) * kn], single)
                       for r in range(n)])
    return rp.ring_reduce_scatter_plain(parts, n)


@pytest.mark.parametrize("op,shape", [("ag", (1, 1, 8)), ("ag", (2, 1, 4)),
                                      ("ag", (4, 1, 2)), ("rs", (1, 1, 8)),
                                      ("rs", (2, 1, 4))])
def test_tf32x3_product_matches_reference_xla(op, shape):
    """At the reference tests' shapes the kernel's arithmetic meets the
    reference's XLA paths within this file's f32 bar widened by the
    split's own error: hi + lo stands for an operand within 2**-22 of it
    and the dropped lo_a lo_b is within 2**-22 of a product, so an
    element may move by 3 * 2**-22 * sum_k |x_ik w_kj| more than a
    reordering of f32 sums moves it (at the reduce-scatter's (1, 1, 8),
    one element in 256 near cancellation moved 1.43e-6, past atol=1e-6
    with rtol=1e-5 of its 0.019)."""
    n = shape[2]
    if op == "ag":
        x, w = _ag_inputs(n, seed=n)
        got, want = _ag_split_emulation(x, w), _ref_ag(shape, x, w)
    else:
        x, w = _rs_inputs(n, seed=30 + n)
        got, want = _rs_split_emulation(x, w, n), _ref_rs(shape, x, w)
    assert got.dtype == torch.float32 and got.shape == want.shape
    split = SPLIT_REL * (np.abs(x.astype(np.float64))
                         @ np.abs(w.astype(np.float64)))
    excess = np.abs(got.numpy() - want) - (RTOL * np.abs(want) + ATOL + split)
    assert excess.max() <= 0, excess.max()


def _path_inputs(op, seed):
    """A few narrow rows at the MLP path's contraction lengths: the
    all-gather matmul's K = 4096, the reduce-scatter's k / n = 1024 with
    n = 8; x ~ N(0, 1) (the reduce-scatter's through a relu, as relu(h)
    is), w ~ N(0, 1 / K), as ``chip_smoke.tp_weights`` draws them."""
    rng = np.random.RandomState(seed)
    if op == "ag":
        k, rows = chip_smoke.TP_D, 8
    else:
        k, rows = chip_smoke.TP_H, 16
    x = rng.randn(rows, k).astype(np.float32)
    if op == "rs":
        x = np.maximum(x, 0)
    w = (rng.randn(k, 16) / np.sqrt(k)).astype(np.float32)
    return x, w


def _path_split_error(op, seed, single):
    """(max |emulation - float64 product|, max |float64 product|)."""
    x, w = _path_inputs(op, seed)
    n = chip_smoke.TP_MESH["tp"]
    got = (_ag_split_emulation(x, w, single) if op == "ag"
           else _rs_split_emulation(x, w, n, single))
    exact = x.astype(np.float64) @ w.astype(np.float64)
    return float(np.abs(got.numpy() - exact).max()), float(np.abs(exact).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["ag", "rs"])
def test_tf32x3_product_holds_the_f32_bar_at_the_paths_contractions(
        op, seed):
    """Within ``chip_smoke.CM_F32_REL`` of max |C| against float64 at the
    path's contraction lengths: the bar the card holds the kernels to."""
    err, top = _path_split_error(op, seed, single=False)
    assert err <= chip_smoke.CM_F32_REL * top, (err, top)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["ag", "rs"])
def test_one_tf32_pass_misses_the_f32_bar_at_the_paths_contractions(
        op, seed):
    """One TF32 pass a slice, on the same inputs, lies outside the bar: the
    bar tells the split from plain TF32."""
    err, top = _path_split_error(op, seed, single=True)
    assert err > chip_smoke.CM_F32_REL * top, (err, top)


@pytest.mark.parametrize("k", [1, 15, 33, 200])
@pytest.mark.parametrize("single", [False, True])
def test_tf32x3_product_zero_fills_a_k_tail(k, single):
    """A K that is no multiple of 16 gives, bit for bit, what the operands
    zero-padded to whole slices give: the kernel's zero-filled loads."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.randn(5, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(k, 12).astype(np.float32))
    pad = -k % cm.FOLD_K
    a_pad = torch.nn.functional.pad(a, (0, pad))
    b_pad = torch.nn.functional.pad(b, (0, 0, 0, pad))
    got = cm.tf32x3_product(a, b, single)
    assert torch.equal(got, cm.tf32x3_product(a_pad, b_pad, single))


# -- errors, devices, kernel selection ------------------------------------------


def test_cuda_wrappers_on_cpu_run_the_plain_versions():
    x, w = (torch.from_numpy(a) for a in _ag_inputs(4, seed=80))
    x2, w2 = (torch.from_numpy(a) for a in _rs_inputs(4, seed=81))
    before = (cm.ag_matmul_cuda.launches, cm.mm_rs_cuda.launches)
    assert torch.equal(cm.ag_matmul_cuda(x, w, 4), cm.ag_matmul_plain(x, w, 4))
    assert torch.equal(cm.mm_rs_cuda(x2, w2, 4), cm.mm_rs_plain(x2, w2, 4))
    assert torch.equal(cm.mm_rs_cuda(x2, w2, 1), cm.mm_rs_plain(x2, w2, 1))
    assert before == (cm.ag_matmul_cuda.launches, cm.mm_rs_cuda.launches)


def test_shapes_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="matmul-reduce-scatter rows 6 must "
                                         "divide by axis size 4"):
        cm.mm_rs_plain(torch.zeros(6, 8), torch.zeros(8, 2), 4)
    with pytest.raises(ValueError, match="matmul-reduce-scatter rows 6 must "
                                         "divide by axis size 4"):
        cm.make_matmul_reduce_scatter({"tp": 4}, device="cpu")(
            torch.zeros(6, 8), torch.zeros(8, 2))
    with pytest.raises(ValueError, match="contraction 6 must divide"):
        cm.mm_rs_cuda(torch.zeros(8, 6), torch.zeros(6, 2), 4)
    with pytest.raises(ValueError, match="must divide by axis size 4"):
        cm.ag_matmul_plain(torch.zeros(6, 8), torch.zeros(8, 4), 4)
    with pytest.raises(ValueError, match="must divide by axis size 4"):
        cm.make_allgather_matmul({"tp": 4}, overlap=False, device="cpu")(
            torch.zeros(8, 8), torch.zeros(8, 6))
    with pytest.raises(ValueError, match=r"x \[B, K\] @ w \[K, F\]"):
        cm.ag_matmul_plain(torch.zeros(8, 8), torch.zeros(4, 8), 2)


def test_overlap_false_has_no_kernel():
    """The reference's rule: the kernel is inherently overlapped, so the
    naive baseline never runs it."""
    with pytest.raises(ValueError, match="overlap=False has no cuda form "
                                         r"\(the kernel is inherently "
                                         r"overlapped\)"):
        cm.make_allgather_matmul({"tp": 2}, overlap=False, kernel="cuda",
                                 device="cpu")
    fn = cm.make_allgather_matmul({"tp": 2}, overlap=False, device="cpu")
    x, w = (torch.from_numpy(a) for a in _ag_inputs(2, seed=82))
    assert torch.equal(fn(x, w), cm.ag_matmul_naive(x, w))


@pytest.mark.parametrize("make", [cm.make_allgather_matmul,
                                  cm.make_matmul_reduce_scatter])
def test_kernel_and_device_selection(make):
    with pytest.raises(ValueError, match="CUDA"):
        make({"tp": 2}, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        make({"tp": 2}, kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="axis"):
        make({"sp": 2}, device="cpu")
    fn = make({"tp": 2}, device="cpu")
    with pytest.raises(ValueError, match="w is on meta"):
        fn(torch.zeros(4, 4), torch.zeros(4, 4, device="meta"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make({"tp": 2})


# -- against the Pallas kernels in interpret mode -------------------------------


def test_plain_versions_match_pallas_kernels_in_interpret_mode(tmp_path):
    """The reference's two Pallas kernels, executed in interpret mode at
    the shapes of its own test on the widest ring, (1, 1, 8): the
    all-gather matmul, the matmul reduce-scatter, and the reduce-scatter
    in bf16. (Its other meshes, (2, 1, 4) and (1, 4, 2), would double the
    subprocess's ~25 s; the in-process tests above cover them.)"""
    meshes = ((1, 1, 8),)
    rng = np.random.RandomState(90)
    inputs = {}
    for shape in meshes:
        n = shape[2]
        tag = "x".join(map(str, shape))
        inputs[f"x_{tag}"] = rng.randn(2 * n, 16).astype(np.float32)
        inputs[f"w_{tag}"] = rng.randn(16, 8 * n).astype(np.float32)
        inputs[f"x2_{tag}"] = rng.randn(2 * n, 8 * n).astype(np.float32)
        inputs[f"w2_{tag}"] = rng.randn(8 * n, 16).astype(np.float32)
    inputs["xb"] = rng.randn(16, 64).astype(np.float32)
    inputs["wb"] = rng.randn(64, 16).astype(np.float32)
    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    np.savez(src, **inputs)
    r = run_virtual(
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, jax, jax.numpy as jnp\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "from jax.experimental.pallas import tpu as pltpu\n"
        "from dpu_operator_tpu.parallel.collective_matmul import (\n"
        "    make_allgather_matmul, make_matmul_reduce_scatter)\n"
        "a = np.load(%r)\n"
        "def put(mesh, v, spec, dt=jnp.float32):\n"
        "    return jax.device_put(jnp.asarray(v).astype(dt),\n"
        "                          NamedSharding(mesh, spec))\n"
        "out = {}\n"
        "with pltpu.force_tpu_interpret_mode():\n"
        "    for shape in %r:\n"
        "        tag = 'x'.join(map(str, shape))\n"
        "        mesh = Mesh(np.array(jax.devices()).reshape(shape),\n"
        "                    axis_names=('dp', 'sp', 'tp'))\n"
        "        fn = make_allgather_matmul(mesh, 'tp', use_pallas=True)\n"
        "        out['ag_' + tag] = np.asarray(fn(\n"
        "            put(mesh, a['x_' + tag], P('tp', None)),\n"
        "            put(mesh, a['w_' + tag], P(None, 'tp'))))\n"
        "        fn = make_matmul_reduce_scatter(mesh, 'tp', use_pallas=True)\n"
        "        out['rs_' + tag] = np.asarray(fn(\n"
        "            put(mesh, a['x2_' + tag], P(None, 'tp')),\n"
        "            put(mesh, a['w2_' + tag], P('tp', None))))\n"
        "    mesh = Mesh(np.array(jax.devices()).reshape(1, 1, 8),\n"
        "                axis_names=('dp', 'sp', 'tp'))\n"
        "    fn = make_matmul_reduce_scatter(mesh, 'tp', use_pallas=True)\n"
        "    out['rs_bf16'] = np.asarray(fn(\n"
        "        put(mesh, a['xb'], P(None, 'tp'), jnp.bfloat16),\n"
        "        put(mesh, a['wb'], P('tp', None), jnp.bfloat16)\n"
        "        ).astype(jnp.float32))\n"
        "np.savez(%r, **out)\n" % (REPO, str(src), meshes, str(dst)))
    assert r.returncode == 0, r.stdout + r.stderr
    got = np.load(dst)
    for shape in meshes:
        n = shape[2]
        tag = "x".join(map(str, shape))
        ag = cm.ag_matmul_plain(torch.from_numpy(inputs[f"x_{tag}"]),
                                torch.from_numpy(inputs[f"w_{tag}"]), n)
        np.testing.assert_allclose(ag.numpy(), got[f"ag_{tag}"], rtol=RTOL,
                                   atol=ATOL)
        rs = cm.mm_rs_plain(torch.from_numpy(inputs[f"x2_{tag}"]),
                            torch.from_numpy(inputs[f"w2_{tag}"]), n)
        np.testing.assert_allclose(rs.numpy(), got[f"rs_{tag}"], rtol=1e-4,
                                   atol=1e-4)
    rsb = cm.mm_rs_plain(torch.from_numpy(inputs["xb"]).to(torch.bfloat16),
                         torch.from_numpy(inputs["wb"]).to(torch.bfloat16), 8)
    want = torch.from_numpy(got["rs_bf16"]).to(torch.bfloat16)
    assert burn.bf16_ulps(rsb, want) <= 1.0
    np.testing.assert_allclose(rsb.float().numpy(), got["rs_bf16"],
                               rtol=1e-2, atol=1e-2)


# -- the bf16 kernels' tensor-map views -----------------------------------------
#
# ``tma_views`` is what the bf16 kernels read through TMA. The card is the
# only place the maps are encoded and read, so these tests hold the views
# on the CPU: their extents, strides and boxes, and, by emulating a TMA
# box read (zero-filled past every extent) and the product's coordinate
# rule (``tile::tma_box``: K offset on the K axis, tile offset on the tile
# axis, the part on the part axis), the products they give.

# (n, rows, k, f) of the reduce-scatter: the reference tests' shape at
# every ring size, chip_smoke's off-grid and wgmma cases, the MLP's.
RS_SHAPES = ([(n, 2 * n, 8 * n, 16) for n in chip_smoke.CM_RINGS if n > 1]
             + list(chip_smoke.CM_RS_OFF_GRID)
             + [c[:4] for c in chip_smoke.CM_WGMMA_CASES if c[4]]
             + [(8, chip_smoke.TP_B, chip_smoke.TP_H, chip_smoke.TP_D)])
AG_SHAPES = ([(n, 2 * n, 16, 8 * n) for n in chip_smoke.CM_RINGS]
             + list(chip_smoke.CM_OFF_GRID)
             + [c[:4] for c in chip_smoke.CM_WGMMA_CASES if not c[4]]
             + [(8, chip_smoke.TP_B, chip_smoke.TP_D, chip_smoke.TP_H)])


def _views(op, n, rows, k, f):
    return cm.tma_views(op, n, rows // n, k, f)


def _role_dim(view, role):
    return view.roles.index(role)


@pytest.mark.parametrize("n,rows,k,f", RS_SHAPES)
def test_tma_views_give_the_reduce_scatter_a_k_extent_of_k_over_n(
        n, rows, k, f):
    """A rank's contraction ends at k / n in both operands: the next
    rank's columns of x and rows of w lie past the extent, where TMA
    reads zeros, not data."""
    for name, view in _views("rs", n, rows, k, f).items():
        assert view.dims[_role_dim(view, cm.K_AXIS)] == k // n, name
        assert view.dims[_role_dim(view, cm.PART_AXIS)] == n, name


@pytest.mark.parametrize("n,rows,k,f", AG_SHAPES)
def test_tma_views_of_the_allgather_matmul(n, rows, k, f):
    """K is the whole row of x, of a slot and of w; the parts are the n
    shards, the 2n slots and the n ranks' column blocks."""
    views = _views("ag", n, rows, k, f)
    assert list(views) == ["x", "slots", "w"]
    parts = {"x": n, "slots": 2 * n, "w": n}
    tiles = {"x": rows // n, "slots": rows // n, "w": f // n}
    for name, view in views.items():
        assert view.dims[_role_dim(view, cm.K_AXIS)] == k, name
        assert view.dims[_role_dim(view, cm.PART_AXIS)] == parts[name], name
        assert view.dims[_role_dim(view, cm.TILE_AXIS)] == tiles[name], name


@pytest.mark.parametrize("op,n,rows,k,f",
                         [("rs",) + s for s in RS_SHAPES]
                         + [("ag",) + s for s in AG_SHAPES])
def test_tma_views_are_maps_the_card_takes(op, n, rows, k, f):
    """cuTensorMapEncodeTiled's rules for a 128-byte swizzle: global
    strides multiples of 16 bytes, every box dimension 1..256, the inner
    box one 128-byte row; the roles name each axis once, the strides grow
    outwards, and a box is one K step of one part."""
    for name, view in _views(op, n, rows, k, f).items():
        assert all(s % 16 == 0 and s > 0 for s in view.strides), name
        assert view.strides[0] >= view.dims[0] * 2, name
        assert view.strides[1] >= view.strides[0] * view.dims[1], name
        assert all(1 <= b <= 256 for b in view.box), name
        assert view.box[0] * 2 == 128, name
        assert sorted(view.roles) == [cm.K_AXIS, cm.TILE_AXIS,
                                      cm.PART_AXIS], name
        assert view.box[_role_dim(view, cm.K_AXIS)] == cm.WG_BK, name
        assert view.box[_role_dim(view, cm.PART_AXIS)] == 1, name
        assert len(view.values()) == 11


def _tma_box(flat, view, coords):
    """A TMA load of ``view``'s box at ``coords`` from the elements
    ``flat``: [box2, box1, box0], zero past every extent."""
    out = np.zeros(view.box[::-1], dtype=flat.dtype)
    strides = (1, view.strides[0] // 2, view.strides[1] // 2)
    for i2 in range(view.box[2]):
        for i1 in range(view.box[1]):
            c2, c1 = coords[2] + i2, coords[1] + i1
            if not (0 <= c2 < view.dims[2] and 0 <= c1 < view.dims[1]):
                continue
            c0 = np.arange(coords[0], coords[0] + view.box[0])
            ok = (c0 >= 0) & (c0 < view.dims[0])
            at = c2 * strides[2] + c1 * strides[1] + c0[ok]
            out[i2, i1, ok] = flat[at]
    return out


def _operand_tile(flat, view, part, tile0, k0, t):
    """The box ``tile::tma_box`` loads for (part, tile0) at K offset k0 and
    tile offset t, as [tile, K]."""
    coords = [0, 0, 0]
    coords[_role_dim(view, cm.K_AXIS)] = k0
    coords[_role_dim(view, cm.TILE_AXIS)] = tile0 + t
    coords[_role_dim(view, cm.PART_AXIS)] = part
    box = _tma_box(flat, view, coords)
    # Axes of `box` are dims 2, 1, 0: put the tile axis first, K second.
    axes = [2 - _role_dim(view, cm.TILE_AXIS), 2 - _role_dim(view, cm.K_AXIS)]
    part_axis = 2 - _role_dim(view, cm.PART_AXIS)
    return np.transpose(box, axes + [part_axis])[..., 0]


def _emulated_product(a_flat, a_view, a_part, a_tile0, b_flat, b_view,
                      b_part, m, n_cols, k):
    """C [m, n_cols] as the wgmma form assembles it from boxes: BM-row
    tiles of A, 64-column panels of B, K steps of 64 to the end of k."""
    out = np.zeros((m, n_cols))
    for r0 in range(0, m, cm.WG_BM):
        for c0 in range(0, n_cols, cm.WG_PANEL):
            acc = np.zeros((cm.WG_BM, cm.WG_PANEL))
            for k0 in range(0, k, cm.WG_BK):
                a = _operand_tile(a_flat, a_view, a_part, a_tile0, k0, r0)
                b = _operand_tile(b_flat, b_view, b_part, 0, k0, c0)
                acc += a.astype(np.float64) @ b.T.astype(np.float64)
            rows, cols = min(cm.WG_BM, m - r0), min(cm.WG_PANEL, n_cols - c0)
            out[r0:r0 + rows, c0:c0 + cols] = acc[:rows, :cols]
    return out


@pytest.mark.parametrize("n,rows,k,f", [(3, 600, 216, 200), (2, 4, 16, 16),
                                        (4, 8, 32, 16)])
def test_tma_views_emulated_reduce_scatter_products(n, rows, k, f):
    """Every rank's partial of every row-block, read through the views
    with the kernel's coordinates (x's part: the rank, its tile origin:
    the row-block; w's part: the rank), equals x[block, rank's k] @
    w[rank's k, :]. kn = 72 is no multiple of a K step: the zero fill
    past it keeps the next rank's contraction out."""
    rng = np.random.RandomState(100 + n)
    x = rng.randn(rows, k).astype(np.float32)
    w = rng.randn(k, f).astype(np.float32)
    chunk, kn = rows // n, k // n
    views = _views("rs", n, rows, k, f)
    for rank in range(n):
        for idx in range(n):
            got = _emulated_product(x.ravel(), views["x"], rank, idx * chunk,
                                    w.ravel(), views["w"], rank, chunk, f,
                                    kn)
            want = (x[idx * chunk:(idx + 1) * chunk,
                      rank * kn:(rank + 1) * kn].astype(np.float64)
                    @ w[rank * kn:(rank + 1) * kn])
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n,rows,k,f", [(3, 600, 136, 600), (2, 4, 16, 16),
                                        (5, 10, 16, 40)])
def test_tma_views_emulated_allgather_products(n, rows, k, f):
    """Rank r's product of every block, read from x by shard and from a
    slot by slot (the slots holding the blocks in transit), with w by
    rank, equals block @ w[:, rank's columns]."""
    rng = np.random.RandomState(110 + n)
    x = rng.randn(rows, k).astype(np.float32)
    w = rng.randn(k, f).astype(np.float32)
    chunk, fn = rows // n, f // n
    views = _views("ag", n, rows, k, f)
    slots = np.stack([x[(s % n) * chunk:(s % n + 1) * chunk]
                      for s in range(2 * n)])
    for rank in range(n):
        for idx in range(n):
            want = (x[idx * chunk:(idx + 1) * chunk].astype(np.float64)
                    @ w[:, rank * fn:(rank + 1) * fn])
            got = _emulated_product(x.ravel(), views["x"], idx, 0,
                                    w.ravel(), views["w"], rank, chunk, fn, k)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
            slot = 2 * ((idx + 1) % n) + idx % 2
            got = _emulated_product(slots.ravel(), views["slots"], slot, 0,
                                    w.ravel(), views["w"], rank, chunk, fn, k)
            want = (slots[slot].astype(np.float64)
                    @ w[:, rank * fn:(rank + 1) * fn])
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_tma_views_without_a_known_op_raise():
    with pytest.raises(ValueError, match="op is 'ag' or 'rs'"):
        cm.tma_views("mm", 2, 4, 16, 16)
