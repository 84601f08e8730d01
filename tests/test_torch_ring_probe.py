"""The port's ring collectives and all-to-all against the JAX package's.

The same seeded numpy inputs go through the reference's
``make_ring_all_gather`` / ``make_ring_reduce_scatter`` /
``make_all_to_all`` on the 8-device
virtual CPU mesh (their XLA collectives in-process; their Pallas kernels
in interpret mode in a subprocess, as the reference's own tests run
them) and through the port's plain versions, which are what the
``*_cuda`` wrappers run for tensors on the CPU.

Bars:
  * all-gather and all-to-all: exact. They only move data; every rank's
    copy must equal the reference's output bit for bit (the all-to-all
    against its Pallas kernel in interpret mode: ``test_torch_ulysses.py``);
  * reduce-scatter against the reference's ``psum_scatter`` and against a
    float64 numpy sum: ``rtol=1e-4, atol=1e-5``, the reference's own bar
    between its ring and numpy (``tests/test_ring_probe.py``): up to 8
    f32 adds in another order;
  * reduce-scatter against the Pallas ring kernel in interpret mode:
    exact. The plain version adds in the kernel's order (own part plus
    arrival at every hop, arrival plus own part at the last), and f32
    addition is the same IEEE operation on both sides.

The ring kernels themselves run only on a card; what guards their
schedules here are step emulations of them on data under adversarial
and random interleavings: the all-gather's (``_emulate_gather_relay``,
the kernel's ``run_gather_relay``) a CTA at a time, with and without
its waits, every rank's copy held bit for bit against x; the
reduce-scatter's (``_emulate_rs_fold_send``, the kernel's
``run_rs_fold_send``), with and without the credits, held bit for bit
against the plain version and against the reference's Pallas kernel in
interpret mode; and a data-level simulation of the older send-buffer
schedule (``run_rs_ring``) that the matmul reduce-scatter still runs.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpu_operator_tpu.parallel import mesh as ref_mesh
from dpu_operator_tpu.parallel import ring_probe as ref_rp
from dpu_operator_tpu_torch.parallel import mesh as port_mesh
from dpu_operator_tpu_torch.parallel import ring_probe as rp
from virtual_mesh import REPO, run_virtual

torch.set_num_threads(1)

RS_RTOL, RS_ATOL = 1e-4, 1e-5
MESHES = ((1, 8, 1), (2, 4, 1), (1, 2, 4))
AXES = ("dp", "sp", "tp")


def _ref_mesh(shape):
    devices = np.array(jax.devices()[:int(np.prod(shape))])
    return Mesh(devices.reshape(shape), axis_names=AXES)


def _ref_call(make, shape, x, **kw):
    """The reference's XLA collective on the virtual mesh of ``shape``."""
    mesh = _ref_mesh(shape)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("sp", None)))
    return np.asarray(make(mesh, "sp", use_pallas=False, **kw)(xs))


def _float64_sum(X, n):
    rows = X.shape[0] // n
    return X.astype(np.float64).reshape(n, rows, -1).sum(axis=0)


# -- all-gather ---------------------------------------------------------------


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_all_gather_matches_reference_xla(shape, bidirectional):
    n = shape[1]
    x = np.random.RandomState(n).randn(4 * n, 8).astype(np.float32)
    want = _ref_call(ref_rp.make_ring_all_gather, shape, x,
                     bidirectional=bidirectional)
    every = rp.ring_all_gather_plain(torch.from_numpy(x), n, bidirectional)
    assert every.shape == (n, 4 * n, 8) and every.dtype == torch.float32
    for r in range(n):
        np.testing.assert_array_equal(every[r].numpy(), want)
    fn = rp.make_ring_all_gather(dict(zip(AXES, shape)), "sp",
                                 bidirectional=bidirectional, device="cpu")
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_all_gather_every_rank_gets_x(n, dtype):
    """Rings of every size, even and odd shards, both directions' settings:
    a wrong step index or a wrong half would misplace a block."""
    rng = np.random.RandomState(10 + n)
    for rows in (1, 2, 3, 6):
        x = torch.from_numpy(
            rng.randint(-99, 99, (n * rows, 5)).astype(np.float32)).to(dtype)
        for bidirectional in (False, True):
            every = rp.ring_all_gather_plain(x, n, bidirectional)
            assert every.dtype == dtype
            for r in range(n):
                assert torch.equal(every[r], x), (n, rows, bidirectional, r)


# -- the relay-from-output all-gather, emulated step by step ------------------


def _emulate_gather_relay(x, n, bidirectional, pick, ctas=1, recv_wait=True,
                          own_step_wait=True):
    """Step emulation of the all-gather kernel's protocol
    (``ring::run_gather_relay``) on data, a CTA at a time. x [n * chunk,
    W], rank r's shard at rows ``r * chunk ..``; bidirectional with an
    even shard, two streams of half a shard each, the second running the
    other way. Each rank's output starts unwritten; each (rank, row,
    stream) block is cut into ``ctas`` stripes, one a CTA. A CTA of rank r
    on a stream of direction d runs steps k = 0 .. n - 1, each one event:
    it waits (k >= 1, with ``recv_wait``) until its rank's receive flag
    reaches k and (2 <= k <= n - 2, with ``own_step_wait``) until the
    right neighbour's receive flag reaches k - 1, its own rank's step
    k - 2 signalled; step 0 reads its stripe of the own shard from x and
    stores it into the rank's row r and the right neighbour's row r (n =
    1: the own row only, and nothing else); step k = 1 .. n - 2 reads its
    stripe of row ``(r - d * k) mod n`` from the rank's output and stores
    it into the right neighbour's same row; each of those then arrives on
    the rank's counter of parity k % 2, and the arrival that fills it
    resets it and raises the right neighbour's receive flag to k + 1;
    step n - 1 does nothing. Flags only grow, as the kernel's do.
    ``pick`` chooses among the (step, stream, rank, cta) events whose
    waits are released; a read of an unwritten stripe relays zeros.
    Returns (every rank's copy [n, N, W]; bytes read and written; reads of
    an unwritten stripe; stores into a written one; filled counters that
    counted arrivals of more than one step)."""
    chunk = x.shape[0] // n
    if bidirectional and chunk % 2 == 0:
        halves = ((1, 0, chunk // 2), (-1, chunk // 2, chunk))
    else:
        halves = ((1, 0, chunk),)
    S = len(halves)
    item = x.element_size()
    out = {}  # (rank, row, stream, cta) -> stripe, once written
    recv = [[0] * n for _ in range(S)]
    count = [[[0, 0] for _ in range(n)] for _ in range(S)]
    counted = [[[set(), set()] for _ in range(n)] for _ in range(S)]
    step = [[[0] * ctas for _ in range(n)] for _ in range(S)]
    last = max(n - 1, 0)
    moved = early = rewrites = mixed = 0

    def own_stripe(s, r, c):
        _, lo, hi = halves[s]
        block = x[r * chunk + lo:r * chunk + hi].reshape(-1)
        return torch.tensor_split(block, ctas)[c]

    def store(key, value):
        nonlocal moved, rewrites
        rewrites += key in out
        out[key] = value
        moved += value.numel() * item

    def released(s, r, c):
        k = step[s][r][c]
        if k > last:
            return False
        d = halves[s][0]
        if recv_wait and k >= 1 and recv[s][r] < k:
            return False
        return not (own_step_wait and 2 <= k <= n - 2
                    and recv[s][(r + d) % n] < k - 1)

    while True:
        events = [(step[s][r][c], s, r, c) for s in range(S)
                  for r in range(n) for c in range(ctas)
                  if released(s, r, c)]
        if not events:
            break
        k, s, r, c = pick(events)
        d = halves[s][0]
        right = (r + d) % n
        step[s][r][c] += 1
        if k == n - 1 and n > 1:
            continue
        if k == 0:
            value = own_stripe(s, r, c)
            moved += value.numel() * item
            store((r, r, s, c), value)
            if n == 1:
                continue
            store((right, r, s, c), value)
        else:
            idx = (r - d * k) % n
            value = out.get((r, idx, s, c))
            if value is None:
                early += 1
                value = torch.zeros_like(own_stripe(s, idx, c))
            moved += value.numel() * item
            store((right, idx, s, c), value)
        count[s][r][k % 2] += 1
        counted[s][r][k % 2].add(k)
        if count[s][r][k % 2] == ctas:
            mixed += len(counted[s][r][k % 2]) > 1
            count[s][r][k % 2] = 0
            counted[s][r][k % 2] = set()
            recv[s][right] = max(recv[s][right], k + 1)
    assert all(k == last + 1 for st in step for rank in st for k in rank), (
        f"deadlock at steps {step}")
    every = x.new_empty((n,) + tuple(x.shape))
    for rank in range(n):
        for row in range(n):
            for s, (_, lo, hi) in enumerate(halves):
                every[rank, row * chunk + lo:row * chunk + hi] = torch.cat(
                    [out[rank, row, s, c] for c in range(ctas)]).view(
                        hi - lo, -1)
    return every, moved, early, rewrites, mixed


def _starve(events):
    """Adversarial: hold CTA 0 of rank 0 back while anything else can run,
    and otherwise run the CTA furthest along."""
    others = [e for e in events if e[2:] != (0, 0)]
    return max(others or events)


AG_EMU_TYPES = ("float32", "bfloat16", "int32")
AG_EMU_WIDTH = 3  # 12-byte rows (6 in bf16): no 16-byte unit


def _ag_emu_input(n, rows, tname, seed):
    """x [n * rows, 3] of ``tname`` from a seed."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-2 ** 20, 2 ** 20, (n * rows, AG_EMU_WIDTH))
    return torch.from_numpy(x.astype(np.float32)).to(getattr(torch, tname))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("tname", AG_EMU_TYPES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_gather_relay_emulation_gives_every_rank_x(n, tname, bidirectional):
    """Under every order of events, with one CTA a rank and with three,
    the emulated kernel gives every rank a copy of x bit for bit, reads no
    stripe before it was written, writes none twice, counts no arrival
    towards another step, and moves 2n - 1 blocks a rank."""
    for rows in (2, 3):  # an even shard and an odd one (one way only)
        x = _ag_emu_input(n, rows, tname, seed=90 + 10 * n + rows)
        chunk_bytes = rows * AG_EMU_WIDTH * x.element_size()
        for ctas in (1, 3):
            for i, pick in enumerate(_pickers(n) + [_starve]):
                every, moved, early, rewrites, mixed = _emulate_gather_relay(
                    x, n, bidirectional, pick, ctas=ctas)
                tag = (rows, ctas, i)
                assert (early, rewrites, mixed) == (0, 0, 0), tag
                for r in range(n):
                    np.testing.assert_array_equal(_bits(every[r]), _bits(x),
                                                  err_msg=str(tag))
                assert moved == rp.all_gather_moved_bytes(n, chunk_bytes)


@pytest.mark.parametrize("n", [3, 4, 5, 8])
def test_gather_relay_without_the_recv_wait_reads_an_unwritten_row(n):
    """With the receive wait taken out, the rank furthest along relays a
    row that has not landed yet: the emulation must show the race the
    flag closes, or it no longer models it. A ring of 2 relays nothing."""
    x = _ag_emu_input(n, 2, "float32", seed=7)
    _, _, early, _, _ = _emulate_gather_relay(x, n, False, max,
                                              recv_wait=False)
    assert early > 0
    two = _ag_emu_input(2, 2, "float32", seed=7)
    every, _, early, _, _ = _emulate_gather_relay(two, 2, True, max,
                                                  recv_wait=False)
    assert early == 0 and all(torch.equal(every[r], two) for r in range(2))


@pytest.mark.parametrize("n", [4, 5, 8])
def test_gather_relay_without_the_own_step_wait_miscounts(n):
    """With two CTAs a rank and the wait for the rank's own step k - 2
    taken out, a CTA that runs two steps ahead of its starved sibling
    fills the parity counter of a step the sibling has not stored: the
    neighbour is released early and relays a stripe that is not there."""
    x = _ag_emu_input(n, 2, "float32", seed=8)
    for bidirectional in (False, True):
        every, _, early, _, mixed = _emulate_gather_relay(
            x, n, bidirectional, _starve, ctas=2, own_step_wait=False)
        assert mixed > 0 and early > 0
        assert not all(torch.equal(every[r], x) for r in range(n))
        every, _, early, _, mixed = _emulate_gather_relay(
            x, n, bidirectional, _starve, ctas=2)
        assert (early, mixed) == (0, 0)
        assert all(torch.equal(every[r], x) for r in range(n))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_gather_relay_small_rings_need_no_own_step_wait(n):
    """Rings of 1, 2 and 3 count no arrival of step 2 or later: without
    the own-step wait, in every order, nothing is read early or counted
    towards another step."""
    x = _ag_emu_input(n, 2, "bfloat16", seed=9)
    for pick in _pickers(n) + [_starve]:
        every, _, early, rewrites, mixed = _emulate_gather_relay(
            x, n, True, pick, ctas=2, own_step_wait=False)
        assert (early, rewrites, mixed) == (0, 0, 0)
        assert all(torch.equal(every[r], x) for r in range(n))


def test_all_gather_moved_bytes():
    """The probe's 16 MiB at n = 8 (2 MiB shards): 240 MiB, where the
    stream protocol with a copy-out consumer moved 2(2n - 1) = 30 blocks
    a rank, 480 MiB; the function itself reads 16 MiB and writes 128.
    A ring of one reads its shard and writes it once."""
    mib = 2 ** 20
    assert rp.all_gather_moved_bytes(8, 2 * mib) == 240 * mib
    assert 8 * 2 * (2 * 8 - 1) * 2 * mib == 480 * mib
    assert rp.all_gather_moved_bytes(2, 12) == 2 * 3 * 12
    assert rp.all_gather_moved_bytes(3, 20) == 3 * 5 * 20
    assert rp.all_gather_moved_bytes(1, 12) == 2 * 12


def test_all_gather_errors():
    with pytest.raises(ValueError, match="equal shards"):
        rp.ring_all_gather_plain(torch.zeros(7, 2), 2)
    with pytest.raises(ValueError, match=r"\[N, W\]"):
        rp.ring_all_gather_plain(torch.zeros(8), 2)
    with pytest.raises(ValueError, match="ring of 0"):
        rp.ring_all_gather_plain(torch.zeros(8, 2), 0)
    fn = rp.make_ring_all_gather({"sp": 3}, device="cpu")
    with pytest.raises(ValueError, match="equal shards"):
        fn(torch.zeros(8, 2))


# -- reduce-scatter -----------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_reduce_scatter_matches_reference_xla(shape):
    n = shape[1]
    rows = 2 * n
    X = np.random.RandomState(20 + n).randn(n * rows, 8).astype(np.float32)
    want = _ref_call(ref_rp.make_ring_reduce_scatter, shape, X)
    fn = rp.make_ring_reduce_scatter(dict(zip(AXES, shape)), "sp",
                                     device="cpu")
    got = fn(torch.from_numpy(X))
    assert got.shape == (rows, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RS_RTOL, atol=RS_ATOL)
    np.testing.assert_allclose(got.numpy(), _float64_sum(X, n), rtol=RS_RTOL,
                               atol=RS_ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_reduce_scatter_matches_float64_sum(n):
    rows = 3 * n
    X = np.random.RandomState(30 + n).randn(n * rows, 5).astype(np.float32)
    got = rp.ring_reduce_scatter_plain(torch.from_numpy(X), n)
    np.testing.assert_allclose(got.numpy(), _float64_sum(X, n), rtol=RS_RTOL,
                               atol=RS_ATOL)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_reduce_scatter_adds_in_the_rings_order(n):
    """Chunk j starts at rank (j + 1) mod n and every rank on the way to
    rank j adds its part to what arrives, rounding to the input's type at
    every hop: in bf16 the order and the rounding both show."""
    rows = n
    X = torch.from_numpy(np.random.RandomState(40 + n).randn(
        n * rows, 16).astype(np.float32)).to(torch.bfloat16)
    got = rp.ring_reduce_scatter_plain(X, n)
    assert got.dtype == torch.bfloat16
    parts = X.view(n, n, 1, 16)  # [rank][row-block]
    for j in range(n):
        acc = parts[(j + 1) % n, j]
        for hop in range(2, n + 1):
            acc = parts[(j + hop) % n, j] + acc
        assert torch.equal(got[j:j + 1], acc), j


def test_reduce_scatter_contract():
    """The reference's contract: rows that do not divide raise with its
    message, and a ring of one is the identity."""
    x = torch.arange(12.0).reshape(6, 2)
    with pytest.raises(ValueError, match="reduce-scatter rows 3 must divide "
                                         "by axis size 2"):
        rp.ring_reduce_scatter_plain(x, 2)
    with pytest.raises(ValueError, match="reduce-scatter rows 3 must divide "
                                         "by axis size 2"):
        rp.ring_reduce_scatter_cuda(x, 2)
    with pytest.raises(ValueError, match="equal shards"):
        rp.ring_reduce_scatter_plain(torch.zeros(7, 2), 2)
    assert torch.equal(rp.ring_reduce_scatter_plain(x, 1), x)
    assert torch.equal(rp.make_ring_reduce_scatter({"sp": 1},
                                                   device="cpu")(x), x)


@pytest.mark.parametrize("shape", MESHES)
def test_all_reduce_composition(shape):
    """Reduce-scatter then all-gather is an all-reduce, as the reference's
    own test composes them."""
    n = shape[1]
    mesh = dict(zip(AXES, shape))
    X = np.random.RandomState(50 + n).randn(n * 2 * n, 8).astype(np.float32)
    rs = rp.make_ring_reduce_scatter(mesh, "sp", device="cpu")
    ag = rp.make_ring_all_gather(mesh, "sp", device="cpu")
    got = ag(rs(torch.from_numpy(X))).numpy()
    np.testing.assert_allclose(got, _float64_sum(X, n), rtol=RS_RTOL,
                               atol=RS_ATOL)
    ref = _ref_call(ref_rp.make_ring_all_gather, shape,
                    _ref_call(ref_rp.make_ring_reduce_scatter, shape, X))
    np.testing.assert_allclose(got, ref, rtol=RS_RTOL, atol=RS_ATOL)


# -- all-to-all ---------------------------------------------------------------


def _transpose(x, n):
    """The all-to-all as one numpy transpose (``tests/test_ring_probe.py``):
    rank r's block s is rank s's block r."""
    rows = x.shape[0] // n
    return (x.reshape(n, n, rows // n, -1).transpose(1, 0, 2, 3)
            .reshape(x.shape))


@pytest.mark.parametrize("shape", MESHES)
def test_all_to_all_matches_reference_xla(shape):
    n = shape[1]
    x = np.random.RandomState(70 + n).randn(n * 2 * n, 8).astype(np.float32)
    want = _ref_call(ref_rp.make_all_to_all, shape, x)
    np.testing.assert_array_equal(want, _transpose(x, n))
    got = rp.all_to_all_plain(torch.from_numpy(x), n)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    fn = rp.make_all_to_all(dict(zip(AXES, shape)), "sp", device="cpu")
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_all_to_all_every_size_and_type(n, dtype):
    """Rings of every size, blocks of 1 and 3 rows: a wrong source or
    destination index would misplace a block."""
    rng = np.random.RandomState(80 + n)
    for chunk in (1, 3):
        x = torch.from_numpy(rng.randint(
            -99, 99, (n * n * chunk, 5)).astype(np.float32)).to(dtype)
        got = rp.all_to_all_plain(x, n)
        assert got.dtype == dtype and got.shape == x.shape
        want = x.view(n, n, chunk, 5).transpose(0, 1).reshape(x.shape)
        assert torch.equal(got, want), (n, chunk)
        # Twice is the identity: block r of rank s goes there and back.
        assert torch.equal(rp.all_to_all_plain(got, n), x)


def test_all_to_all_contract():
    """The reference's contract: rows that do not divide raise with its
    message, and a ring of one is the identity."""
    x = torch.arange(12.0).reshape(6, 2)
    for fn in (rp.all_to_all_plain, rp.all_to_all_cuda):
        with pytest.raises(ValueError, match="all-to-all rows 3 must divide "
                                             "by axis size 2"):
            fn(x, 2)
    with pytest.raises(ValueError, match="equal shards"):
        rp.all_to_all_plain(torch.zeros(7, 2), 2)
    with pytest.raises(ValueError, match="runs on cpu"):
        rp.make_all_to_all({"sp": 2}, device="cpu")(
            torch.zeros(4, 2, device="meta"))
    assert torch.equal(rp.all_to_all_plain(x, 1), x)
    assert torch.equal(rp.make_all_to_all({"sp": 1}, device="cpu")(x), x)


# -- against the Pallas kernels in interpret mode -----------------------------


def test_plain_versions_match_pallas_kernels_in_interpret_mode(tmp_path):
    """The reference's Pallas ring kernels, executed in interpret mode:
    the all-gather one way and both ways on the 8-wide ring (the widest
    skew the credit protocol absorbs), the reduce-scatter at n = 8 and
    n = 4 (a multi-axis mesh). All exact."""
    rng = np.random.RandomState(5)
    x = rng.randn(32, 8).astype(np.float32)
    X8 = rng.randn(8 * 16, 8).astype(np.float32)
    X4 = rng.randn(4 * 8, 8).astype(np.float32)
    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    np.savez(src, x=x, X8=X8, X4=X4)
    r = run_virtual(
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, jax, jax.numpy as jnp\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "from jax.experimental.pallas import tpu as pltpu\n"
        "from dpu_operator_tpu.parallel.ring_probe import (\n"
        "    make_ring_all_gather, make_ring_reduce_scatter)\n"
        "a = np.load(%r)\n"
        "def mesh_of(shape):\n"
        "    return Mesh(np.array(jax.devices()).reshape(shape),\n"
        "                axis_names=('dp', 'sp', 'tp'))\n"
        "def put(mesh, v):\n"
        "    return jax.device_put(jnp.asarray(v),\n"
        "                          NamedSharding(mesh, P('sp', None)))\n"
        "out = {}\n"
        "with pltpu.force_tpu_interpret_mode():\n"
        "    m8, m4 = mesh_of((1, 8, 1)), mesh_of((2, 4, 1))\n"
        "    for bidir in (False, True):\n"
        "        fn = make_ring_all_gather(m8, 'sp', use_pallas=True,\n"
        "                                  bidirectional=bidir)\n"
        "        out['ag_%%s' %% bidir] = np.asarray(fn(put(m8, a['x'])))\n"
        "    for name, m in (('X8', m8), ('X4', m4)):\n"
        "        fn = make_ring_reduce_scatter(m, 'sp', use_pallas=True)\n"
        "        out['rs_' + name] = np.asarray(fn(put(m, a[name])))\n"
        "np.savez(%r, **out)\n" % (REPO, str(src), str(dst)))
    assert r.returncode == 0, r.stdout + r.stderr
    ref = np.load(dst)
    for bidirectional in (False, True):
        every = rp.ring_all_gather_plain(torch.from_numpy(x), 8,
                                         bidirectional)
        for rank in range(8):
            np.testing.assert_array_equal(every[rank].numpy(),
                                          ref[f"ag_{bidirectional}"])
    for name, X, n in (("X8", X8, 8), ("X4", X4, 4)):
        got = rp.ring_reduce_scatter_plain(torch.from_numpy(X), n).numpy()
        np.testing.assert_array_equal(got, ref[f"rs_{name}"])


# -- wrappers, devices, the bandwidth probe -----------------------------------


def test_cuda_wrappers_on_cpu_run_the_plain_versions():
    x = torch.from_numpy(np.random.RandomState(9).randn(24, 8).astype(
        np.float32))
    before = (rp.ring_all_gather_cuda.launches,
              rp.ring_all_gather_cuda.launches_bidir,
              rp.ring_reduce_scatter_cuda.launches)
    for bidirectional in (False, True):  # 3 rows per rank: odd
        assert torch.equal(rp.ring_all_gather_cuda(x, 8, bidirectional),
                           rp.ring_all_gather_plain(x, 8, bidirectional))
    X = x.repeat(4, 1)[:64]
    assert torch.equal(rp.ring_reduce_scatter_cuda(X, 4),
                       rp.ring_reduce_scatter_plain(X, 4))
    assert before == (rp.ring_all_gather_cuda.launches,
                      rp.ring_all_gather_cuda.launches_bidir,
                      rp.ring_reduce_scatter_cuda.launches)


def test_all_to_all_cuda_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(np.random.RandomState(8).randn(32, 8).astype(
        np.float32))
    before = rp.all_to_all_cuda.launches
    assert torch.equal(rp.all_to_all_cuda(x, 4), rp.all_to_all_plain(x, 4))
    assert torch.equal(rp.all_to_all_cuda(x, 1), x)
    assert rp.all_to_all_cuda.launches == before


def test_all_to_all_launch_state_is_kept_per_key(monkeypatch):
    """The wrapper keeps its launch state by (device, stream, n, output
    base, rank bytes): a repeat finds the same pointer array, a second n
    (or another base) builds its own, all share one set of control words
    on a (device, stream), and the oldest state goes first."""
    monkeypatch.setattr(rp, "_a2a_launches", {})
    monkeypatch.setattr(rp, "_controls", {})
    cpu = torch.device("cpu")
    four = rp._a2a_launch(cpu, 5, 4, 4096, 256)
    assert rp._a2a_launch(cpu, 5, 4, 4096, 256) is four
    assert list(four.outs) == [4096 + 256 * r for r in range(4)]
    eight = rp._a2a_launch(cpu, 5, 8, 4096, 256)
    assert eight is not four and eight.outs is not four.outs
    assert list(eight.outs) == [4096 + 256 * r for r in range(8)]
    assert list(four.outs) == [4096 + 256 * r for r in range(4)]
    assert eight.control is four.control
    assert four.flags == four.control.flags.data_ptr()
    moved = rp._a2a_launch(cpu, 5, 4, 8192, 256)
    assert moved is not four and list(moved.outs)[0] == 8192
    assert rp._a2a_launch(cpu, 6, 4, 4096, 256).control is not four.control
    epoch = four.control.epoch
    assert rp._next_epoch(four.control) == epoch + 1
    for base in range(rp.A2A_LAUNCHES_KEPT):
        rp._a2a_launch(cpu, 5, 2, 10 ** 6 + 64 * base, 32)
    assert len(rp._a2a_launches) == rp.A2A_LAUNCHES_KEPT
    assert rp._a2a_launch(cpu, 5, 4, 4096, 256) is not four


def test_odd_shard_runs_the_one_way_ring():
    """3 rows per rank cannot be halved: the bidirectional request takes
    the one-way ring's steps (the reference's rule) and still gathers."""
    x = torch.arange(3 * 8 * 8, dtype=torch.float32).reshape(24, 8)
    both = rp.ring_all_gather_plain(x, 8, True)
    one = rp.ring_all_gather_plain(x, 8, False)
    assert torch.equal(both, one)
    assert all(torch.equal(both[r], x) for r in range(8))
    want = _ref_call(ref_rp.make_ring_all_gather, (1, 8, 1), x.numpy(),
                     bidirectional=True)
    np.testing.assert_array_equal(both[0].numpy(), want)


@pytest.mark.parametrize("make", [rp.make_ring_all_gather,
                                  rp.make_ring_reduce_scatter,
                                  rp.measure_ring_bandwidth,
                                  rp.make_all_to_all])
def test_kernel_and_device_selection(make):
    with pytest.raises(ValueError, match="CUDA"):
        make({"sp": 2}, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        make({"sp": 2}, kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="axis"):
        make({"dp": 2}, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make({"sp": 2})


def test_entry_points_check_the_tensors_device():
    fn = rp.make_ring_all_gather({"sp": 2}, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        fn(torch.zeros(4, 2, device="meta"))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_measure_ring_bandwidth_keys_and_rows(n, monkeypatch):
    """The reference's keys and its payload arithmetic: both sides are
    made to report the payload they build."""
    seen = {}

    def ref_fake(mesh, axis, **kw):
        def fn(x):
            seen["ref"] = tuple(x.shape)
            return x
        return fn

    def port_fake(mesh, axis, **kw):
        def fn(x):
            seen["port"] = tuple(x.shape)
            return x
        return fn

    shape = (1, n, 1)
    monkeypatch.setattr(ref_rp, "make_ring_all_gather", ref_fake)
    ref = ref_rp.measure_ring_bandwidth(_ref_mesh(shape), "sp", mbytes=1,
                                        rounds=2)
    with monkeypatch.context() as m:
        m.setattr(rp, "make_ring_all_gather", port_fake)
        rp.measure_ring_bandwidth(dict(zip(AXES, shape)), "sp", mbytes=1,
                                  rounds=2, device="cpu")
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] % n == 0

    got = rp.measure_ring_bandwidth(dict(zip(AXES, shape)), "sp", mbytes=1,
                                    rounds=2, device="cpu")
    assert set(got) == set(ref) == {"seconds_per_round", "effective_gbps",
                                    "axis_size", "ici_adjacent", "mode"}
    assert got["mode"] == "torch" and ref["mode"] == "xla"
    assert got["axis_size"] == n == ref["axis_size"]
    assert got["effective_gbps"] > 0 and got["seconds_per_round"] > 0
    assert got["ici_adjacent"] is None and ref["ici_adjacent"] is None
    moved = seen["port"][0] * seen["port"][1] * 4 * (n - 1) / n
    assert got["effective_gbps"] == pytest.approx(
        moved * 8 / got["seconds_per_round"] / 1e9)


def test_measure_ring_bandwidth_bidirectional_on_cpu_is_the_plain_ring():
    got = rp.measure_ring_bandwidth({"sp": 4}, mbytes=1, rounds=1,
                                    bidirectional=True, device="cpu")
    assert got["mode"] == "torch" and got["axis_size"] == 4


# -- the mesh helpers ---------------------------------------------------------


@pytest.mark.parametrize("n_devices", range(1, 17))
def test_axis_sizes_match_reference(n_devices):
    assert port_mesh.axis_sizes(n_devices) == ref_mesh.axis_sizes(n_devices)
    assert port_mesh.AXES == ref_mesh.AXES


@pytest.mark.parametrize("shape,stride,want", [
    ((1, 8, 1), 1, True), ((1, 8, 1), 2, False), ((2, 4, 1), 1, True),
    ((1, 2, 4), 1, True)])
def test_ring_is_ici_adjacent_matches_reference(shape, stride, want):
    """A fabricated chip grid, as the reference's ``coords_of`` allows: sp
    along x with the given stride, dp along y, tp along z."""
    mesh = _ref_mesh(shape)
    where = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}

    def grid(idx):
        return (stride * idx[1], idx[0], idx[2])

    ref = ref_mesh.ring_is_ici_adjacent(mesh, "sp",
                                        coords_of=lambda d: grid(where[d.id]))
    port = dict(zip(AXES, shape))
    assert port_mesh.ring_is_ici_adjacent(port, "sp", coords_of=grid) is want
    assert ref is want
    assert port_mesh.ring_is_ici_adjacent(port, "sp") is None
    assert port_mesh.ring_is_ici_adjacent(
        port, "sp", coords_of=lambda idx: None) is None


# -- the reduce-scatter schedule, simulated -----------------------------------


def _simulate_rs_ring(n, credit, pick, max_events=100000):
    """Data-level simulation of the reduce-scatter ring's schedule
    (``ring::run_rs_ring``, the reference's ``_run_rs_ring``).

    A block's content is the multiset of (contributor, row-block) parts
    summed into it. Each rank's step k is split into the two events the
    kernel performs: ``send(d, k)`` -- (k > 1, with credits) take one
    credit, copy send[k % 2] into the right neighbour's receive slot
    (k + 1) % 2 NOW (delivery modelled as immediate, the worst case for
    an overwrite), then produce the next block's part into
    send[(k + 1) % 2] -- and ``fold(d, k)`` -- enabled once the left
    neighbour's step-k send has landed: (k < n - 2) add the arrival into
    send[(k + 1) % 2], (k < n - 3) grant the left neighbour a credit.
    ``pick`` chooses among the enabled events. Returns True iff no rank
    deadlocks, every rank ends with exactly the n parts of its own
    row-block, and no credit is left over."""
    def part(d, idx):
        return ((d, idx % n),)

    send = [[part(d, d - 1), None] for d in range(n)]
    recv = [[None, None] for _ in range(n)]
    sent = [0] * n
    folded = [0] * n
    credits = [0] * n
    steps = n - 1
    for _ in range(max_events):
        events = []
        for d in range(n):
            k = sent[d]
            if k < steps and folded[d] >= k:
                if not credit or k < 2 or credits[d] > 0:
                    events.append(("send", d, k))
            k = folded[d]
            if k < steps and sent[d] > k and sent[(d - 1) % n] > k:
                events.append(("fold", d, k))
        if not events:
            break
        kind, d, k = pick(events)
        nxt = (k + 1) % 2
        if kind == "send":
            if credit and k > 1:
                credits[d] -= 1
            recv[(d + 1) % n][nxt] = send[d][k % 2]
            send[d][nxt] = part(d, d - k - 2)
            sent[d] = k + 1
        else:
            if k < n - 2:
                send[d][nxt] = send[d][nxt] + recv[d][nxt]
            if k < n - 3:
                credits[(d - 1) % n] += 1
            folded[d] = k + 1
    if not all(f == steps for f in folded):
        return False  # deadlock
    if credit and any(credits):
        return False  # a grant with no send to use it
    last = (n - 1) % 2
    return all(
        sorted(recv[d][last] + send[d][last]) == [(c, d) for c in range(n)]
        for d in range(n))


def _most_ahead(events):
    # Adversarial: always advance the rank furthest along, sends first,
    # which maximises the skew between neighbours.
    return max(events, key=lambda e: (e[2], e[0] == "send"))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_rs_ring_schedule_with_credits(n):
    """Waits from step 2 on and grants while k < n - 3: every adversarial
    and random interleaving gives the right sums, no deadlock and no
    credit left over."""
    assert _simulate_rs_ring(n, credit=True, pick=_most_ahead)
    assert _simulate_rs_ring(n, credit=True, pick=min)
    rng = random.Random(1234 + n)
    for trial in range(60):
        assert _simulate_rs_ring(n, credit=True, pick=rng.choice), trial


@pytest.mark.parametrize("n", [4, 5, 8])
def test_rs_ring_schedule_without_credits_corrupts(n):
    """Without the credits a rank that runs ahead overwrites a receive
    slot whose arrival its neighbour has not folded yet: the simulation
    must show the race the credits close, or it no longer models it."""
    assert not _simulate_rs_ring(n, credit=False, pick=_most_ahead)


@pytest.mark.parametrize("n", [2, 3])
def test_rs_ring_small_rings_need_no_credit(n):
    """Rings of 2 and 3 never reuse a receive slot: the schedule grants
    and waits for nothing, with or without the credit rule."""
    for credit in (False, True):
        assert _simulate_rs_ring(n, credit=credit, pick=_most_ahead)


# -- the fold-and-send reduce-scatter, emulated step by step ------------------


def _emulate_rs_fold_send(x, n, pick, credit=True):
    """Step emulation of the reduce-scatter kernel's protocol
    (``ring::run_rs_fold_send``) on data. x [n * rows, W], rank r's
    contribution at rows ``r * rows ..``, cut into n row-blocks. Each rank
    has two receive slots (tensors) and runs steps k = 1 .. n - 2 (wait,
    from step 2 on, until its receive flag reaches k and, from step 3 on
    and with ``credit``, its credit flag k - 1; store own row-block
    ``r - k - 1`` + the arrival (at step 1 the left neighbour's row-block
    ``r - 2``, read in place; later slot ``k % 2``) into the right
    neighbour's slot ``(k + 1) % 2``, raise the right's receive flag to
    k + 1 and, while 2 <= k < n - 2, the left's credit flag to k) and the
    last step (wait, for n > 2, until its receive flag reaches n - 1;
    arrival + own row-block r is its result). Flags only grow, as the
    kernel's do. ``pick`` chooses among the (step, rank) events whose
    waits are released; each runs whole. Returns (result [rows, W], bytes
    read and written, stores into a slot whose content had not been
    read)."""
    rows = x.shape[0] // n
    chunk = rows // n
    parts = [c.split(chunk) for c in x.split(rows)]  # [rank][row-block]
    block_bytes = chunk * x.shape[1] * x.element_size()
    slots = [[None, None] for _ in range(n)]
    unread = [[False, False] for _ in range(n)]
    recv, credits = [0] * n, [0] * n
    step = [1] * n
    out = [None] * n
    moved = overwrites = 0

    def store(dst, s, value):
        nonlocal overwrites
        overwrites += unread[dst][s]
        slots[dst][s], unread[dst][s] = value, True

    def arrival(r, k):
        if k == 1:
            return parts[(r - 1) % n][(r - 2) % n]
        unread[r][k % 2] = False
        return slots[r][k % 2]

    def released(r):
        k = step[r]
        if k == n - 1:
            return n == 2 or recv[r] >= n - 1
        return ((k < 2 or recv[r] >= k)
                and (not credit or k < 3 or credits[r] >= k - 1))

    while True:
        events = [(step[r], r) for r in range(n)
                  if step[r] < n and released(r)]
        if not events:
            break
        k, r = pick(events)
        right, left = (r + 1) % n, (r - 1) % n
        if k < n - 1:
            store(right, (k + 1) % 2, parts[r][(r - k - 1) % n]
                  + arrival(r, k))
            recv[right] = max(recv[right], k + 1)
            if 2 <= k < n - 2:
                credits[left] = max(credits[left], k)
        else:
            out[r] = arrival(r, k) + parts[r][r]
        moved += 3 * block_bytes
        step[r] += 1
    assert step == [n] * n, f"deadlock at steps {step}"
    return torch.cat(out), moved, overwrites


RS_EMU_RINGS = (2, 3, 4, 5, 8)
RS_EMU_TYPES = ("float32", "bfloat16", "int32")
RS_EMU_WIDTH = 3  # one row a block: 12 bytes (6 in bf16), no 16-byte unit


def _rs_emu_input(n, tname):
    """x [n * n, 3] of ``tname`` from a seed: one-row blocks. Floats are
    bf16-exact, so both frameworks round nothing on the way in; int32
    values near 2**30, so the ring's sums wrap."""
    rng = np.random.RandomState(70 + n)
    if tname == "int32":
        return rng.randint(-2 ** 30, 2 ** 30, (n * n, RS_EMU_WIDTH),
                           dtype=np.int64).astype(np.int32) * 3
    x = rng.randn(n * n, RS_EMU_WIDTH).astype(np.float32) * 100
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bits(t):
    """The bit patterns of a 2- or 4-byte tensor, as numpy."""
    as_int = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(as_int).numpy()


@pytest.fixture(scope="module")
def pallas_rs_bits(tmp_path_factory):
    """The reference's Pallas reduce-scatter in interpret mode, one mesh
    (1, n, 1) per ring size, every type of ``RS_EMU_TYPES``: the output's
    bit patterns by (n, type). One subprocess (~20 s)."""
    tmp = tmp_path_factory.mktemp("rs_emu")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **{f"{n}_{t}": _rs_emu_input(n, t)
                     for n in RS_EMU_RINGS for t in RS_EMU_TYPES})
    r = run_virtual(
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, jax, jax.numpy as jnp\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "from jax.experimental.pallas import tpu as pltpu\n"
        "from dpu_operator_tpu.parallel.ring_probe import (\n"
        "    make_ring_reduce_scatter)\n"
        "a = np.load(%r)\n"
        "bits = {'float32': np.int32, 'bfloat16': np.int16,\n"
        "        'int32': np.int32}\n"
        "out = {}\n"
        "with pltpu.force_tpu_interpret_mode():\n"
        "    for key in a.files:\n"
        "        n, t = key.split('_')\n"
        "        m = Mesh(np.array(jax.devices()[:int(n)]).reshape(\n"
        "            1, int(n), 1), axis_names=('dp', 'sp', 'tp'))\n"
        "        x = jax.device_put(jnp.asarray(a[key]).astype(t),\n"
        "                           NamedSharding(m, P('sp', None)))\n"
        "        fn = make_ring_reduce_scatter(m, 'sp', use_pallas=True)\n"
        "        out[key] = np.asarray(fn(x)).view(bits[t])\n"
        "np.savez(%r, **out)\n" % (REPO, str(src), str(dst)))
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(dst))


def _pickers(n):
    """Adversarial orders (the rank furthest along first; the one least
    along first) and 20 random ones."""
    rng = random.Random(4321 + n)
    return [max, min] + [rng.choice] * 20


@pytest.mark.parametrize("tname", RS_EMU_TYPES)
@pytest.mark.parametrize("n", RS_EMU_RINGS)
def test_rs_fold_send_emulation_matches_plain_and_pallas(n, tname,
                                                         pallas_rs_bits):
    """Under every order of events the emulated kernel gives the plain
    version's bits and the reference Pallas kernel's, overwrites no slot
    before it was read, and moves 3(n - 1) blocks a rank."""
    x = torch.from_numpy(_rs_emu_input(n, tname)).to(getattr(torch, tname))
    want = rp.ring_reduce_scatter_plain(x, n)
    np.testing.assert_array_equal(_bits(want),
                                  pallas_rs_bits[f"{n}_{tname}"])
    block_bytes = RS_EMU_WIDTH * x.element_size()
    assert block_bytes % 16
    for i, pick in enumerate(_pickers(n)):
        got, moved, overwrites = _emulate_rs_fold_send(x, n, pick)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=str(i))
        assert overwrites == 0, i
        assert moved == n * 3 * (n - 1) * block_bytes
        assert moved == rp.reduce_scatter_moved_bytes(n, block_bytes)


@pytest.mark.parametrize("n", [5, 6, 8])
def test_rs_fold_send_without_credits_overwrites_a_slot(n):
    """Without the credits the rank furthest along stores into a slot
    whose arrival its neighbour has not read yet: the emulation must show
    the race the credits close, or it no longer models it."""
    x = torch.from_numpy(_rs_emu_input(n, "float32"))
    _, _, overwrites = _emulate_rs_fold_send(x, n, max, credit=False)
    assert overwrites > 0


@pytest.mark.parametrize("n", [2, 3, 4])
def test_rs_fold_send_small_rings_need_no_credit(n):
    """Rings of 2, 3 and 4 never reuse a receive slot: without the credit
    rule, in every order, nothing is overwritten unread."""
    x = torch.from_numpy(_rs_emu_input(n, "float32"))
    want = rp.ring_reduce_scatter_plain(x, n)
    for pick in _pickers(n):
        got, _, overwrites = _emulate_rs_fold_send(x, n, pick, credit=False)
        assert overwrites == 0 and torch.equal(got, want)


def test_reduce_scatter_moved_bytes():
    """The probe's 16 MiB a rank at n = 8 (2 MiB blocks): 336 MiB, where
    the send-buffer schedule moved 2n + 2(n - 1) + 3(n - 2) + 3 = 51
    blocks a rank, 816 MiB. A ring of one moves nothing."""
    mib = 2 ** 20
    assert rp.reduce_scatter_moved_bytes(8, 2 * mib) == 336 * mib
    assert 8 * (2 * 8 + 2 * 7 + 3 * 6 + 3) * 2 * mib == 816 * mib
    assert rp.reduce_scatter_moved_bytes(2, 12) == 2 * 3 * 12
    assert rp.reduce_scatter_moved_bytes(1, 12) == 0
