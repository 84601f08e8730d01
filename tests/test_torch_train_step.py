"""The port's five-axis GPipe training step against the JAX package's.

The same seeded numpy weights (the reference's ``init_params`` layout and
scales, carried across by ``train_step.params_from_numpy``), inputs and
targets go through the reference's ``make_train_step`` loss (jitted, with
``jax.grad`` of it) on the 8-device virtual CPU mesh and through the
port's, whose ranks of every axis are stacked on the CPU and whose expert
exchanges are the plain all-to-all.

Bars (the reference's own, ``tests/test_train_step.py``, of its
distributed step against its dense twin):
  * loss: ``rtol=2e-5``;
  * every gradient leaf: ``rtol=5e-4, atol=1e-6``;
  * the exchange's gradient and the kernel exchange's whole step against
    the plain exchange's: bit for bit (an all-to-all moves values, and its
    adjoint is the same all-to-all).
"""

import functools

import numpy as np
import pytest
import torch

import jax
from jax import lax
from jax.sharding import Mesh

from dpu_operator_tpu.parallel import train_step as ref
from dpu_operator_tpu_torch.parallel import moe
from dpu_operator_tpu_torch.parallel import ring_probe as rp
from dpu_operator_tpu_torch.parallel import train_step as ts

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
CPU = dict(device="cpu")
D, H = 8, 16

SHAPES = [  # tests/test_train_step.py's three factorings
    {"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2},
    {"dp": 1, "pp": 2, "sp": 1, "tp": 2, "ep": 2},
    {"dp": 1, "pp": 1, "sp": 2, "tp": 2, "ep": 2},
]
REPLICATED = {"dp": 1, "pp": 2, "sp": 1, "tp": 2, "ep": 2}
DROPS = {"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2}
ALL_AXES = {"dp": 2, "pp": 2, "sp": 2, "tp": 2, "ep": 2}


def _params(S, E, seed, d=D, h=H):
    """Weights in the reference's ``init_params`` layout and scales."""
    rng = np.random.RandomState(seed)
    shapes = {"w1": ((S, d, h), d), "w2": ((S, h, d), h),
              "router": ((S, d, E), d), "moe_w1": ((S, E, d, h), d),
              "moe_w2": ((S, E, h, d), h)}
    return {k: (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
            for k, (shape, fan_in) in shapes.items()}


def _data(shape, seed, M=3):
    """(x, tgt) [M, mb, seq, d] at the reference test's sizes."""
    rng = np.random.RandomState(seed)
    dims = (M, 4 * shape["dp"], 2 * shape["sp"], D)
    return (rng.randn(*dims).astype(np.float32),
            rng.randn(*dims).astype(np.float32))


def _case(shape, token_shard_ep=True):
    """(params, x, tgt, cf) of one test case, numpy."""
    key = tuple(shape.values())
    params = _params(shape["pp"], shape["ep"], seed=3 + sum(key))
    x, tgt = _data(shape, seed=sum(key) + 10 * token_shard_ep)
    return params, x, tgt, float(shape["ep"])


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(*shape.values()),
                tuple(shape.keys()))


@functools.lru_cache(maxsize=None)
def _reference(key, token_shard_ep, cf):
    """The reference's loss and gradients of its distributed step and of
    its dense twin on ``_case``'s data, jitted once a case."""
    shape = dict(zip(ts.AXES, key))
    params, x, tgt, _ = _case(shape, token_shard_ep)
    mesh = _mesh(shape)
    _, loss_fn = ref.make_train_step(mesh, capacity_factor=cf, lr=0.05,
                                     token_shard_ep=token_shard_ep)
    sharded = ref.shard_params(params, mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sharded, x, tgt)

    def dense(p):
        return ref.dense_loss_reference(p, x, tgt, capacity_factor=cf,
                                        shards=shape,
                                        token_shard_ep=token_shard_ep)

    d_loss, d_grads = jax.jit(jax.value_and_grad(dense))(params)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return float(loss), as_np(grads), float(d_loss), as_np(d_grads)


def _port(shape, cf, token_shard_ep=True, kernel=None, seed_case=None):
    params, x, tgt, _ = seed_case or _case(shape, token_shard_ep)
    p = ts.shard_params(ts.params_from_numpy(params, "cpu"), shape, **CPU)
    step, loss_fn = ts.make_train_step(shape, capacity_factor=cf, lr=0.05,
                                       token_shard_ep=token_shard_ep,
                                       kernel=kernel, **CPU)
    return p, torch.from_numpy(x), torch.from_numpy(tgt), step, loss_fn


def _check_grads(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what} {k}")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- the step against the reference's -------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_five_axis_step_matches_reference(shape):
    """Loss and every gradient leaf == the reference's distributed step;
    the loss == its dense twin too; one train_step lowers the loss and
    its update is p - lr·g."""
    cf = float(shape["ep"])
    p, x, tgt, step, loss_fn = _port(shape, cf)
    want_loss, want_grads, dense_loss, _ = _reference(
        tuple(shape.values()), True, cf)
    loss, grads = ts.value_and_grad(loss_fn, p, x, tgt)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), dense_loss, rtol=LOSS_RTOL)
    _check_grads(grads, want_grads, "grad")

    loss1, new = step(p, x, tgt)
    assert torch.equal(loss1, loss)
    for k in p:
        assert torch.equal(new[k], p[k] - 0.05 * grads[k]), k
    loss2 = float(loss_fn(new, x, tgt))
    assert loss2 < float(loss1), (float(loss1), loss2)


@pytest.mark.parametrize("shape,token_shard_ep",
                         [(s, True) for s in SHAPES]
                         + [(REPLICATED, False)],
                         ids=["dp2-pp2-ep2", "pp2-tp2-ep2", "sp2-tp2-ep2",
                              "replicated-ep"])
def test_dense_loss_reference_matches_reference(shape, token_shard_ep):
    """The port's single-device twin (every piece of a stage at once)
    against the reference's (piece by piece): loss and gradients."""
    cf = float(shape["ep"])
    params, x, tgt, _ = _case(shape, token_shard_ep)
    _, _, want_loss, want_grads = _reference(
        tuple(shape.values()), token_shard_ep, cf)
    p = ts.params_from_numpy(params, "cpu")
    loss, grads = ts.value_and_grad(
        lambda q, a, b: ts.dense_loss_reference(
            q, a, b, capacity_factor=cf, shards=shape,
            token_shard_ep=token_shard_ep),
        p, torch.from_numpy(x), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _check_grads(grads, want_grads, "dense grad")


def test_replicated_ep_compat_path_still_exact():
    """token_shard_ep=False: each ep rank routes every token of its sp
    shard (tests/test_train_step.py:144); loss and gradients == the
    reference's program and its dense twin."""
    cf = float(REPLICATED["ep"])
    p, x, tgt, _, loss_fn = _port(REPLICATED, cf, token_shard_ep=False)
    want_loss, want_grads, dense_loss, _ = _reference(
        tuple(REPLICATED.values()), False, cf)
    loss, grads = ts.value_and_grad(loss_fn, p, x, tgt)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), dense_loss, rtol=LOSS_RTOL)
    _check_grads(grads, want_grads, "replicated-ep grad")


def test_five_axis_step_capacity_drops_still_train():
    """Capacity pressure (cf 0.5: rows dropped) leaves the step finite and
    descending (tests/test_train_step.py:72), and its loss and gradients
    still the reference's."""
    params = _params(2, 2, seed=9)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 2, D).astype(np.float32)
    tgt = rng.randn(2, 8, 2, D).astype(np.float32)
    mesh = _mesh(DROPS)
    _, ref_loss_fn = ref.make_train_step(mesh, capacity_factor=0.5, lr=0.01)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref_loss_fn))(
        ref.shard_params(params, mesh), x, tgt)
    p = ts.params_from_numpy(params, "cpu")
    step, loss_fn = ts.make_train_step(DROPS, capacity_factor=0.5, lr=0.01,
                                       **CPU)
    x, tgt = torch.from_numpy(x), torch.from_numpy(tgt)
    loss, grads = ts.value_and_grad(loss_fn, p, x, tgt)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _check_grads(grads, jax.tree.map(np.asarray, want_grads), "drops grad")
    # Rows were dropped: the first stage's routing keeps fewer than all.
    y = torch.tanh(torch.relu(x[0].reshape(2, 2, 4, D) @ p["w1"][0])
                   @ p["w2"][0])
    keep = moe.route(y, p["router"][0], capacity_factor=0.5)["keep"]
    assert (keep == 0).any()
    loss1, new = step(p, x, tgt)
    loss2, _ = step(new, x, tgt)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss1)


# -- kernel 10's gradient ---------------------------------------------------------


def _counting(monkeypatch):
    """Count the calls of the all-to-all wrapper that kernel_exchange
    launches (on the CPU it runs the plain version)."""
    calls = []
    inner = rp.all_to_all_cuda

    def counted(x, n):
        calls.append(n)
        return inner(x, n)

    monkeypatch.setattr(rp, "all_to_all_cuda", counted)
    return calls


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_exchange_backward_is_the_same_all_to_all(n, monkeypatch):
    """kernel_exchange's backward == autograd through all_to_all_plain ==
    all_to_all_plain of the incoming gradient, bit for bit; one call each
    way (a ring of one is the identity: no call through the Function)."""
    calls = _counting(monkeypatch)
    rng = np.random.RandomState(n)
    rows, W = 2 * n, 5
    x = torch.from_numpy(rng.randn(n * rows, W).astype(np.float32))
    g = torch.from_numpy(rng.randn(n * rows, W).astype(np.float32))
    xk = x.clone().requires_grad_()
    xp = x.clone().requires_grad_()
    yk = moe.kernel_exchange(xk, n)
    (gk,) = torch.autograd.grad(yk, xk, g)
    yp = rp.all_to_all_plain(xp, n)
    (gp,) = torch.autograd.grad(yp, xp, g)
    assert _same_bits(yk, yp)
    assert _same_bits(gk, gp)
    assert _same_bits(gk, rp.all_to_all_plain(g, n))
    assert _same_bits(rp.all_to_all_plain(yk.detach(), n), x)  # involution
    assert calls == ([n, n] if n > 1 else [n])


def test_exchange_backward_matches_reference_vjp():
    """jax.vjp of the reference's tiled lax.all_to_all over a 4-device ep
    mesh == kernel_exchange's backward, bit for bit."""
    from dpu_operator_tpu.parallel._compat import shard_map
    from jax.sharding import PartitionSpec as P

    E, C, d = 4, 3, 5
    rng = np.random.RandomState(7)
    disp = rng.randn(E * E, C, d).astype(np.float32)
    cot = rng.randn(E * E, C, d).astype(np.float32)
    exchange = shard_map(
        lambda b: lax.all_to_all(b, "ep", 0, 0, tiled=True),
        mesh=Mesh(np.array(jax.devices()[:E]), ("ep",)), in_specs=P("ep"),
        out_specs=P("ep"), check_vma=False)
    _, vjp = jax.vjp(exchange, disp)
    (want,) = vjp(cot)
    x = torch.from_numpy(disp).reshape(-1, d).requires_grad_()
    (got,) = torch.autograd.grad(moe.kernel_exchange(x, E), x,
                                 torch.from_numpy(cot).reshape(-1, d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1, d))


@pytest.mark.parametrize("shape", [ALL_AXES, SHAPES[0]],
                         ids=["all-axes-2", "dp2-pp2-ep2"])
def test_kernel_exchange_step_launches_and_bits(shape, monkeypatch):
    """The step on kernel_exchange (as on the card, here with the wrapper's
    plain version): 2 exchange calls a MoE call forward and 2 backward,
    the dp·sp groups folded into each (4·S·M a step; 2·S·M for the loss
    alone), and loss and gradients == the plain exchange's, bit for bit,
    and == the port's dense twin."""
    calls = _counting(monkeypatch)
    cf = float(shape["ep"])
    params = _params(shape["pp"], shape["ep"], seed=21)
    x, tgt = (torch.from_numpy(a) for a in _data(shape, seed=22, M=4))
    p = ts.params_from_numpy(params, "cpu")
    sizes = ts._mesh_sizes(shape)
    kernel_loss = ts._make_loss(sizes, cf, True, moe.kernel_exchange,
                                torch.device("cpu"))
    _, plain_loss = ts.make_train_step(shape, capacity_factor=cf, **CPU)
    S, M = shape["pp"], x.shape[0]
    kernel_loss(p, x, tgt)
    assert len(calls) == 2 * S * M
    calls.clear()
    loss_k, grads_k = ts.value_and_grad(kernel_loss, p, x, tgt)
    assert len(calls) == 4 * S * M and set(calls) == {shape["ep"]}
    calls.clear()
    loss_p, grads_p = ts.value_and_grad(plain_loss, p, x, tgt)
    assert calls == []
    assert _same_bits(loss_k, loss_p)
    for k in grads_p:
        assert _same_bits(grads_k[k], grads_p[k]), k
    dense = ts.dense_loss_reference(p, x, tgt, capacity_factor=cf,
                                    shards=shape)
    np.testing.assert_allclose(float(loss_k), float(dense), rtol=LOSS_RTOL)


# -- the stage's pieces -------------------------------------------------------------


def test_groups_fold_into_the_exchange_width(monkeypatch):
    """switch_moe_local on [G, E, rows, d] == each group alone, with two
    exchange calls in all; one group of [1, E, rows, d] == the row
    plane's [E, rows, d] bit for bit."""
    G, E, rows = 3, 4, 4
    rng = np.random.RandomState(31)
    rw = torch.from_numpy((rng.randn(D, E) / np.sqrt(D)).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(E, D, H) / np.sqrt(D)).astype(
        np.float32))
    w2 = torch.from_numpy((rng.randn(E, H, D) / np.sqrt(H)).astype(
        np.float32))
    y = torch.from_numpy(rng.randn(G, E, rows, D).astype(np.float32))
    calls = _counting(monkeypatch)
    for cf in (1.0, float(E)):
        calls.clear()
        got = moe.switch_moe_local(y, rw, w1, w2, capacity_factor=cf,
                                   exchange=moe.kernel_exchange)
        assert calls == [E, E]
        for g in range(G):
            alone = moe.switch_moe_local(y[g], rw, w1, w2, capacity_factor=cf)
            torch.testing.assert_close(got[g], alone, rtol=1e-6, atol=1e-7)
            one = moe.switch_moe_local(y[g:g + 1], rw, w1, w2,
                                       capacity_factor=cf)
            assert _same_bits(one[0], alone)


def test_stage_fn_sums_tp_partials_in_rank_order():
    """tp = 2: w1 cut on its columns, w2 on its rows, the partials summed
    in rank order; the same function as tp = 1 within float reassociation."""
    params = ts.params_from_numpy(_params(1, 2, seed=41), "cpu")
    p = {k: v[0] for k, v in params.items()}
    x = torch.from_numpy(np.random.RandomState(42).randn(2, 4, D).astype(
        np.float32))
    kw = dict(E=2, tp_axis="tp", ep_axis="ep", capacity_factor=2.0)
    two = ts._stage_fn(p, x, tp=2, **kw)
    one = ts._stage_fn(p, x, **kw)
    torch.testing.assert_close(two, one, rtol=1e-5, atol=1e-6)
    k = H // 2
    dense = (torch.relu(x @ p["w1"][:, :k]) @ p["w2"][:k]
             + torch.relu(x @ p["w1"][:, k:]) @ p["w2"][k:])
    y = torch.tanh(dense)
    want = y + moe.switch_moe_local(y, p["router"], p["moe_w1"],
                                    p["moe_w2"], capacity_factor=2.0)
    assert _same_bits(two, want)
    with pytest.raises(ValueError, match="does not shard over tp=3"):
        ts._stage_fn(p, x, tp=3, **kw)


def test_make_train_step_checks():
    shape = SHAPES[0]
    # attention=True builds: its step takes the eight weights and gives
    # the loss and new weights in the reference's layout; its loss refuses
    # the five without wq/wk/wv, and the plain step the eight.
    step_a, loss_a = ts.make_train_step(shape, attention=True, **CPU)
    pa = ts.params_from_numpy(
        dict(_params(2, 2, seed=1),
             **{k: (np.random.RandomState(i).randn(2, D, D) / np.sqrt(D))
                .astype(np.float32) for i, k in enumerate(("wq", "wk",
                                                           "wv"))}), "cpu")
    xa, ta = (torch.from_numpy(a) for a in _data(shape, seed=2))
    loss, new = step_a(pa, xa, ta)
    assert loss.shape == () and torch.isfinite(loss)
    assert set(new) == set(ref.param_specs(attention=True))
    assert all(new[k].shape == pa[k].shape for k in pa)
    with pytest.raises(ValueError, match="attention=True takes"):
        loss_a({k: v for k, v in pa.items() if k != "wq"}, xa, ta)
    with pytest.raises(ValueError, match="attention=False takes"):
        ts.make_train_step(shape, **CPU)[1](pa, xa, ta)
    with pytest.raises(ValueError, match=r"lacks the axes \['sp'\]"):
        ts.make_train_step({k: v for k, v in shape.items() if k != "sp"},
                           **CPU)
    with pytest.raises(ValueError, match="CUDA"):
        ts.make_train_step(shape, kernel="cuda", **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.make_train_step(shape)
    p = ts.params_from_numpy(_params(4, 2, seed=1), "cpu")
    _, loss_fn = ts.make_train_step(shape, **CPU)
    x, tgt = (torch.from_numpy(a) for a in _data(shape, seed=2))
    with pytest.raises(ValueError, match="stacks 4 stages"):
        loss_fn(p, x, tgt)
    p = ts.params_from_numpy(_params(2, 2, seed=1), "cpu")
    with pytest.raises(ValueError, match="must split over dp=2"):
        loss_fn(p, x[:, :3], tgt[:, :3])
    with pytest.raises(ValueError, match="does not shard over tp=3"):
        ts.shard_params(p, dict(shape, tp=3), **CPU)
    assert ts.shard_params(p, shape, **CPU)["w1"] is p["w1"]
