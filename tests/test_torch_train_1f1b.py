"""The port's 1F1B training step and the stage's attention branch against
the JAX package's.

The same seeded numpy weights (the reference's ``init_params`` layout and
scales, wq/wk/wv included, carried across by
``train_step.params_from_numpy``), inputs and targets go through the
reference's jitted steps on the 8-device virtual CPU mesh and through the
port's, whose ranks of every axis are stacked on the CPU and whose expert
exchanges are the plain all-to-all, at the shapes of
``tests/test_train_step.py``.

Bars (the reference's own, of its distributed steps against its dense
twin):
  * loss: ``rtol=2e-5``;
  * gradients (without attention, those the 1F1B update implies):
    ``rtol=5e-4, atol=1e-6``; with attention ``rtol=1e-3, atol=1e-6``;
  * ``ring_attention_batched`` against the reference's XLA ring and the
    dense causal attention: ``rtol=atol=1e-5`` (values of order 1, f32
    sums over at most 32 keys in another order);
  * the 1F1B step against the port's GPipe step on the same model: the
    forward is the same stage on the same inputs, so only the loss's sum
    and each weight's sum over its microbatches run in another order:
    loss ``rtol=1e-6``, gradients ``rtol=1e-5, atol=1e-8``;
  * the kernel exchange's step against the plain exchange's: bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

from dpu_operator_tpu.parallel import ring_attention as ref_ra
from dpu_operator_tpu.parallel import train_step as ref
from dpu_operator_tpu.parallel._compat import shard_map
from dpu_operator_tpu_torch.parallel import moe
from dpu_operator_tpu_torch.parallel import ring_attention as ra
from dpu_operator_tpu_torch.parallel import ring_probe as rp
from dpu_operator_tpu_torch.parallel import train_step as ts

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
ATTN_GRAD_RTOL = 1e-3
RING_TOL = 1e-5
TWIN_LOSS_RTOL = 1e-6
TWIN_GRAD_RTOL, TWIN_GRAD_ATOL = 1e-5, 1e-8
LR = 0.05
CPU = dict(device="cpu")
D, H = 8, 16

# tests/test_train_step.py:93 and :223, :266 (b): (mesh, v, M, mb, seq,
# attention, token_shard_ep).
CASES = {
    "dp2-pp2-ep2-v1": ({"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2}, 1, 4,
                       8, 2, False, True),
    "pp2-tp2-ep2-v2": ({"dp": 1, "pp": 2, "sp": 1, "tp": 2, "ep": 2}, 2, 4,
                       4, 2, False, True),
    "replicated-ep": ({"dp": 1, "pp": 2, "sp": 1, "tp": 2, "ep": 2}, 2, 4,
                      4, 2, False, False),
    "attn-pp2-sp2-ep2": ({"dp": 1, "pp": 2, "sp": 2, "tp": 1, "ep": 2}, 1,
                         3, 2, 16, True, True),
    "attn-pp2-ep2-v2": ({"dp": 1, "pp": 2, "sp": 1, "tp": 1, "ep": 2}, 2, 4,
                        2, 8, True, True),
}
# tests/test_train_step.py:178 and :266 (a): the GPipe step with attention.
GPIPE_ATTN = {
    "dp2-sp2-ep2": ({"dp": 2, "pp": 1, "sp": 2, "tp": 1, "ep": 2}, 2, 4,
                    16, True),
    "pp2-sp2-tp2": ({"dp": 1, "pp": 2, "sp": 2, "tp": 2, "ep": 1}, 2, 2,
                    8, True),
    "replicated-ep": ({"dp": 1, "pp": 1, "sp": 2, "tp": 1, "ep": 2}, 2, 2,
                      8, False),
}


def _params(S, E, seed, attention, d=D, h=H):
    """Weights in the reference's ``init_params`` layout and scales."""
    rng = np.random.RandomState(seed)
    shapes = {"w1": ((S, d, h), d), "w2": ((S, h, d), h),
              "router": ((S, d, E), d), "moe_w1": ((S, E, d, h), d),
              "moe_w2": ((S, E, h, d), h)}
    if attention:
        shapes.update({k: ((S, d, d), d) for k in ("wq", "wk", "wv")})
    return {k: (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
            for k, (shape, fan_in) in shapes.items()}


def _data(M, mb, seq, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, mb, seq, D).astype(np.float32),
            rng.randn(M, mb, seq, D).astype(np.float32))


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(*shape.values()),
                tuple(shape.keys()))


def _case(name):
    """(shape, v, M, params, x, tgt, cf, attention, token_shard_ep),
    numpy, of one 1F1B case; params in the natural stage order."""
    shape, v, M, mb, seq, attention, tse = CASES[name]
    seed = sorted(CASES).index(name)
    params = _params(shape["pp"] * v, shape["ep"], 5 + seed, attention)
    x, tgt = _data(M, mb, seq, 40 + seed)
    return shape, v, M, params, x, tgt, float(shape["ep"]), attention, tse


def _implied(before, after):
    """The gradients an SGD update at LR implies, natural order."""
    return {k: (np.asarray(before[k]) - np.asarray(after[k])) / LR
            for k in before}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's jitted 1F1B step on the case: its loss and the
    gradients its update implies (natural order)."""
    shape, v, M, params, x, tgt, cf, attention, tse = _case(name)
    pp = shape["pp"]
    mesh = _mesh(shape)
    step = ref.make_train_step_1f1b(mesh, capacity_factor=cf, lr=LR, M=M,
                                    v=v, token_shard_ep=tse,
                                    attention=attention)
    inter = ref.interleave_params(params, pp, v)
    loss, new = step(ref.shard_params(inter, mesh), x, tgt)
    return float(loss), ref.uninterleave_params(_implied(inter, new), pp, v)


def _port_step(name, kernel=None):
    shape, v, M, params, x, tgt, cf, attention, tse = _case(name)
    step = ts.make_train_step_1f1b(shape, capacity_factor=cf, lr=LR, M=M,
                                   v=v, token_shard_ep=tse,
                                   attention=attention, kernel=kernel, **CPU)
    p = ts.interleave_params(ts.params_from_numpy(params, "cpu"),
                             shape["pp"], v)
    return step, p, torch.from_numpy(x), torch.from_numpy(tgt)


def _check(got, want, rtol, atol, what):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- the 1F1B step against the reference's ----------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_1f1b_step_matches_reference(name):
    """Loss == the reference's 1F1B step and the dense twin (the port's,
    held against the reference's in test_torch_train_step.py and below);
    the gradients the update implies == the reference's implied gradients
    and the dense twin's (a copied ``1/replicas`` cotangent scale would
    divide every gradient by tp); the update is p - lr·g of
    ``loss_and_grads``; the step descends."""
    shape, v, _, params, _, _, cf, attention, tse = _case(name)
    pp = shape["pp"]
    want_loss, want_implied = _reference(name)
    step, p, x, tgt = _port_step(name)
    loss, grads = step.loss_and_grads(p, x, tgt)
    dense_loss, dense_grads = ts.value_and_grad(
        lambda q, a, b: ts.dense_loss_reference(
            q, a, b, capacity_factor=cf, shards=shape,
            token_shard_ep=tse),
        ts.params_from_numpy(params, "cpu"), x, tgt)
    dense_loss = float(dense_loss)
    dense_grads = {k: g.numpy() for k, g in dense_grads.items()}
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), dense_loss, rtol=LOSS_RTOL)
    loss1, new = step(p, x, tgt)
    assert torch.equal(loss1, loss)
    for k in p:
        assert torch.equal(new[k], p[k] - LR * grads[k]), k
    implied = ts.uninterleave_params(
        {k: t.numpy() for k, t in grads.items()}, pp, v)
    rtol = ATTN_GRAD_RTOL if attention else GRAD_RTOL
    _check(implied, want_implied, rtol, GRAD_ATOL, "vs reference's update")
    _check(implied, dense_grads, rtol, GRAD_ATOL, "vs dense twin")
    loss2, _ = step(new, x, tgt)
    assert float(loss2) < float(loss1), (float(loss1), float(loss2))


def test_1f1b_step_capacity_drops_still_train():
    """cf 0.5 (rows dropped): finite, descending over two steps, and the
    reference's loss (tests/test_train_step.py:72's drops, in 1F1B)."""
    shape = {"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2}
    params = _params(2, 2, seed=9, attention=False)
    x, tgt = _data(2, 8, 2, seed=4)
    mesh = _mesh(shape)
    ref_step = ref.make_train_step_1f1b(mesh, capacity_factor=0.5, lr=0.01,
                                        M=2)
    want, _ = ref_step(ref.shard_params(params, mesh), x, tgt)
    step = ts.make_train_step_1f1b(shape, capacity_factor=0.5, lr=0.01,
                                   M=2, **CPU)
    x, tgt = torch.from_numpy(x), torch.from_numpy(tgt)
    loss1, new = step(ts.params_from_numpy(params, "cpu"), x, tgt)
    loss2, _ = step(new, x, tgt)
    np.testing.assert_allclose(float(loss1), float(want), rtol=LOSS_RTOL)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss1)


@pytest.mark.parametrize("name", ["pp2-tp2-ep2-v2", "attn-pp2-ep2-v2",
                                  "replicated-ep"])
def test_1f1b_step_matches_the_gpipe_step_on_the_same_model(name):
    """pp·v chunks are the GPipe step's pp·v stages: the same loss and
    gradients within the reordered sums' bar."""
    shape, v, M, params, x, tgt, cf, attention, tse = _case(name)
    step, p, xt, tt = _port_step(name)
    loss, grads = step.loss_and_grads(p, xt, tt)
    gpipe_mesh = dict(shape, pp=shape["pp"] * v)
    _, loss_fn = ts.make_train_step(gpipe_mesh, capacity_factor=cf,
                                    token_shard_ep=tse, attention=attention,
                                    **CPU)
    g_loss, g_grads = ts.value_and_grad(
        loss_fn, ts.params_from_numpy(params, "cpu"), xt, tt)
    np.testing.assert_allclose(float(loss), float(g_loss),
                               rtol=TWIN_LOSS_RTOL)
    got = ts.uninterleave_params(grads, shape["pp"], v)
    _check(got, {k: g.numpy() for k, g in g_grads.items()}, TWIN_GRAD_RTOL,
           TWIN_GRAD_ATOL, "1F1B vs GPipe")


# -- the attention branch -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gpipe_attn_reference(name):
    shape, M, mb, seq, tse = GPIPE_ATTN[name]
    params = _params(shape["pp"], shape["ep"], 11, attention=True)
    x, tgt = _data(M, mb, seq, 12)
    mesh = _mesh(shape)
    _, loss_fn = ref.make_train_step(mesh, capacity_factor=shape["ep"],
                                     token_shard_ep=tse, attention=True)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        ref.shard_params(params, mesh), x, tgt)
    dense = jax.jit(lambda p: ref.dense_loss_reference(
        p, x, tgt, capacity_factor=shape["ep"], shards=shape,
        token_shard_ep=tse))(params)
    return (params, x, tgt, float(loss), jax.tree.map(np.asarray, grads),
            float(dense))


@pytest.mark.parametrize("name", sorted(GPIPE_ATTN))
def test_gpipe_step_with_attention_matches_reference(name):
    """make_train_step(attention=True): loss and every gradient leaf ==
    the reference's distributed step (the ring over ("sp", "ep"), or sp
    alone with replicated ep) and the port's dense twin == the reference's
    twin; the step descends."""
    shape, _, _, _, tse = GPIPE_ATTN[name]
    params, x, tgt, want_loss, want_grads, want_dense = (
        _gpipe_attn_reference(name))
    cf = float(shape["ep"])
    step, loss_fn = ts.make_train_step(shape, capacity_factor=cf,
                                       token_shard_ep=tse, attention=True,
                                       **CPU)
    p = ts.params_from_numpy(params, "cpu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(tgt)
    loss, grads = ts.value_and_grad(loss_fn, p, xt, tt)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _check({k: g.numpy() for k, g in grads.items()}, want_grads,
           ATTN_GRAD_RTOL, GRAD_ATOL, "gpipe attention")
    dense = ts.dense_loss_reference(p, xt, tt, capacity_factor=cf,
                                    shards=shape, token_shard_ep=tse)
    np.testing.assert_allclose(float(dense), want_dense, rtol=LOSS_RTOL)
    loss1, new = step(p, xt, tt)
    assert float(loss_fn(new, xt, tt)) < float(loss1)


@pytest.mark.parametrize("n,causal", [(1, True), (2, True), (4, True),
                                      (4, False), (8, True)])
def test_ring_attention_batched_matches_reference_and_dense(n, causal):
    """Values == the reference's ``xla_ring_attention_batched`` in a
    shard_map over n ranks; values and the gradients of q, k and v == the
    port's dense causal attention (causal) or plain softmax attention."""
    B, S, dk = 2, 4 * n, 6
    rng = np.random.RandomState(n + 10 * causal)
    q, k, v = (rng.randn(B, S, dk).astype(np.float32) for _ in range(3))
    cot = rng.randn(B, S, dk).astype(np.float32)
    ring = shard_map(
        lambda a, b, c: ref_ra.xla_ring_attention_batched(a, b, c, "sp", n,
                                                          causal),
        mesh=Mesh(np.array(jax.devices()[:n]), ("sp",)),
        in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
        check_vma=False)
    want, vjp = jax.vjp(jax.jit(ring), q, k, v)
    want_grads = vjp(cot)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = ra.ring_attention_batched(qt, kt, vt, n, causal)
    got_grads = torch.autograd.grad(got, [qt, kt, vt], torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RING_TOL, atol=RING_TOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RING_TOL,
                                   atol=RING_TOL)
    s = torch.einsum("bqd,bkd->bqk", qt, kt) / np.sqrt(dk)
    if causal:
        s = torch.where(torch.tril(torch.ones(S, S, dtype=torch.bool)), s,
                        torch.tensor(-1e30))
    dense = torch.softmax(s, dim=-1) @ vt
    dense_grads = torch.autograd.grad(dense, [qt, kt, vt],
                                      torch.from_numpy(cot))
    torch.testing.assert_close(got, dense, rtol=RING_TOL, atol=RING_TOL)
    for g, w in zip(got_grads, dense_grads):
        torch.testing.assert_close(g, w, rtol=RING_TOL, atol=RING_TOL)
    if causal:  # the projections' twin in train_step is this attention
        eye = torch.eye(dk)
        twin = ts._dense_causal_attention(qt.detach(), eye, eye, eye)
        want_twin = ref._dense_causal_attention(q, *(np.eye(dk),) * 3)
        np.testing.assert_allclose(twin.numpy(), np.asarray(want_twin),
                                   rtol=RING_TOL, atol=RING_TOL)


def test_stage_attention_regroups_the_token_ranks():
    """The stage's attention on [G, E, rows, d] (dp 2 × sp 2 groups, ep 2,
    2 sequences of 2 tokens a rank) == each whole sequence, in sp-major
    then ep order, through the dense causal attention, cut back."""
    dp, sp, E, mb_loc, piece = 2, 2, 2, 2, 2
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(dp * sp, E, mb_loc * piece, D).astype(
        np.float32))
    w = [torch.from_numpy((rng.randn(D, D) / np.sqrt(D)).astype(np.float32))
         for _ in range(3)]
    p = dict(zip(("wq", "wk", "wv"), w))
    got = ts._attend(p, x, (mb_loc, piece), ("sp", "ep"), sp * E)
    seqs = x.reshape(dp, sp, E, mb_loc, piece, D).permute(
        0, 3, 1, 2, 4, 5).reshape(dp * mb_loc, sp * E * piece, D)
    want = seqs + ts._dense_causal_attention(seqs, *w)
    want = want.reshape(dp, mb_loc, sp, E, piece, D).permute(
        0, 2, 3, 1, 4, 5).reshape(x.shape)
    torch.testing.assert_close(got, want, rtol=RING_TOL, atol=RING_TOL)
    # sp alone (replicated ep): rank 0's tokens attended once, the result
    # added to every ep rank's rows.
    rep = x[:, :1].expand(x.shape)
    got = ts._attend(p, rep, (mb_loc, piece), "sp", sp)
    seqs = x[:, 0].reshape(dp, sp, mb_loc, piece, D).permute(
        0, 2, 1, 3, 4).reshape(dp * mb_loc, sp * piece, D)
    attn = ts._dense_causal_attention(seqs, *w).reshape(
        dp, mb_loc, sp, piece, D).permute(0, 2, 1, 3, 4).reshape(
        dp * sp, 1, mb_loc * piece, D)
    torch.testing.assert_close(got, rep + attn, rtol=RING_TOL, atol=RING_TOL)
    with pytest.raises(ValueError, match="does not cut x"):
        ts._attend(p, x, (3, piece), ("sp", "ep"), sp * E)
    with pytest.raises(ValueError, match="attn_axes"):
        ts._attend(p, x, (mb_loc, piece), None, sp * E)


# -- kernel 10 on the 1F1B step -------------------------------------------------------


def _counting(monkeypatch):
    """Count the all-to-all wrapper's calls (on the CPU kernel_exchange
    runs its plain version) and the exchanges the stage makes, split by
    whether a graph was being recorded: the F units' forwards run without
    one, the B units' rematerialized forwards with one. The steps built
    after this take ``kernel="cuda"`` on the CPU too, so the factory's own
    ``pick_exchange`` picks the (counting) kernel_exchange."""
    calls, exchanges = [], {True: 0, False: 0}
    inner, kernel_exchange = rp.all_to_all_cuda, moe.kernel_exchange
    pick_kernel = ts.pick_kernel

    def counted(x, n):
        calls.append(n)
        return inner(x, n)

    def exchange(x, n):
        exchanges[torch.is_grad_enabled()] += 1
        return kernel_exchange(x, n)

    monkeypatch.setattr(rp, "all_to_all_cuda", counted)
    monkeypatch.setattr(moe, "kernel_exchange", exchange)
    monkeypatch.setattr(ts, "pick_kernel", lambda kernel, device: (
        "cuda" if kernel == "cuda" else pick_kernel(kernel, device)))
    return calls, exchanges


@pytest.mark.parametrize("name", ["dp2-pp2-ep2-v1", "attn-pp2-ep2-v2"])
def test_kernel_exchange_1f1b_launches_and_bits(name, monkeypatch):
    """With ``kernel="cuda"`` (as on the card): 2 launches an F unit, 4 a B
    unit (its forward again, then its backward): 6·S·M a step, 2·S·M of
    them in the F units; loss and every gradient == the plain exchange's,
    bit for bit."""
    shape, v, M = CASES[name][:3]
    S = shape["pp"] * v
    calls, exchanges = _counting(monkeypatch)
    step_p, p, x, tgt = _port_step(name, kernel="torch")
    plain = step_p.loss_and_grads(p, x, tgt)
    assert calls == [] and exchanges == {True: 0, False: 0}
    step_k = _port_step(name, kernel="cuda")[0]
    loss, grads = step_k.loss_and_grads(p, x, tgt)
    assert len(calls) == 6 * S * M and set(calls) == {shape["ep"]}
    assert exchanges == {False: 2 * S * M, True: 2 * S * M}
    assert _same_bits(loss, plain[0])
    for k in grads:
        assert _same_bits(grads[k], plain[1][k]), k


# -- checks ---------------------------------------------------------------------------


def test_make_train_step_1f1b_checks():
    shape = CASES["dp2-pp2-ep2-v1"][0]
    with pytest.raises(ValueError, match="M .microbatch count. is static"):
        ts.make_train_step_1f1b(shape, **CPU)
    with pytest.raises(ValueError, match=r"lacks the axes \['tp'\]"):
        ts.make_train_step_1f1b({k: v for k, v in shape.items()
                                 if k != "tp"}, M=2, **CPU)
    with pytest.raises(ValueError, match="CUDA"):
        ts.make_train_step_1f1b(shape, M=2, kernel="cuda", **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.make_train_step_1f1b(shape, M=2)
    step = ts.make_train_step_1f1b(shape, M=2, v=2, **CPU)
    assert step.schedule.stages == 4 and step.schedule.M == 2
    p = ts.params_from_numpy(_params(2, 2, seed=1, attention=False), "cpu")
    x, tgt = (torch.from_numpy(a) for a in _data(2, 8, 2, seed=2))
    with pytest.raises(ValueError, match="v=2 pipeline chunks"):
        step(p, x, tgt)
    step = ts.make_train_step_1f1b(shape, M=3, **CPU)
    with pytest.raises(ValueError, match="built for M=3"):
        step(p, x, tgt)
    attn = ts.make_train_step_1f1b(shape, M=2, attention=True, **CPU)
    with pytest.raises(ValueError, match="attention=True takes"):
        attn(p, x, tgt)
