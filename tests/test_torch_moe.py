"""The port's Switch MoE and forward stage against the JAX package's.

The same seeded numpy weights and tokens go through the reference's
``make_moe`` / ``switch_moe_local`` / ``make_infer_step`` on the 8-device
virtual CPU mesh and through the port's, whose ep ranks are stacked on
the CPU and whose expert exchanges are the plain all-to-all that
``all_to_all_cuda`` runs for tensors on the CPU.

Bars:
  * routing (each assignment's expert, bucket position and keep, which
    rows come out exactly zero): exact. The reference's routing is read
    off its own code (``_ref_routing``: moe.py's statements in JAX, rank
    by rank);
  * outputs: ``rtol=1e-5, atol=1e-6``. Both packages compute the same f32
    products, softmax and sums; they differ by float reassociation only;
  * the port against its own dense reference: the reference tests' bar,
    ``rtol=atol=2e-5`` (``tests/test_pipeline_moe.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

from dpu_operator_tpu.parallel import moe as ref
from dpu_operator_tpu.parallel import train_step as ref_ts
from dpu_operator_tpu.serving import infer as ref_infer
from dpu_operator_tpu_torch.parallel import moe
from dpu_operator_tpu_torch.parallel import ring_probe as rp
from dpu_operator_tpu_torch.parallel import train_step as ts
from dpu_operator_tpu_torch.serving import infer

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
DENSE_TOL = 2e-5
CPU = dict(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _weights(E, d, h, seed):
    """(router_w, w1, w2) at ``demo_moe_params``' shapes and scales."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
            for shape, fan_in in (((d, E), d), ((E, d, h), d),
                                  ((E, h, d), h))]


def _tokens(t, d, seed):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _ep_mesh(E):
    return Mesh(np.array(jax.devices()[:E]), ("ep",))


def _ref_moe(x, rw, w1, w2, E, cf, top_k):
    mesh = _ep_mesh(E)
    fn = jax.jit(ref.make_moe(mesh, capacity_factor=cf, top_k=top_k))
    return np.asarray(fn(x, rw, ref.shard_expert_params(w1, mesh),
                         ref.shard_expert_params(w2, mesh)))


@functools.partial(jax.jit, static_argnums=(2, 3))
@functools.partial(jax.vmap, in_axes=(0, None, None, None, 0))
def _ref_routing(y, router_w, cf, top_k, row_mask):
    """``switch_moe_local``'s routing statements (moe.py:56-76) in JAX,
    rank by rank over y [E, rows, d]: (expert_all, pos_a, keep). An
    all-ones ``row_mask`` routes as no mask does."""
    E = router_w.shape[1]
    rows = y.shape[0]
    C = int(np.ceil(top_k * rows / E * cf))
    gate = jax.nn.softmax(y @ router_w, axis=-1)
    _, experts = lax.top_k(gate, top_k)
    expert_all = experts.T.reshape(-1)
    onehot = jax.nn.one_hot(expert_all, E, dtype=y.dtype)
    mask_all = jnp.tile(row_mask.astype(y.dtype), top_k)
    onehot = onehot * mask_all[:, None]
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos_a = jnp.sum(pos * onehot, axis=-1).astype(jnp.int32)
    keep = (pos_a < C).astype(y.dtype) * mask_all
    return expert_all, pos_a, keep


def _check_routing(x, rw, E, cf, top_k, mask=None):
    rows = x.shape[0] // E
    y = x.reshape(E, rows, -1)
    got = moe.route(_t(y), _t(rw), capacity_factor=cf, top_k=top_k,
                    row_mask=None if mask is None else torch.from_numpy(
                        mask.reshape(E, rows)))
    assert got["C"] == int(np.ceil(top_k * rows / E * cf))
    ones = np.ones((E, rows), np.float32)
    want = _ref_routing(y, rw, cf, top_k,
                        ones if mask is None else mask.reshape(E, rows))
    for name, w in zip(("expert", "pos", "keep"), want):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w))


# -- switch_moe_local / make_moe against the reference --------------------------


@pytest.mark.parametrize("E", [2, 4, 8])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", ["dropless", "C=1"])
def test_make_moe_matches_reference(E, top_k, capacity):
    d, h, rows = 16, 32, 4
    t = E * rows
    rw, w1, w2 = _weights(E, d, h, seed=E + 10 * top_k)
    x = _tokens(t, d, seed=E * top_k)
    # Dropless: C = top_k·rows, every assignment of a rank fits one
    # expert. C = 1: one assignment a (source rank, expert) pair.
    cf = float(E) if capacity == "dropless" else E / (top_k * rows)
    _check_routing(x, rw, E, cf, top_k)
    want = _ref_moe(x, rw, w1, w2, E, cf, top_k)
    got = moe.make_moe({"ep": E}, capacity_factor=cf, top_k=top_k, **CPU)(
        _t(x), _t(rw), _t(w1), _t(w2)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal((got == 0).all(1), (want == 0).all(1))
    if capacity == "C=1":
        assert (want == 0).all(1).any()  # drops were exercised
    else:
        dense = moe.dense_reference(_t(x), _t(rw), _t(w1), _t(w2),
                                    top_k=top_k).numpy()
        np.testing.assert_allclose(got, dense, rtol=DENSE_TOL,
                                   atol=DENSE_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_switch_moe_local_row_mask_matches_reference(top_k):
    """Masked rows take no bucket position and give zero output: at C = 1
    a masked row ahead of a real one must not steal its slot."""
    E, d, h, rows = 4, 8, 16, 4
    rw, w1, w2 = _weights(E, d, h, seed=3)
    x = _tokens(E * rows, d, seed=5)
    mask = np.ones(E * rows, np.float32)
    mask[::3] = 0
    cf = E / (top_k * rows)
    _check_routing(x, rw, E, cf, top_k, mask)
    mesh = _ep_mesh(E)
    from dpu_operator_tpu.parallel._compat import shard_map
    from jax.sharding import PartitionSpec as P

    def per_device(xl, ml, w1l, w2l):
        return ref.switch_moe_local(xl, jnp.asarray(rw), w1l[0], w2l[0],
                                    axis="ep", capacity_factor=cf,
                                    top_k=top_k, row_mask=ml)

    want = np.asarray(jax.jit(shard_map(
        per_device, mesh=mesh, in_specs=(P("ep"), P("ep"), P("ep"), P("ep")),
        out_specs=P("ep"), check_vma=False))(x, mask, w1, w2))
    got = moe.switch_moe_local(
        _t(x).view(E, rows, d), _t(rw), _t(w1), _t(w2), capacity_factor=cf,
        top_k=top_k, row_mask=torch.from_numpy(mask).view(E, rows)
    ).reshape(-1, d).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[mask == 0].any()


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_top_k_ties_break_toward_the_lower_index(top_k):
    """A zero router makes every gate equal: lax.top_k then picks experts
    0 .. k-1 in order, and so must the port (a first maximum for k = 1)."""
    E, rows = 4, 3
    gate = torch.full((E, rows, E), 1.0 / E)
    vals, idx = moe.top_k_experts(gate, top_k)
    want_v, want_i = lax.top_k(jnp.full((rows, E), 1.0 / E), top_k)
    for r in range(E):
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(vals[r].numpy(), np.asarray(want_v))


def test_exchange_is_the_all_to_all_of_the_stacked_buckets():
    """The reference's lax.all_to_all(disp, "ep", 0, 0, tiled=True) on each
    rank's [E, C, d] buckets equals all_to_all_plain on their [E·E·C, d]
    stack with n = E, bit for bit."""
    from dpu_operator_tpu.parallel._compat import shard_map
    from jax.sharding import PartitionSpec as P

    E, C, d = 4, 3, 5
    disp = np.arange(E * E * C * d, dtype=np.float32).reshape(E * E, C, d)
    want = np.asarray(shard_map(
        lambda b: lax.all_to_all(b, "ep", 0, 0, tiled=True),
        mesh=_ep_mesh(E), in_specs=P("ep"), out_specs=P("ep"),
        check_vma=False)(disp))
    got = rp.all_to_all_plain(_t(disp).reshape(-1, d), E)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, d))


# -- the reference's own MoE tests, on the port ----------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_dense_reference(top_k):
    """test_pipeline_moe.py's dense-reference checks: at a capacity that
    holds every assignment, dispatch + exchange + combine equal every
    expert computed densely, the port's and the reference's."""
    E, t, d, h = 4, 32, 16, 32
    rw, w1, w2 = _weights(E, d, h, seed=13 if top_k == 2 else 0)
    x = _tokens(t, d, seed=17)
    out = moe.make_moe({"ep": E}, capacity_factor=float(E) * top_k,
                       top_k=top_k, **CPU)(_t(x), _t(rw), _t(w1), _t(w2))
    dense = moe.dense_reference(_t(x), _t(rw), _t(w1), _t(w2), top_k=top_k)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=DENSE_TOL,
                               atol=DENSE_TOL)
    want = np.asarray(ref.dense_reference(x, rw, w1, w2, top_k=top_k))
    np.testing.assert_allclose(dense.numpy(), want, rtol=RTOL, atol=ATOL)


def test_moe_top2_rank_priority_under_pressure():
    """Rank-0 assignments win bucket slots over rank-1 ones: with capacity
    sized exactly to the rank-0 load, no token loses its primary."""
    d, h, t = 8, 16, 8
    rng = np.random.RandomState(23)
    router_w = np.stack([np.ones(d), -np.ones(d)], axis=1).astype(
        np.float32) * 0.5
    w1 = (rng.randn(2, d, h) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.randn(2, h, d) / np.sqrt(h)).astype(np.float32)
    signs = np.where(np.arange(t) % 2 == 0, 1.0, -1.0)
    x = (np.abs(rng.randn(t, d)) * signs[:, None]).astype(np.float32)
    # cf=0.5 with k=2: C = ceil(2*4/2*0.5) = 2, the rank-0 load.
    out = moe.switch_moe_local(_t(x).view(2, 4, d), _t(router_w), _t(w1),
                               _t(w2), capacity_factor=0.5, top_k=2)
    assert not np.any(np.all(out.reshape(t, d).numpy() == 0, axis=1))


def test_moe_top_k_out_of_range_rejected_clearly():
    for k in (3, 0):
        with pytest.raises(ValueError, match=f"top_k={k}"):
            moe.make_moe({"ep": 2}, top_k=k, **CPU)
        with pytest.raises(ValueError, match=f"top_k={k}") as want:
            ref.make_moe(_ep_mesh(2), top_k=k)
        with pytest.raises(ValueError) as got:
            moe.make_moe({"ep": 2}, top_k=k, **CPU)
        assert str(got.value) == str(want.value)


def test_moe_capacity_drops_are_exact():
    """Over-capacity tokens drop to ZERO output, and only those: with
    capacity 1 a source rank, each expert serves its first-routed token
    exactly, everything else is zero."""
    E, t, d, h = 2, 8, 8, 16
    rw, w1, w2 = _weights(E, d, h, seed=5)
    x = _tokens(t, d, seed=9)
    t_local = t // E
    out = moe.make_moe({"ep": E}, capacity_factor=E / t_local, **CPU)(
        _t(x), _t(rw), _t(w1), _t(w2)).numpy()
    dense = moe.dense_reference(_t(x), _t(rw), _t(w1), _t(w2)).numpy()
    expert = (x @ rw).argmax(-1)
    served = set()
    for i in range(t):
        key = (i // t_local, int(expert[i]))
        if key not in served:
            served.add(key)
            np.testing.assert_allclose(out[i], dense[i], rtol=DENSE_TOL,
                                       atol=DENSE_TOL)
        else:
            np.testing.assert_array_equal(out[i], np.zeros(d))
    np.testing.assert_allclose(
        out, _ref_moe(x, rw, w1, w2, E, E / t_local, 1), rtol=RTOL,
        atol=ATOL)


def test_make_moe_checks_experts_router_and_device():
    E, d, h = 2, 8, 16
    rw, w1, w2 = (_t(a) for a in _weights(E, d, h, seed=1))
    x = _t(_tokens(4, d, seed=2))
    fn = moe.make_moe({"ep": E}, **CPU)
    with pytest.raises(ValueError, match="local chunk of 2"):
        fn(x, rw, torch.cat([w1, w1]), torch.cat([w2, w2]))
    with pytest.raises(ValueError, match="router width 3 != 2"):
        fn(x, torch.zeros(d, 3), w1, w2)
    with pytest.raises(ValueError, match="do not shard"):
        fn(x[:3], rw, w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        moe.make_moe({"ep": E}, kernel="cuda", **CPU)
    with pytest.raises(ValueError, match="at most 8 ranks"):
        moe.pick_exchange("cuda", 16)
    # Kernel 10 with its gradient (one launch each way).
    assert moe.pick_exchange("cuda", 8) is moe.kernel_exchange
    assert moe.pick_exchange("torch", 16) is rp.all_to_all_plain
    assert moe.shard_expert_params(w1, {"ep": E}) is w1
    r, a, b = moe.demo_moe_params(4, 8, 16, seed=3, **CPU)
    assert (r.shape, a.shape, b.shape) == ((8, 4), (4, 8, 16), (4, 16, 8))
    again = moe.demo_moe_params(4, 8, 16, seed=3, **CPU)
    assert all(torch.equal(u, v) for u, v in zip((r, a, b), again))


# -- the forward stage and the infer step ---------------------------------------


def _ref_params(S, d, h, E, seed):
    """Weights in the reference's ``init_params`` layout and scales."""
    rng = np.random.RandomState(seed)
    shapes = {"w1": ((S, d, h), d), "w2": ((S, h, d), h),
              "router": ((S, d, E), d), "moe_w1": ((S, E, d, h), d),
              "moe_w2": ((S, E, h, d), h)}
    return {k: (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
            for k, (shape, fan_in) in shapes.items()}


_REF_STEPS = {}


def _ref_case(ep, cf):
    """Two stages with idle (zero) rows among the active ones: the
    reference's params, tokens and infer-step output, computed once a
    case (one XLA compile)."""
    if (ep, cf) not in _REF_STEPS:
        d, h, B = 8, 16, 8
        params = _ref_params(2, d, h, ep, seed=10 + ep)
        x = _tokens(B, d, seed=20 + ep + int(cf))
        x[[1, 6]] = 0
        mesh = ref_infer.serving_mesh(shape={"ep": ep})
        step = ref_infer.make_infer_step(mesh, capacity_factor=cf)
        _REF_STEPS[(ep, cf)] = (params, x, np.asarray(
            step(ref_ts.shard_params(params, mesh), x)))
    return _REF_STEPS[(ep, cf)]


@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_stage_fn_matches_reference(ep, cf):
    """The port's ``_stage_fn`` on the stacked ranks, stage by stage with
    the idle-row mask, against the reference's two-stage infer step."""
    params, x, want = _ref_case(ep, cf)
    B, d = x.shape
    p = ts.params_from_numpy(params, "cpu")
    y = _t(x).view(ep, B // ep, d)
    active = (y != 0).any(dim=-1)
    for s in range(2):
        y = ts._stage_fn({k: v[s] for k, v in p.items()}, y, E=ep,
                         tp_axis="tp", ep_axis="ep", capacity_factor=cf,
                         row_mask=active)
    np.testing.assert_allclose(y.reshape(B, d).numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_infer_step_matches_reference(ep, cf):
    params, x, want = _ref_case(ep, cf)
    mesh = infer.serving_mesh(shape={"ep": ep})
    step = infer.make_infer_step(mesh, cf, **CPU)
    assert step.kernel == "torch"
    got = step(ts.shard_params(params, mesh, "cpu"), x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[[1, 6]].any()


def test_stage_fn_keeps_the_reference_errors():
    d, h, E = 8, 16, 2
    params = _ref_params(1, d, h, E, seed=0)
    p = {k: v[0] for k, v in ts.params_from_numpy(params, "cpu").items()}
    x = torch.ones(E, 2, d)
    kw = dict(E=E, tp_axis="tp", ep_axis="ep", capacity_factor=1.0)
    bad = dict(p, moe_w1=torch.cat([p["moe_w1"]] * 2),
               moe_w2=torch.cat([p["moe_w2"]] * 2))
    with pytest.raises(ValueError) as got:
        ts._stage_fn(bad, x, **kw)
    assert str(got.value) == (
        "expert count must equal the ep axis size 2: each device hosts one "
        "expert, got a local chunk of 2")
    with pytest.raises(ValueError) as got:
        ts._stage_fn(dict(p, router=torch.zeros(d, 3)), x, **kw)
    assert str(got.value) == ("router width 3 != 2 experts — tokens routed "
                              "past the mesh would silently drop")
    # The attention branch: without seq_shape the reference's error; with
    # it, the E ranks' rows (one sequence of 2 tokens a rank) attended as
    # one sequence in rank order, then the stage.
    rng = np.random.RandomState(1)
    attn = {k: torch.from_numpy((rng.randn(d, d) / np.sqrt(d)).astype(
        np.float32)) for k in ("wq", "wk", "wv")}
    with pytest.raises(ValueError) as got:
        ts._stage_fn(dict(p, **attn), x, **kw)
    assert str(got.value) == (
        "attention params present but no seq_shape — the stage cannot know "
        "where batch elements begin and end")
    x = torch.from_numpy(rng.randn(E, 2, d).astype(np.float32))
    y = ts._stage_fn(dict(p, **attn), x, seq_shape=(1, 2),
                     attn_axes=("sp", "ep"), attn_ring=E, **kw)
    assert y.shape == x.shape
    seq = x.reshape(1, E * 2, d)
    h = seq + ts._dense_causal_attention(seq, attn["wq"], attn["wk"],
                                         attn["wv"])
    torch.testing.assert_close(y, ts._stage_fn(p, h.reshape(E, 2, d), **kw),
                               rtol=1e-5, atol=1e-6)


def test_params_layout_specs_and_placement():
    params = ts.init_params(2, 8, 16, 4, seed=7, **CPU)
    ref_params = jax.eval_shape(lambda: ref_ts.init_params(2, 8, 16, 4))
    assert set(params) == set(ref_params) == set(ts.param_specs())
    for k, v in params.items():
        assert tuple(v.shape) == ref_params[k].shape
        assert v.dtype == torch.float32
    again = ts.init_params(2, 8, 16, 4, seed=7, **CPU)
    assert all(torch.equal(params[k], again[k]) for k in params)
    specs = ref_ts.param_specs()
    assert {k: tuple(v) for k, v in specs.items()} == ts.param_specs()
    mesh = infer.serving_mesh(shape={"ep": 4})
    placed = ts.shard_params(params, mesh, "cpu")
    assert all(placed[k] is params[k] for k in params)  # no copy
    with pytest.raises(ValueError, match="router width"):
        ts.shard_params(params, infer.serving_mesh(shape={"ep": 2}), "cpu")
    # attention=True: wq/wk/wv [S, d, d] beside the five, as the
    # reference's, replicated over every axis but pp, and carried across.
    attn = ts.init_params(2, 8, 16, 4, seed=7, attention=True, **CPU)
    ref_attn = jax.eval_shape(
        lambda: ref_ts.init_params(2, 8, 16, 4, attention=True))
    assert set(attn) == set(ref_attn) == set(ts.param_specs(True))
    for k, v in attn.items():
        assert tuple(v.shape) == ref_attn[k].shape
    assert all(torch.equal(attn[k], params[k]) for k in params)
    assert {k: tuple(v) for k, v in ref_ts.param_specs(True).items()} == (
        ts.param_specs(True))
    carried = ts.params_from_numpy({k: v.numpy() for k, v in attn.items()},
                                   "cpu")
    assert all(torch.equal(carried[k], attn[k]) for k in attn)
    placed = ts.shard_params(attn, mesh, "cpu")
    assert set(placed) == set(attn) and placed["wq"] is attn["wq"]
