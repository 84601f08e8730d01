"""The port's fabric-probe training step and mesh against the JAX package's.

``parallel/fabric_probe.py`` (``make_probe_train_step``, ``run_probe``,
``shard_probe_batch``) and ``parallel/mesh.py`` (``build_mesh``) on the
CPU, against the reference's on the 8-device virtual CPU mesh, on the
same parameters (the reference's ``init_probe_params(PRNGKey(1))``
carried across by ``probe_params_from_numpy``) and batch
(``probe_example_batch(PRNGKey(2), mesh)``).

Bars:
  * the loss: relative 1e-5. Both packages round the same products to
    bf16 and sum the f32 partials in the same order; the means differ by
    f32 reassociation;
  * the update ``(p0 - p1) / LR``: ``rtol=1e-2`` with ``atol`` 1e-2 of
    the largest magnitude. Its elements are bf16-rounded gradients (each
    rank's, summed over the dp·sp ranks in f32): two products rounded on
    either side of a bf16 boundary differ by one bf16 ulp, 2**-8 of the
    value.

The reference's update is tp × the gradient of its loss (the transpose of
its tp ``psum`` under ``shard_map(check_vma=False)`` is another
``psum``); the port reproduces the factor, and a test holds it.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from dpu_operator_tpu.parallel import fabric_probe as ref
from dpu_operator_tpu.parallel import mesh as ref_mesh
from dpu_operator_tpu_torch import parallel
from dpu_operator_tpu_torch.parallel import fabric_probe as fp
from dpu_operator_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-2  # and atol UPDATE_RTOL x the largest magnitude
AXES = ("dp", "sp", "tp")
SHAPES = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2)]


def _ref_mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axis_names=AXES)


def _ref_step(shape, batch=None):
    """(p0, batch, p1, loss) of one reference step on ``shape``, as numpy;
    ``batch`` None means ``probe_example_batch``'s for the mesh."""
    mesh = _ref_mesh(shape)
    param_sh, batch_sh = ref.probe_shardings(mesh)
    p0 = ref.init_probe_params(jax.random.PRNGKey(1))
    if batch is None:
        batch = ref.probe_example_batch(jax.random.PRNGKey(2), mesh)
    params = {k: jax.device_put(v, param_sh[k]) for k, v in p0.items()}
    p1, loss = ref.make_probe_train_step(mesh)(
        params, jax.device_put(batch, batch_sh))
    return ({k: np.asarray(v) for k, v in p0.items()}, np.array(batch),
            {k: np.asarray(v) for k, v in p1.items()}, float(loss))


def _port_step(shape, p0, batch):
    """(p1, loss) of one port step on ``shape``, as numpy."""
    mesh = dict(zip(AXES, shape))
    params = fp.probe_params_from_numpy(p0, "cpu")
    blocks = fp.shard_probe_batch(batch, mesh)
    p1, loss = fp.make_probe_train_step(mesh, "cpu")(params, blocks)
    return {k: v.numpy() for k, v in p1.items()}, float(loss)


def _update(p0, p1, name):
    return (p0[name] - p1[name]) / fp.LR


def _assert_update_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=UPDATE_RTOL,
                               atol=UPDATE_RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_step_matches_reference(shape):
    """One step at each mesh shape of the reference's dp/sp/tp split: the
    loss within relative 1e-5 and the update within the bf16 bar."""
    p0, batch, want_p1, want_loss = _ref_step(shape)
    got_p1, got_loss = _port_step(shape, p0, batch)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for name in fp.PARAM_SPEC:
        assert got_p1[name].dtype == np.float32
        _assert_update_close(_update(p0, got_p1, name),
                             _update(p0, want_p1, name), name)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_update_is_tp_times_the_dense_gradient(shape):
    """The update is tp × the gradient of the one-rank dense loss (the
    reference's step on one device on the same global batch, whose update
    is its gradient), in the reference and in the port: at tp = 2 twice
    the gradient, not once."""
    tp = shape[2]
    p0, batch, ref_p1, _ = _ref_step(shape)
    dense_p1 = _ref_step((1, 1, 1), batch)[2]
    got_p1, _ = _port_step(shape, p0, batch)
    for name in fp.PARAM_SPEC:
        grad = _update(p0, dense_p1, name)
        for p1, who in ((ref_p1, "reference"), (got_p1, "port")):
            _assert_update_close(_update(p0, p1, name), tp * grad,
                                 f"{who} {name}")
        if tp > 1:
            with pytest.raises(AssertionError):
                _assert_update_close(_update(p0, got_p1, name), grad, name)


def test_shard_probe_batch_is_the_reference_layout():
    """Rank (i, j)'s block of ``shard_probe_batch`` is what the reference
    places on the device at mesh coordinates (i, j, tp) for every tp."""
    mesh = _ref_mesh((2, 2, 2))
    batch = ref.probe_example_batch(jax.random.PRNGKey(2), mesh)
    placed = jax.device_put(batch, ref.probe_shardings(mesh)[1])
    blocks = fp.shard_probe_batch(np.array(batch), dict(mesh.shape))
    assert blocks.shape == (2, 2, fp.BLOCK_BATCH, fp.BLOCK_SEQ, fp.DIM)
    coords = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    for shard in placed.addressable_shards:
        i, j, _ = coords[shard.device.id]
        np.testing.assert_array_equal(blocks[i, j].numpy(),
                                      np.asarray(shard.data))


@pytest.mark.parametrize("n", [1, 8])
def test_run_probe_matches_reference(n):
    """The dry run's ``run_probe(build_mesh(n), steps=2)``: the reference's
    final loss equals two port steps on its parameters and batch within
    the loss bar; the port's own ``run_probe`` is finite and equals two
    steps on its own draws (seeds 1 and 2) bit for bit."""
    want = ref.run_probe(ref_mesh.build_mesh(n_devices=n), steps=2)
    mesh = pm.build_mesh(n)
    p0 = {k: np.asarray(v) for k, v in ref.init_probe_params(
        jax.random.PRNGKey(1)).items()}
    batch = np.array(ref.probe_example_batch(jax.random.PRNGKey(2),
                                             _ref_mesh(tuple(mesh.values()))))
    step = fp.make_probe_train_step(mesh, "cpu")
    params = fp.probe_params_from_numpy(p0, "cpu")
    blocks = fp.shard_probe_batch(batch, mesh)
    for _ in range(2):
        params, loss = step(params, blocks)
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)

    got = parallel.run_probe(mesh, steps=2, device="cpu")
    assert np.isfinite(got)
    params = fp.init_probe_params(1, "cpu")
    blocks = fp.shard_probe_batch(fp.probe_example_batch(2, mesh, "cpu"),
                                  mesh)
    for _ in range(2):
        params, loss = step(params, blocks)
    assert float(loss) == got


def test_loss_descends_and_repeats_bitwise():
    """Five steps at dp 2 × sp 2 × tp 2: the loss descends, and a second
    run of the same steps gives the same bits."""
    mesh = pm.build_mesh(8)
    step = fp.make_probe_train_step(mesh, "cpu")
    blocks = fp.shard_probe_batch(fp.probe_example_batch(2, mesh, "cpu"),
                                  mesh)
    runs = []
    for _ in range(2):
        params, losses = fp.init_probe_params(1, "cpu"), []
        for _ in range(5):
            params, loss = step(params, blocks)
            losses.append(float(loss))
        runs.append((losses, params))
    losses = runs[0][0]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert runs[1][0] == losses
    for name in fp.PARAM_SPEC:
        assert torch.equal(runs[0][1][name], runs[1][1][name])


def test_a_non_finite_hand_off_reaches_the_loss():
    """The ring term enters the loss as ``0.0 * ring_acc``: a non-finite
    value in a block handed along sp makes the loss non-finite."""
    mesh = pm.build_mesh(4)  # dp 1, sp 2, tp 2
    step = fp.make_probe_train_step(mesh, "cpu")
    blocks = fp.shard_probe_batch(fp.probe_example_batch(2, mesh, "cpu"),
                                  mesh)
    params = fp.init_probe_params(1, "cpu")
    assert np.isfinite(float(step(params, blocks)[1]))
    blocks[0, 1, 0, 0, 0] = float("inf")
    assert not np.isfinite(float(step(params, blocks)[1]))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_build_mesh_matches_reference(n):
    want = dict(ref_mesh.build_mesh(n_devices=n).shape)
    assert pm.build_mesh(n) == want
    assert parallel.build_mesh(n) == want
    assert pm.build_mesh(devices=[None] * n) == want
    assert pm.build_mesh(n, devices=["cuda"] * 8) == want
    assert list(pm.build_mesh(n)) == list(pm.AXES)


def test_build_mesh_defaults_and_errors():
    assert pm.build_mesh() == {"dp": 1, "sp": 1, "tp": 1}
    with pytest.raises(ValueError) as want:
        ref_mesh.build_mesh(n_devices=4, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as got:
        pm.build_mesh(4, devices=[None] * 2)
    assert str(got.value) == str(want.value)


def test_probe_shapes_draws_and_errors():
    mesh = pm.build_mesh(8)
    assert fp.probe_shapes(mesh) == ref.probe_shapes(_ref_mesh((2, 2, 2)))
    p = fp.init_probe_params(1, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (fp.DIM, fp.HIDDEN), "w2": (fp.HIDDEN, fp.DIM)}
    assert all(torch.equal(p[k], fp.init_probe_params(1, "cpu")[k])
               for k in p)
    assert not torch.equal(p["w1"], fp.init_probe_params(3, "cpu")["w1"])
    batch = fp.probe_example_batch(2, mesh, "cpu")
    assert batch.shape == (8, 16, fp.DIM) and batch.dtype == torch.float32
    step = fp.make_probe_train_step(mesh, "cpu")
    blocks = fp.shard_probe_batch(batch, mesh)
    with pytest.raises(ValueError, match="does not shard over dp=2"):
        fp.shard_probe_batch(batch[:3], mesh)
    with pytest.raises(ValueError, match=r"the step takes \[2, 2, b, s"):
        step(p, blocks[:1])
    with pytest.raises(ValueError, match="the probe takes"):
        step({"w1": p["w1"]}, blocks)
    with pytest.raises(ValueError, match="w2"):
        step({"w1": p["w1"], "w2": p["w1"]}, blocks)
    with pytest.raises(ValueError, match="lacks the axes"):
        fp.make_probe_train_step({"dp": 1, "sp": 1}, "cpu")
    with pytest.raises(ValueError, match="does not shard over tp=3"):
        fp.make_probe_train_step({"dp": 1, "sp": 1, "tp": 3}, "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fp.run_probe(mesh)
