"""The fabric worker's program on the port against the JAX package's.

Pairs of worker processes run on loopback, one rank on 127.0.0.1 and one
on 127.0.0.2 (two addresses: the int8 ring's second rendezvous takes the
ring port + 1, which per-rank ``ip:port`` peers on one address would not
give), each pair on free ports, all pairs at once:

  * the reference pair (``python -m dpu_operator_tpu.parallel.
    fabric_worker``, the jax CPU backend on gloo);
  * the port's pair on the reference's train-slice weights
    (``init_params(seed=3)`` drawn by jax, saved to an npz; a ``-c``
    launcher puts them in place of the port's ``init_params`` and runs
    the worker's ``main``), ``--device cpu``;
  * the port's pair on its own ``init_params(seed=3)`` (torch's draws);
  * a port pair whose rank 0 is given a wrong peer address.

Bars: the train losses of the port's pair on the reference's weights
within ``LOSS_RTOL`` of the reference pair's (float32 sums in two
libraries over three SGD steps; both round to 6 digits) and equal across
ranks; the int8 ring's max error equal to the reference's and within its
bound (the same codec on the same payload).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from dpu_operator_tpu.parallel.train_step import init_params as ref_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IPS = ("127.0.0.1", "127.0.0.2")
LOSS_RTOL = 1e-5
TIMEOUT_S = 240


def _free_port(span=1):
    """A port p with p .. p + span - 1 free on both loopback addresses."""
    while True:
        with socket.socket() as s:
            s.bind((IPS[0], 0))
            p = s.getsockname()[1]
        if p + span > 65535:
            continue
        try:
            held = []
            for ip in IPS:
                for q in range(p, p + span):
                    t = socket.socket()
                    held.append(t)
                    t.bind((ip, q))
            return p
        except OSError:
            continue
        finally:
            for t in held:
                t.close()


def _spawn_pair(entry, extra=(), peers=None):
    """Two worker processes; ``entry`` is what follows the interpreter
    (``["-m", module]`` or a ``-c`` launcher and its own arguments)."""
    coord, ring = _free_port(), _free_port(2)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for i, ip in enumerate(IPS):
        pl = (peers[i] if peers else None) or IPS
        procs.append(subprocess.Popen(
            [sys.executable, *entry, "--process-id", str(i),
             "--num-processes", "2", "--coordinator", f"{IPS[0]}:{coord}",
             "--bind-ip", ip, "--peer-ips", ",".join(pl),
             "--payload-mb", "1", "--iters", "2", "--ring-port", str(ring),
             *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _collect(procs):
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            lines = [l for l in stdout.splitlines() if l.strip()]
            out.append((p.returncode,
                        json.loads(lines[-1]) if lines else None,
                        stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    return out


PORT = "dpu_operator_tpu_torch.parallel.fabric_worker"
REF = "dpu_operator_tpu.parallel.fabric_worker"

# Runs the port's worker with ``train_step.init_params`` returning the
# weights saved in the npz given as the first argument (the train slice
# imports ``init_params`` when it is called, so the swap reaches it).
ON_WEIGHTS = """\
import sys
import numpy as np
from dpu_operator_tpu_torch.parallel import fabric_worker, train_step
with np.load(sys.argv[1]) as z:
    weights = {k: z[k] for k in z.files}
def init_params(S, d, h, E, seed=0, attention=False, device=None):
    assert (S, d, h, E, seed, attention) == (1, 8, 16, 1, 3, False)
    return train_step.params_from_numpy(weights, device)
train_step.init_params = init_params
sys.exit(fabric_worker.main(sys.argv[2:]))
"""


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    npz = str(tmp_path_factory.mktemp("fabric_worker") / "params.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     ref_init(S=1, d=8, h=16, E=1, seed=3).items()})
    started = {
        "reference": _spawn_pair(["-m", REF]),
        "port": _spawn_pair(["-c", ON_WEIGHTS, npz], ("--device", "cpu")),
        "seeded": _spawn_pair(["-m", PORT], ("--device", "cpu")),
        "wrong_peer": _spawn_pair(["-m", PORT], ("--device", "cpu"),
                                  peers=[(IPS[0], "127.0.0.3"), None]),
    }
    return {name: _collect(procs) for name, procs in started.items()}


def _ok(runs, one_line=True):
    """Each rank's result, after the checks every pair must pass. The
    reference's stdout also carries gloo's native connection lines (a
    write to fd 1 that the protocol guard cannot redirect): its result is
    the last line; the port's stdout holds the result alone."""
    for rank, (rc, res, stdout, stderr) in enumerate(runs):
        assert rc == 0, f"rank {rank} rc={rc}\n{stderr[-4000:]}"
        assert res is not None and res["ok"], res
        if one_line:
            assert len([l for l in stdout.splitlines() if l.strip()]) == 1
        assert res["process_id"] == rank
        assert res["process_count"] == 2 and res["n_devices"] == 2
        assert res["platform"] == "cpu"
        assert res["psum_ok"] and res["ring_ok"]
        assert res["collective_transport"] == "ring"
        assert res["train_matches_dense"] and res["train_loss_descends"]
        assert res["min_port_bytes"] == (1 << 20) // 2
        assert res["fabric_jax_allreduce_gbps"] == \
            res["fabric_ring_allreduce_gbps"] > 0
        assert "quantized_error" not in res
    return [r[1] for r in runs]


@pytest.mark.parametrize("name", ["reference", "port", "seeded"])
def test_pair_returns_ok(pairs, name):
    _ok(pairs[name], one_line=name != "reference")


@pytest.mark.parametrize("name", ["reference", "port", "seeded"])
def test_train_losses_equal_across_ranks(pairs, name):
    a, b = _ok(pairs[name], one_line=name != "reference")
    assert a["train_losses"] == b["train_losses"]
    assert len(a["train_losses"]) == 3


def test_train_losses_match_the_reference_pair(pairs):
    ref = _ok(pairs["reference"], one_line=False)[0]["train_losses"]
    got = _ok(pairs["port"])[0]["train_losses"]
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)


def test_port_result_carries_the_reference_keys(pairs):
    ref = _ok(pairs["reference"], one_line=False)[0]
    port = _ok(pairs["port"])[0]
    assert set(port) == set(ref) | {"train_device"}
    assert port["train_device"] == "cpu"
    assert port["granted_env"] == {} and port["devices_opened"] == []


def test_int8_ring_error_within_bound_and_equal_to_reference(pairs):
    ref = _ok(pairs["reference"], one_line=False)
    for res, want in zip(_ok(pairs["port"]), ref):
        assert res["fabric_quantized_codec"] == "int8"
        assert res["fabric_quantized_allreduce_maxerr"] <= \
            res["fabric_quantized_err_bound"]
        assert res["fabric_quantized_allreduce_maxerr"] == \
            want["fabric_quantized_allreduce_maxerr"]
        assert res["fabric_quantized_err_bound"] == \
            want["fabric_quantized_err_bound"]


def test_wrong_peer_exits_1_with_ring_error(pairs):
    for rank, (rc, res, _, stderr) in enumerate(pairs["wrong_peer"]):
        assert rc == 1, f"rank {rank} rc={rc}\n{stderr[-4000:]}"
        assert res is not None and res["ok"] is False
        assert res["ring_error"], res
        assert res["collective_transport"] == "gloo"
        assert "ring_ok" not in res
        # The ring's failure alone fails the run: the rest still passed.
        assert res["psum_ok"] and res["train_matches_dense"]


def test_worker_without_device_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    r = subprocess.run(
        [sys.executable, "-m", PORT, "--process-id", "0",
         "--num-processes", "1", "--coordinator",
         f"{IPS[0]}:{_free_port()}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
    assert r.stdout.strip() == ""


def test_single_process_without_peers_uses_gloo_alone():
    r = subprocess.run(
        [sys.executable, "-m", PORT, "--process-id", "0",
         "--num-processes", "1", "--coordinator",
         f"{IPS[0]}:{_free_port()}", "--payload-mb", "1", "--iters", "1",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["psum_ok"]
    assert res["collective_transport"] == "gloo"
    assert res["fabric_jax_allreduce_gbps"] == \
        res["fabric_gloo_allreduce_gbps"]
    assert res["train_matches_dense"] and res["train_loss_descends"]


def test_fabric_worker_stdout_protocol_survives_noisy_logging():
    """The port's twin of the reference's regression: after
    ``protocol_stdout()`` library logging and stray prints land on
    stderr and the protocol line alone on the real stdout."""
    snippet = (
        "import json, logging, sys\n"
        "logging.basicConfig(stream=sys.stdout)\n"
        "from dpu_operator_tpu_torch.parallel.fabric_worker import "
        "protocol_stdout\n"
        "out = protocol_stdout()\n"
        "logging.getLogger('noisy').warning('rendezvous retry %d', 3)\n"
        "print('stray diagnostic print')\n"
        "print(json.dumps({'ok': True}), file=out, flush=True)\n")
    r = subprocess.run([sys.executable, "-c", snippet], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, (
        f"stdout must carry exactly the one protocol object, got "
        f"{r.stdout!r}")
    assert json.loads(lines[0]) == {"ok": True}
    assert "rendezvous retry 3" in r.stderr
    assert "stray diagnostic print" in r.stderr
