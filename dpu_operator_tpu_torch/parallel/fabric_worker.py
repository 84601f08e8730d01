"""One process of the fabric worker: real collectives between processes
over the operator-built pod fabric, on ``torch.distributed``.

    python -m dpu_operator_tpu_torch.parallel.fabric_worker \
        --process-id R --num-processes N --coordinator IP:PORT \
        [--bind-ip IP] [--peer-ips IP,...] [--payload-mb MB] [--iters K] \
        [--devices NODE,...] [--skip-train-step] [--ring-port P] \
        [--collective-transport ring|gloo] [--device cuda|cpu]

One copy runs inside each operator-attached pod network namespace. The
copies rendezvous at ``--coordinator`` (a ``TCPStore`` that process 0
hosts, on the fabric address) and form one gloo process group, whose
device each process binds to its ``--bind-ip``. Then each runs

  * a cross-process all-reduce (``dist.all_reduce``, SUM, on gloo),
    verified elementwise and timed for bandwidth;
  * when ``--peer-ips`` is wired and ``--collective-transport ring``
    (the default), the same payload again through the pipelined
    raw-socket ring of ``parallel/fabric_collectives.py``, in fp32 and
    then int8 on the wire: its figure becomes
    ``fabric_jax_allreduce_gbps`` (the key the callers read) and the
    gloo figure stays as ``fabric_gloo_allreduce_gbps``;
  * a data-parallel slice of the training step (``train_step``'s
    ``loss_fn`` at every axis 1 on each process's share of the batch,
    the loss and gradients summed over gloo), its first loss checked
    against the dense single-device reference and its losses asserted
    to descend. The slice runs on ``--device`` (default: the CUDA card;
    ``cpu`` for the CPU), the collectives on host memory either way.

Every byte of the rendezvous, the all-reduce and the slice's gradient
sums crosses the fabric between the processes; the caller checks that
from the per-port flow-table counters against ``min_port_bytes``.

Protocol: prints exactly one JSON object on stdout; rc 0 iff every
check passed.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import sys
import time

# Collective and rendezvous deadline: a peer that never arrives or dies
# mid-collective surfaces as an error in bounded time.
_GLOO_TIMEOUT = datetime.timedelta(seconds=120)


def protocol_stdout():
    """Reserve the REAL stdout for the one-line JSON protocol.

    The worker's contract is "exactly one JSON object on stdout" — but
    library logging (jax's absl handlers, any logging.basicConfig a
    transitively imported module ran, a stray debug print) defaults to
    stdout and INTERLEAVES with the protocol line, corrupting the
    parse on the coordinator side. The fix is structural, not
    discipline: swap ``sys.stdout`` for stderr so every later
    print()/handler write lands on the diagnostic stream, repoint any
    ALREADY-INSTALLED stream handlers that captured the old stdout,
    and hand the caller the real stdout for the single protocol
    write. The shard worker (serving/sharded/shard_worker.py) inherits
    the same guard."""
    real = sys.stdout
    sys.stdout = sys.stderr
    for h in logging.getLogger().handlers:
        if isinstance(h, logging.StreamHandler) and \
                getattr(h, "stream", None) is real:
            h.setStream(sys.stderr)
    # Late-configured loggers inherit this root handler (stderr);
    # force=False keeps any handlers a harness deliberately installed.
    logging.basicConfig(stream=sys.stderr)
    return real


def _init_gloo(coordinator: str, rank: int, world: int,
               bind_ip: str | None) -> None:
    """Join the gloo process group of ``world`` processes.

    The rendezvous store is a ``TCPStore`` at ``coordinator``, hosted by
    rank 0. gloo advertises the address that the machine's hostname
    resolves to, which in a pod netns is 127.0.0.1 (/etc/hosts) —
    unreachable from the peer pod — so with ``bind_ip`` the group's
    device is built on that address (``ProcessGroupGloo.create_device(
    hostname=bind_ip)``, under a backend registered for it), and every
    byte of the collectives leaves through the fabric address.

    No virtual-device flag needs scrubbing here, as the JAX package's
    ``XLA_FLAGS`` scrub does: a gloo group has exactly one rank a process,
    so the collective has no in-process shortcut and each rank's share
    crosses the socket."""
    import torch.distributed as dist

    host, _, port = coordinator.rpartition(":")
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=_GLOO_TIMEOUT)
    backend = "gloo"
    if bind_ip:
        def make(prefix_store, group_rank, group_size, timeout):
            opts = dist.ProcessGroupGloo._Options()
            opts._timeout = timeout
            opts._devices = [
                dist.ProcessGroupGloo.create_device(hostname=bind_ip)]
            return dist.ProcessGroupGloo(prefix_store, group_rank,
                                         group_size, opts)

        # Registering again replaces the creator: the latest bind wins.
        backend = "fabric_gloo"
        dist.Backend.register_backend(backend, make, devices=["cpu"])
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=_GLOO_TIMEOUT)


def _open_granted_devices(devices: list[str]) -> list[str]:
    """Open every granted device node rw — the chip-grant half of the
    composition (the AllocateResponse mounts must actually be usable
    from inside the pod)."""
    opened = []
    for d in devices:
        fd = os.open(d, os.O_RDWR)
        os.close(fd)
        opened.append(d)
    return opened


def _psum_bench(payload_mb: float, iters: int):
    """Timed cross-process all-reduce (SUM over the gloo group) of a
    payload_mb-MiB host float32 tensor per process, filled with rank +
    1; returns (ok, elapsed_s, algo_gbps, moved_bytes_min).

    ok: after the first (warm-up) call every element equals n(n+1)/2.
    algo bandwidth uses the ring-allreduce wire cost 2(n-1)/n · D per
    process; moved_bytes_min is a LOWER bound on what each process must
    have pushed through its fabric port (one reduce step's worth), for
    the caller's counter assertion."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    pid = dist.get_rank()
    elems = int(payload_mb * (1 << 20) // 4)
    buf = torch.full((elems,), float(pid + 1), dtype=torch.float32)
    dist.all_reduce(buf)  # warmup + correctness: every element == Σ (i+1)
    want = float(n * (n + 1) / 2)
    ok = bool(torch.all(buf == want))

    t0 = time.perf_counter()
    for _ in range(iters):
        # In place, so the sums grow from here on; only the time is read.
        dist.all_reduce(buf)
    elapsed = time.perf_counter() - t0
    bytes_payload = elems * 4
    wire = 2 * (n - 1) / n * bytes_payload * iters
    gbps = wire * 8 / elapsed / 1e9
    return ok, elapsed, gbps, bytes_payload // n


def _ring_bench(rank: int, world: int, bind_ip: str, peer_ips, port: int,
                payload_mb: float, iters: int, codec: str = "fp32"):
    """Timed allreduce through the custom pipelined ring transport
    (parallel/fabric_collectives.py) over the same fabric addresses —
    the decompose-then-optimize replacement for the gloo path. Same
    payload, same iteration count, same 2(n-1)/n wire accounting, so
    the two numbers compare 1:1 — including for quantized codecs,
    whose Gb/s stays on the fp32-equivalent denominator (EFFECTIVE
    bandwidth: fewer wire bytes, same reduced payload). Returns the
    bench_ring result dict."""
    from .fabric_collectives import RingTransport, bench_ring

    with RingTransport(rank, world, bind_ip, peer_ips, port=port,
                       codec=codec) as t:
        return bench_ring(t, int(payload_mb * (1 << 20)), iters,
                          mode="allreduce")


def _train_slice(device):
    """A data-parallel slice of the training step over the processes:
    the JAX package's sizes and seeds (M 2, mb 2n, seq 4, d 8, h 16, one
    stage, one expert, capacity factor 4, x from ``RandomState(7)``, the
    target tanh(x reversed along d)), 3 steps, ``init_params(seed=3)``.

    Each process runs ``make_train_step``'s loss_fn at every axis 1 on
    its own mb rows. That loss divides by the rows it is given, 1/n of
    the batch's, so the local loss and gradients are scaled by 1/n and
    summed over gloo (host copies): the batch's loss and gradient on
    every process. The update is make_train_step's, lr·g rounded first.
    At ep 1 the slice launches no kernel. Returns (losses,
    matches_dense, descends): matches_dense holds the first loss
    against ``dense_loss_reference`` on the whole batch."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .train_step import (_sgd, dense_loss_reference, init_params,
                             make_train_step, value_and_grad)

    n, pid = dist.get_world_size(), dist.get_rank()
    M, mb, seq, d, h = 2, 2 * n, 4, 8, 16
    params = init_params(S=1, d=d, h=h, E=1, seed=3, device=device)
    rng = np.random.RandomState(7)
    x = rng.randn(M, mb, seq, d).astype(np.float32)
    tgt = np.tanh(x[..., ::-1].copy())

    cf, lr = 4.0, 0.05
    _, loss_fn = make_train_step(dict.fromkeys(
        ("dp", "pp", "sp", "tp", "ep"), 1), capacity_factor=cf, lr=lr,
        device=device)
    mb_loc = mb // n
    rows = slice(pid * mb_loc, (pid + 1) * mb_loc)
    xl = torch.from_numpy(x[:, rows].copy()).to(device)
    tl = torch.from_numpy(tgt[:, rows].copy()).to(device)

    ref0 = float(dense_loss_reference(
        params, torch.from_numpy(x).to(device),
        torch.from_numpy(tgt).to(device), capacity_factor=cf,
        shards={"dp": n, "sp": 1}))
    losses = []
    p = params
    for _ in range(3):
        loss, grads = value_and_grad(loss_fn, p, xl, tl)
        flat = torch.cat([loss.reshape(1)]
                         + [g.reshape(-1) for g in grads.values()])
        flat = flat.div_(n).cpu()
        dist.all_reduce(flat)
        flat = flat.to(device)
        off = 1
        for g in grads.values():
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        loss, p = _sgd(p, flat[0], grads, lr)
        losses.append(float(loss))
    matches = bool(np.isclose(losses[0], ref0, rtol=1e-4))
    descends = losses[-1] < losses[0]
    return losses, matches, descends


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True,
                    help="ip:port of process 0 on the FABRIC network")
    ap.add_argument("--bind-ip", default=None,
                    help="this pod's fabric address (gloo binds it)")
    ap.add_argument("--payload-mb", type=float, default=8.0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--devices", default="",
                    help="comma-separated granted device nodes to open rw")
    ap.add_argument("--skip-train-step", action="store_true")
    ap.add_argument("--peer-ips", default="",
                    help="comma-separated fabric IPs of ALL processes, "
                         "indexed by process id — required for the ring "
                         "transport (each rank dials its ring neighbour)")
    ap.add_argument("--collective-transport",
                    default=os.environ.get("DPU_FABRIC_COLLECTIVE", "ring"),
                    choices=["ring", "gloo"],
                    help="'ring' = the pipelined raw-socket allreduce in "
                         "fabric_collectives.py (needs --peer-ips); "
                         "'gloo' = the gloo process group only")
    ap.add_argument("--ring-port", type=int, default=9411)
    ap.add_argument("--device", default=None,
                    help="where the train slice runs (default: the CUDA "
                         "card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    proto_out = protocol_stdout()  # everything else goes to stderr
    # JSON-lines diagnostics on the stderr the protocol guard just
    # secured; rank binds once via context() so a multi-worker log merge
    # greps by rank like the serving plane greps by request id.
    from ..obs import logging as obs_logging

    obs_logging.setup("fabric_worker", stream=sys.stderr)
    _log = logging.getLogger("fabric_worker")
    _rank_ctx = obs_logging.context(rank=args.process_id)
    _rank_ctx.__enter__()  # process-lifetime binding; exits with us

    def trace(msg):  # progress to stderr so a hang is attributable
        _log.info(msg)

    import torch.distributed as dist

    from ..device import resolve_device

    # Before the rendezvous: without the card asked for, fail alone.
    device = resolve_device(args.device, "fabric_worker")
    trace(f"initializing distributed, coordinator={args.coordinator}")
    _init_gloo(args.coordinator, args.process_id, args.num_processes,
               args.bind_ip)
    trace("distributed up; querying devices")
    # One gloo rank a process, its collectives on host memory: the
    # group's devices are the processes, and their platform the CPU's.
    result = {
        "process_id": args.process_id,
        "process_count": dist.get_world_size(),
        "n_devices": dist.get_world_size(),
        "platform": "cpu",
        "train_device": str(device),
    }
    opened = _open_granted_devices(
        [d for d in args.devices.split(",") if d])
    result["devices_opened"] = opened
    granted_env = {k: v for k, v in os.environ.items()
                   if k.startswith("TPU_") and k in (
                       "TPU_VISIBLE_DEVICES", "TPU_WORKER_ID",
                       "TPU_SLICE_ID", "TPU_NUM_SLICES")}
    result["granted_env"] = granted_env

    ok = (result["process_count"] == args.num_processes
          and result["n_devices"] == args.num_processes
          and result["platform"] == "cpu")

    trace(f"devices={result['n_devices']} platform={result['platform']}; "
          f"running psum bench")
    psum_ok, elapsed, gbps, moved_min = _psum_bench(args.payload_mb,
                                                    args.iters)
    result.update(psum_ok=psum_ok, allreduce_elapsed_s=round(elapsed, 4),
                  fabric_gloo_allreduce_gbps=round(gbps, 3),
                  min_port_bytes=moved_min)
    ok = ok and psum_ok

    # The headline allreduce number rides the custom ring transport when
    # it is enabled and wired (peer ips known); the gloo figure above is
    # kept alongside as the engine-overhead comparison point. With the
    # transport disabled (or un-wired) the gloo number IS the headline.
    peer_ips = [p for p in args.peer_ips.split(",") if p]
    use_ring = (args.collective_transport == "ring"
                and len(peer_ips) == args.num_processes)
    result["collective_transport"] = "ring" if use_ring else "gloo"
    if use_ring:
        trace("psum bench done; running ring-transport allreduce")
        try:
            ring_res = _ring_bench(
                args.process_id, args.num_processes,
                args.bind_ip or peer_ips[args.process_id], peer_ips,
                args.ring_port, args.payload_mb, args.iters)
        except Exception as e:  # fall back loudly, not silently
            result.update(collective_transport="gloo",
                          ring_error=str(e)[:300],
                          fabric_jax_allreduce_gbps=round(gbps, 3))
            ok = False
            trace(f"ring transport failed: {e}")
        else:
            ring_gbps = ring_res["gbps"]
            result.update(ring_ok=ring_res["ok"],
                          ring_allreduce_elapsed_s=ring_res["elapsed_s"],
                          fabric_ring_allreduce_gbps=round(ring_gbps, 3),
                          fabric_jax_allreduce_gbps=round(ring_gbps, 3))
            ok = ok and ring_res["ok"]
            # Quantized collectives: the SAME payload through the SAME
            # schedule with int8 on the wire — a fresh rendezvous one
            # port up (the codec handshake refuses a mixed ring). A
            # quantized failure keeps the fp32 result: the figure just
            # goes missing (no gate without evidence).
            trace("ring allreduce done; running int8 quantized ring")
            try:
                q = _ring_bench(
                    args.process_id, args.num_processes,
                    args.bind_ip or peer_ips[args.process_id], peer_ips,
                    args.ring_port + 1, args.payload_mb, args.iters,
                    codec="int8")
            except Exception as e:
                result["quantized_error"] = str(e)[:300]
                trace(f"quantized ring failed: {e}")
            else:
                result.update(
                    fabric_quantized_allreduce_gbps=round(q["gbps"], 3),
                    fabric_quantized_allreduce_maxerr=q["max_abs_err"],
                    fabric_quantized_err_bound=q["err_bound"],
                    fabric_quantized_codec=q["codec"])
                if ring_gbps > 0:
                    result["fabric_quantized_speedup"] = round(
                        q["gbps"] / ring_gbps, 2)
                ok = ok and q["ok"]
    else:
        result["fabric_jax_allreduce_gbps"] = round(gbps, 3)
    trace("allreduce benches done; running train-step slice")

    if not args.skip_train_step:
        losses, matches, descends = _train_slice(device)
        result.update(train_losses=[round(l, 6) for l in losses],
                      train_matches_dense=matches,
                      train_loss_descends=descends)
        ok = ok and matches and descends

    result["ok"] = ok
    print(json.dumps(result), file=proto_out, flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
