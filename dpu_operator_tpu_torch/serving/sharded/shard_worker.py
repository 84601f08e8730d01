"""One rank process of a context-parallel paged-KV replica.

    python -m dpu_operator_tpu_torch.serving.sharded.shard_worker --kv \
        --rank R --connect HOST:PORT --slots S --num-blocks N --chunk C \
        --kv-spec K=V,... [--device cuda|cpu]

``KVShardProcessSet`` (``serving/kvcache/sharded.py``) spawns one a rank.
The process dials the coordinator's per-rank listener, rebuilds the
shared ``KVSpec`` from ``--kv-spec``, derives its own head or block
slice from it, and serves framed step/reset messages (``protocol.py``)
until the coordinator closes the stream. ``--device`` is where its pool
slice and partial step live (default: the card).

Protocol: prints exactly ONE JSON object on stdout at exit
(``parallel/fabric_worker.protocol_stdout`` guards the stream — all
logging goes to stderr); rc 0 iff the session ended cleanly.

Only the ``--kv`` entry is ported. The row-plane shard worker (the
tensor-parallel decode slice over the fabric ring) comes with the
fabric-sharded serving plane.
"""

from __future__ import annotations

import argparse
import json
import logging
import socket
import sys

from ...obs import logging as obs_logging
from ...parallel.fabric_worker import protocol_stdout
from .protocol import ProtocolError

log = logging.getLogger("shard_worker")


def _kv_main(argv) -> int:
    """``--kv`` mode: this process serves ONE rank's slice of a
    context-parallel paged KV pool — it dials the coordinator's
    per-rank listener, rebuilds the shared ``KVSpec`` from
    ``--kv-spec`` and derives its OWN head/block slice bounds from it
    (the GL018 discipline holds across the process boundary), then
    serves framed step/reset messages until the coordinator closes the
    stream. One JSON line on stdout at exit."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv", action="store_true")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--connect", required=True,
                    help="ip:port of the KVShardProcessSet's per-rank "
                         "listener")
    ap.add_argument("--slots", type=int, required=True)
    ap.add_argument("--num-blocks", type=int, required=True)
    ap.add_argument("--chunk", type=int, required=True)
    ap.add_argument("--kv-spec", required=True,
                    help="k=v CSV of KVSpec.fingerprint() — the ONE "
                         "layout declaration both ends derive from")
    ap.add_argument("--device", default=None,
                    help="where the rank's pools and step live "
                         "(default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    proto_out = protocol_stdout()
    obs_logging.setup("shard_worker", stream=sys.stderr)
    with obs_logging.context(rank=args.rank):
        from ..kvcache.sharded import serve_kv_rank, spec_from_argv

        spec = spec_from_argv(args.kv_spec)
        host, port = args.connect.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rc, err = 0, None
        try:
            serve_kv_rank(sock, args.rank, spec, slots=args.slots,
                          num_blocks=args.num_blocks,
                          chunk=args.chunk, device=args.device)
        except (OSError, ProtocolError) as e:
            # A dead coordinator closes the socket: bounded, loud.
            rc, err = 1, str(e)
            log.warning("kv rank %d: coordinator stream died: %s",
                        args.rank, e)
        finally:
            sock.close()
        print(json.dumps({"ok": rc == 0, "mode": "kv",
                          "rank": args.rank, "error": err}),
              file=proto_out, flush=True)
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--kv" in argv:
        return _kv_main(argv)
    print("shard_worker: only the --kv rank entry is ported",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
