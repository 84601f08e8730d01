"""Cluster-wide prefix cache front end.

``PrefixRouter`` + ``RouterReplica`` (router.py) place requests on the
replica that already holds their prefix — scored over the
content-addressed key maps replicas publish through ``GossipBoard`` /
``ReplicaGossip`` (gossip.py) — and move KV over ``KVPageStream``
when placement and residency disagree. Jax-free, like the rest of the
scheduler plane.
"""

from .gossip import GossipBoard, ReplicaGossip, chain_keys
from .router import PrefixRouter, RouterReplica

__all__ = [
    "GossipBoard",
    "PrefixRouter",
    "ReplicaGossip",
    "RouterReplica",
    "chain_keys",
]
