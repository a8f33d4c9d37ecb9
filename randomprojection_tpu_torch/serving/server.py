"""Replica-aware serving front end for the sharded tier (the port of
``randomprojection_tpu/serving/server.py``).

``TopKServer`` (``models/sketch.py``) already coalesces concurrent small
requests into one ``query_topk`` a batch, with bounded delay, a bounded
queue and drain-on-close; a ``ShardedSimHashIndex`` plugs straight into
it.  ``ShardedTopKServer`` adds replicas: it holds N replica groups (each
a full copy of the corpus, typically a ``ShardedSimHashIndex``) and sends
each coalesced batch to the next group round-robin.  Routing runs on the
dispatcher thread alone; results do not depend on it, since the replicas
are checked to agree on the corpus's shape at construction (serving the
same corpus is the operator's contract, as not mutating a served index
is).

Telemetry: each routed batch emits ``serve.shard.batch`` (replica, shard
fanout, rows, wall) and bumps the ``serve.shard.*`` counters beside the
base server's ``serve.topk.*``; per-request latency is the base class's
(``serve.latency.sharded`` by default).
"""

from __future__ import annotations

import threading

from randomprojection_tpu_torch.models.sketch import TopKServer
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = ["ShardedTopKServer"]


class ShardedTopKServer(TopKServer):
    """Micro-batching top-k server with round-robin replica routing (see
    the module docstring).  ``replicas`` is one index or a sequence of
    them; everything else is ``TopKServer``'s."""

    def __init__(self, replicas, m: int, *, max_batch: int = 8192,
                 max_delay_s: float = 0.002, max_pending: int = 8192,
                 name: str = "sharded", probe_policy=None,
                 start: bool = True):
        if not isinstance(replicas, (list, tuple)):
            replicas = [replicas]
        replicas = list(replicas)
        if not replicas:
            raise ValueError("ShardedTopKServer needs at least one replica")
        first = replicas[0]
        for r, rep in enumerate(replicas[1:], start=1):
            if (rep.n_bytes != first.n_bytes or rep.n_bits != first.n_bits
                    or rep.n_codes != first.n_codes
                    or rep.n_live != first.n_live):
                raise ValueError(
                    f"replica {r} disagrees with replica 0 on corpus "
                    f"shape (n_bytes {rep.n_bytes} vs {first.n_bytes}, "
                    f"n_bits {rep.n_bits} vs {first.n_bits}, "
                    f"n_codes {rep.n_codes} vs {first.n_codes}, n_live "
                    f"{rep.n_live} vs {first.n_live}): replicas must "
                    "serve identical corpora or results become "
                    "routing-dependent"
                )
        if probe_policy is not None:
            # round-robin may pick any replica, and the base constructor
            # checks replica 0 alone
            for r, rep in enumerate(replicas):
                if not hasattr(rep, "probes"):
                    raise ValueError(
                        f"probe_policy requires LSH-tier replicas (its "
                        f"query_topk must accept probes=); replica {r} "
                        f"is {type(rep).__name__}"
                    )
        self.replicas = replicas
        self._rr = 0  # the dispatcher's round-robin cursor
        # the per-replica tallies cross threads (the dispatcher writes,
        # stats() reads); the cursor stays the dispatcher's alone
        self._replica_batches = [0] * len(replicas)
        self._route_lock = threading.Lock()
        super().__init__(
            first, m, max_batch=max_batch, max_delay_s=max_delay_s,
            max_pending=max_pending, name=name, probe_policy=probe_policy,
            start=start,
        )

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def _pick_index(self):
        r = self._rr % len(self.replicas)
        self._rr += 1
        self._picked = r
        return self.replicas[r]

    def _batch_served(self, index, rows: int, padded: int,
                      requests: int, wall: float) -> None:
        r = self._picked
        with self._route_lock:
            self._replica_batches[r] += 1
        reg = telemetry.registry()
        reg.counter_inc("serve.shard.batches")
        reg.counter_inc("serve.shard.requests", requests)
        reg.counter_inc("serve.shard.queries", rows)
        reg.counter_inc(f"serve.shard.replica.{r}.batches")
        reg.gauge_set("serve.shard.replicas", len(self.replicas))
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.SERVE_SHARD_BATCH, replica=r,
                shards=int(getattr(index, "n_shards", 1)),
                rows=int(rows), padded=int(padded),
                requests=int(requests), m=int(self.m),
                wall_s=round(wall, 6),
            )

    def stats(self) -> dict:
        """The base coalescing tallies plus the replica routing spread."""
        s = super().stats()
        s["replicas"] = len(self.replicas)
        with self._route_lock:
            s["replica_batches"] = list(self._replica_batches)
        return s
