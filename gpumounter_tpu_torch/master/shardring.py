"""Admission sharding: the tenant/namespace hash ring and the HA knobs (the
port of :mod:`gpumounter_tpu.master.shardring`). The port runs the
single-master default only: the gateway refuses ``HAConfig.enabled``
until the election and the intent store are ported.

One master replica owning ALL broker state is the scale ceiling the
ROADMAP's "HA / scale-out master" item names: two replicas would
double-admit, and every parked waiter dies with its process. The HA plane
splits the admission keyspace into ``TPU_MASTER_SHARDS`` shards by a
stable hash of the request's namespace (the default tenancy boundary —
every route carries it, so attach, detach and renew for one owner pod
always land on the same shard). Each shard is owned by exactly one
replica at a time (master/election.py); its state lives in that shard's
ConfigMap records (master/store.py); a request arriving at a non-owning
replica is forwarded — proxied by default, 307-redirected when
``TPU_SHARD_FORWARD=redirect`` — so clients keep talking to one Service
VIP and never learn the topology.

Everything here defaults to the single-master semantics: one shard,
no election (this replica owns the whole ring), no store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket

from gpumounter_tpu_torch.utils import consts


@dataclasses.dataclass
class HAConfig:
    """The HA plane's knobs; defaults are exactly single-master
    behavior (pinned by test): one shard, no election, no store."""

    shards: int = 1
    election: bool = False
    store: bool = False
    replica: str = ""                   # identity in lock records
    advertise_url: str = ""             # how peers reach THIS replica
    forward: str = "proxy"              # "proxy" | "redirect"
    renew_interval_s: float = consts.DEFAULT_ELECTION_RENEW_S
    lease_duration_s: float = consts.DEFAULT_ELECTION_TTL_S
    namespace: str = consts.DEFAULT_POOL_NAMESPACE
    # Intent-store group commit (master/store.py): bounded coalescing
    # delay before queued record mutations fuse into ONE CAS per shard.
    # 0 here (direct HAConfig construction — existing rigs/tests) keeps
    # the per-record path byte-for-byte; from_settings carries the
    # production default (TPU_STORE_GROUP_COMMIT, on unless "0").
    group_commit_delay_s: float = 0.0

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if not self.replica:
            # a Deployment replica's hostname IS its pod name — unique
            self.replica = socket.gethostname()

    @classmethod
    def from_settings(cls, settings) -> "HAConfig":
        return cls(shards=settings.master_shards,
                   election=settings.election_enabled,
                   store=settings.intent_store_enabled,
                   replica=settings.replica_id,
                   advertise_url=settings.advertise_url,
                   forward=settings.shard_forward,
                   renew_interval_s=settings.election_renew_s,
                   lease_duration_s=settings.election_ttl_s,
                   namespace=settings.pool_namespace,
                   group_commit_delay_s=settings.store_group_commit_s)

    @property
    def enabled(self) -> bool:
        return self.shards > 1 or self.election or self.store


class ShardRing:
    """Stable namespace → shard mapping.

    The shard key is the target pod's NAMESPACE — the one routing key
    every mutating route (attach, detach, renew, slice) carries, and the
    default tenant identity, so a tenant's quota accounting and its
    leases stay on one shard. (An explicit cross-namespace
    ``X-Tpu-Tenant`` still names the quota bucket, but is admitted on
    its namespace's shard — quota for such a tenant is enforced
    per-shard; see docs/guide/HA.md.)

    The hash must be stable across processes and Python versions —
    ``hash()`` is salted per process and two replicas disagreeing on the
    ring would both own (or both disown) a shard — so it is sha256.
    """

    def __init__(self, shards: int = 1):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.shards = shards

    def shard_of(self, key: str) -> int:
        if self.shards == 1:
            return 0
        digest = hashlib.sha256(key.encode()).digest()
        return int.from_bytes(digest[:8], "big") % self.shards

    def all_shards(self) -> range:
        return range(self.shards)
