"""The intent store's slice records (the port of the record half of
:mod:`gpumounter_tpu.master.store`).

The control plane persists broker state as annotation records on
per-shard state ConfigMaps. The store itself (``IntentStore``: CAS
writes, fencing, the dirty queue, rehydration) is ROADMAP Queue 1 item
12b and is not here. What is here are the two slice records: the slice
transaction manager (``master/slicetxn.py``) builds a
:class:`SliceTxnRecord` on every attach and a :class:`SliceBarrierRecord`
shape on every barrier, store or none, so the records come with the slice
subsystem and their serialisation stays byte-identical to the control
plane's (one key renamed: ``gpus_per_host``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from gpumounter_tpu_torch.utils import consts


def _digest(identity: str) -> str:
    return hashlib.sha256(identity.encode()).hexdigest()[:16]


def _canonical(obj: dict) -> str:
    """One byte-stable serialization (sorted keys, no whitespace)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class SliceTxnRecord:
    """A multi-host slice transaction's intent, written BEFORE the
    fan-out touches any host (master/slicetxn.py). ``committed`` lists
    the "namespace/pod" members whose hosts already hold GPUs under the
    txn — the per-host commit markers. A record still present at
    rehydration is a transaction its writer never resolved."""

    txn_id: str
    rid: str
    tenant: str
    priority: str = consts.DEFAULT_PRIORITY
    # ["namespace/pod", ...] — flat strings so the record's canonical
    # JSON stays list-of-strings (annotation values are plain text).
    pods: list[str] = dataclasses.field(default_factory=list)
    gpus_per_host: int = 0
    committed: list[str] = dataclasses.field(default_factory=list)
    created_unix: float = 0.0
    deadline_unix: float = 0.0
    # Lease group the commit joins ("" = the txn id itself — a fresh
    # slice; a resize delta txn names the EXISTING group here).
    group: str = ""

    @property
    def namespace(self) -> str:
        return self.pods[0].split("/", 1)[0] if self.pods else ""

    def members(self) -> list[tuple[str, str]]:
        return [tuple(p.split("/", 1)) for p in self.pods if "/" in p]

    @property
    def annotation_key(self) -> str:
        return consts.STORE_SLICE_ANNOTATION_PREFIX + _digest(self.txn_id)

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "SliceTxnRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.txn_id or not record.pods:
            raise ValueError(f"slice txn record missing identity: {text!r}")
        return record


@dataclasses.dataclass
class SliceBarrierRecord:
    """A slice group's re-federation barrier (master/slicetxn.py), armed
    when the mesh generation bumps and updated with the frozen plan when
    every member of the NEW generation has re-federated."""

    group: str
    generation: int
    # ordered "namespace/pod" membership of the NEW generation — the
    # order IS the federation plan's process-id assignment
    members: list[str] = dataclasses.field(default_factory=list)
    created_unix: float = 0.0
    # set once the barrier COMPLETED: the federation plan members poll for
    plan: dict = dataclasses.field(default_factory=dict)
    completed_unix: float = 0.0

    @property
    def namespace(self) -> str:
        return self.members[0].split("/", 1)[0] if self.members else ""

    @property
    def annotation_key(self) -> str:
        return consts.STORE_BARRIER_ANNOTATION_PREFIX + _digest(self.group)

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "SliceBarrierRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.group or not record.members:
            raise ValueError(f"barrier record missing identity: {text!r}")
        return record
