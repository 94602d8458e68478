"""Indexed waiter wakeup: the broker queue's selection structure (the port
of :mod:`gpumounter_tpu.master.waiterindex`).

``AttachBroker._signal_next_locked`` used to rescan the whole parked
list on EVERY capacity signal — O(waiters) per signal, and each scan
re-derived the lease table's usage map. At ~550 concurrent in-flight
RPCs (the control plane's bench ceiling) that rescan was already
visible; at the
ROADMAP's 10k target it is the master's admission hot loop.

This module replaces the list with a :class:`WaiterQueue`:

- **membership** is an insertion-ordered dict — add/remove O(1), and
  iteration still yields waiters in enqueue order (the snapshot/gauge
  surface is unchanged);
- **selection** is served from buckets keyed by
  ``(node, priority-rank, tenant, chip-count)``. A capacity signal that
  says *where* chips freed (and how many) examines only the signalling
  node's buckets (plus node-less gang waiters); within the top priority
  holding a candidate, buckets whose chip demand the freed count could
  satisfy are preferred, the fair-share comparison runs over one
  bucket-front per (tenant, chips) — not every parked waiter — and
  ``leases.usage()`` is snapshotted once per signal, only when a
  candidate survived the generation filter.

The selection ORDER is pinned equivalent to the legacy linear scan
(tests/test_waiter_index.py drives 1k randomized park/wake/timeout/
preempt interleavings against a brute-force reference): within a bucket
all waiters share (tenant, priority, chips), so the bucket front — the
earliest eligible — dominates its deeper members under the
(priority, fair-share, enqueue-order) key, and comparing fronts equals
comparing everyone. ``TPU_WAITER_INDEX=0`` (BrokerConfig.waiter_index)
reverts selection to the linear scan byte-for-byte — keeping only the
independently shippable micro-fix: quota lookups hoisted out of the
per-candidate closure, and the usage snapshot skipped entirely when no
candidate survived the generation filter.
"""

from __future__ import annotations

from typing import Callable, Iterator

from gpumounter_tpu_torch.utils import consts


def _rank(priority: str) -> int:
    try:
        return consts.PRIORITIES.index(priority)
    except ValueError:
        return consts.PRIORITIES.index(consts.DEFAULT_PRIORITY)


class WaiterQueue:
    """The broker's parked waiters: ordered membership + bucketed
    selection. NOT thread-safe on its own — every call happens under
    the broker's lock, exactly like the list it replaces."""

    def __init__(self, indexed: bool = True):
        self.indexed = indexed
        self._seq = 0
        # waiter -> seq; dict insertion order == enqueue order (adds
        # happen under the broker lock in construction order, so seq,
        # enqueued_at and iteration order all agree)
        self._order: dict = {}
        # (node, rank, tenant, chips) -> insertion-ordered {waiter: seq}
        self._buckets: dict[tuple, dict] = {}
        # node -> bucket keys living there ("" holds node-less gangs)
        self._node_keys: dict[str, set[tuple]] = {}
        self._priority_counts: dict[str, int] = {}

    # -- membership ------------------------------------------------------------

    @staticmethod
    def _key(waiter) -> tuple:
        return (waiter.node or "", _rank(waiter.priority), waiter.tenant,
                waiter.chips)

    def add(self, waiter) -> None:
        self._seq += 1
        self._order[waiter] = self._seq
        key = self._key(waiter)
        self._buckets.setdefault(key, {})[waiter] = self._seq
        self._node_keys.setdefault(key[0], set()).add(key)
        self._priority_counts[waiter.priority] = \
            self._priority_counts.get(waiter.priority, 0) + 1

    def remove(self, waiter) -> None:
        """Tolerant removal (the queue paths guard with ``in`` anyway)."""
        if self._order.pop(waiter, None) is None:
            return
        key = self._key(waiter)
        bucket = self._buckets.get(key)
        if bucket is not None:
            bucket.pop(waiter, None)
            if not bucket:
                del self._buckets[key]
                keys = self._node_keys.get(key[0])
                if keys is not None:
                    keys.discard(key)
                    if not keys:
                        del self._node_keys[key[0]]
        count = self._priority_counts.get(waiter.priority, 0) - 1
        if count > 0:
            self._priority_counts[waiter.priority] = count
        else:
            self._priority_counts.pop(waiter.priority, None)

    def __contains__(self, waiter) -> bool:
        return waiter in self._order

    def __eq__(self, other) -> bool:
        # list equality in enqueue order — the queue REPLACED a plain
        # list, and test assertions like ``broker._waiters == []`` are
        # part of its public surface
        if isinstance(other, list):
            return list(self._order) == other
        return NotImplemented

    __hash__ = object.__hash__

    def __iter__(self) -> Iterator:
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def count(self, priority: str) -> int:
        return self._priority_counts.get(priority, 0)

    def oldest_enqueued_at(self) -> float | None:
        for waiter in self._order:
            return waiter.enqueued_at
        return None

    # -- selection -------------------------------------------------------------

    def select(self, gen: int, node: str | None = None, chips: int = 0,
               usage_fn: Callable[[], dict] | None = None,
               quota_fn: Callable[[str], int | None] | None = None
               ) -> tuple[object | None, int]:
        """The waiter a capacity signal should wake: the untried
        (``tried_gen < gen``), un-signalled candidate with the highest
        priority, then the smallest fair share (live usage / quota),
        then the earliest enqueue. ``node``/``chips`` are the signal's
        locality hints (index mode only): candidates narrow to waiters
        the freed capacity could actually reach — the signalling node's
        own plus node-less gangs — and, within the winning priority,
        to chip demands the freed count covers when any exists.
        Returns ``(waiter_or_None, waiters_examined)``; the usage
        snapshot is taken at most once, and only when a candidate
        survived the generation filter."""
        if self.indexed:
            return self._select_indexed(gen, node, chips, usage_fn,
                                        quota_fn)
        return self._select_linear(gen, usage_fn, quota_fn)

    def _eligible_front(self, bucket: dict, gen: int) -> tuple:
        """(first eligible waiter or None, waiters examined)."""
        examined = 0
        for waiter in bucket:
            examined += 1
            if waiter.tried_gen < gen and not waiter.event.is_set():
                return waiter, examined
        return None, examined

    def _select_indexed(self, gen, node, chips, usage_fn, quota_fn):
        if node is None:
            keys = list(self._buckets)
        else:
            keys = list(self._node_keys.get(node, ()))
            if node != "":
                keys += list(self._node_keys.get("", ()))
        evaluated = 0
        by_rank: dict[int, list[tuple]] = {}
        for key in keys:
            by_rank.setdefault(key[1], []).append(key)
        for rank in sorted(by_rank, reverse=True):
            fronts = []
            for key in by_rank[rank]:
                front, examined = self._eligible_front(
                    self._buckets[key], gen)
                evaluated += examined
                if front is not None:
                    fronts.append(front)
            if not fronts:
                continue
            if chips > 0:
                covered = [w for w in fronts if w.chips <= chips]
                if covered:
                    # freed capacity that can complete a small demand
                    # outright beats waking a bigger one to fail-and-
                    # baton; when nothing fits, the smallest-share
                    # candidate still wakes (capacity may accumulate)
                    fronts = covered
            return self._fair_min(fronts, usage_fn, quota_fn), evaluated
        return None, evaluated

    def _select_linear(self, gen, usage_fn, quota_fn):
        # the legacy whole-queue rescan (TPU_WAITER_INDEX=0), with the
        # independently shipped micro-fix: no usage snapshot when no
        # candidate survived, quota lookups cached per tenant
        evaluated = len(self._order)
        candidates = [w for w in self._order
                      if w.tried_gen < gen and not w.event.is_set()]
        if not candidates:
            return None, evaluated
        top = max(_rank(w.priority) for w in candidates)
        return self._fair_min(
            [w for w in candidates if _rank(w.priority) == top],
            usage_fn, quota_fn), evaluated

    def _fair_min(self, candidates: list, usage_fn, quota_fn):
        """Smallest fair share first (usage normalised by quota;
        unlimited tenants weigh by raw usage), earliest enqueue among
        equals. One usage snapshot, one quota lookup per tenant."""
        usage = usage_fn() if usage_fn is not None else {}
        shares: dict[str, float] = {}
        for waiter in candidates:
            if waiter.tenant not in shares:
                quota = quota_fn(waiter.tenant) if quota_fn else None
                shares[waiter.tenant] = (usage.get(waiter.tenant, 0)
                                         / (quota or 1e9))
        return min(candidates,
                   key=lambda w: (shares[w.tenant], self._order[w]))
