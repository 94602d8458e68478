"""Per-shard leader election over CAS'd renewable lock records (the port of
:mod:`gpumounter_tpu.master.election`; the lock objects, their annotations
and the fence discipline are the control plane's, so replicas of either
package contend for the same locks).

Two master replicas each running a broker would both admit against the
same GPUs. This module makes admission single-writer *per shard*
without any external coordination service: each shard has one lock
ConfigMap (``tpu-mounter-election-<shard>``) whose annotations name the
holder, its advertised URL, a wall-clock renew deadline, and a
monotonically increasing **fencing token**:

- **acquire**: creating the absent lock (create IS the compare-and-swap)
  or patching an *expired* one with ``fence+1`` under a resourceVersion
  precondition — two replicas racing produce exactly one 409 loser;
- **renew**: the holder re-patches the deadline every
  ``renew_interval_s``; a holder that cannot renew stops considering
  itself leader once its last successful renewal ages past
  ``lease_duration_s`` (local monotonic clock — no apiserver needed to
  *stop* acting);
- **failover**: a peer observes the stale deadline and takes over within
  one renew interval of expiry, bumping the fence. The deposed replica's
  next intent-store write carries the old token and is refused
  (:class:`~gpumounter_tpu_torch.utils.errors.StoreFencedError`) — even a
  paused-and-resumed process cannot split-brain a write (HA.md).

Election off (:class:`NullElection`) = this replica owns every shard and
never touches the lock objects — exactly single-master semantics.
"""

from __future__ import annotations

import threading
import time

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import K8sApiError
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.election")


class NullElection:
    """Election disabled: leader of everything, zero apiserver traffic.
    The token is None, so the intent store skips fence checks too."""

    enabled = False

    def __init__(self, shards: int = 1):
        self.shards = shards

    def is_leader(self, shard: int) -> bool:
        return True

    def token(self, shard: int) -> int | None:
        return None

    def owned(self) -> list[int]:
        return list(range(self.shards))

    def leaders(self) -> dict[int, dict]:
        return {}

    def tick(self, now: float | None = None) -> None:
        pass

    def demote(self, shard: int, reason: str = "") -> None:
        pass

    def note_fence(self, shard: int, fence: int) -> None:
        pass

    def start(self) -> "NullElection":
        return self

    def stop(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {"enabled": False, "shards": self.shards}


class _Held:
    __slots__ = ("token", "valid_until")

    def __init__(self, token: int, valid_until: float):
        self.token = token
        self.valid_until = valid_until


class ShardElection:
    """CAS'd per-shard leadership for one replica.

    ``on_acquire(shard)`` / ``on_lose(shard)`` fire OUTSIDE the internal
    lock, from the tick (or demote) caller's thread — the broker hooks
    shard rehydration and waiter hand-off there.
    """

    enabled = True

    def __init__(self, kube, config, on_acquire=None, on_lose=None):
        self.kube = kube
        self.config = config
        self.shards = config.shards
        self.replica = config.replica
        self.on_acquire = on_acquire or (lambda shard: None)
        self.on_lose = on_lose or (lambda shard: None)
        self._lock = threading.Lock()
        self._held: dict[int, _Held] = {}
        # last observed lock annotations per shard (holder/url/fence/
        # deadline) — what leaders() and the forward path consult
        self._observed: dict[int, dict] = {}
        # highest fence the STORE ever refused us with, per shard: a
        # deleted-and-recreated lock object restarts lock fences at 1,
        # and acquiring below the store's recorded fence would livelock
        # (acquire → fenced write → demote → resume → ...) forever —
        # every acquisition/renewal must clear this floor
        self._fence_floor: dict[int, int] = {}
        self.transitions = 0
        self._loop: threading.Thread | None = None
        self._stop = threading.Event()

    def lock_name(self, shard: int) -> str:
        return f"{consts.ELECTION_CONFIGMAP_PREFIX}{shard}"

    # -- leadership view -------------------------------------------------------

    def is_leader(self, shard: int) -> bool:
        """Leadership is only trusted while the lock we last renewed
        could not have expired yet (local monotonic clock): a partitioned
        holder stops acting BEFORE a peer can legitimately take over."""
        with self._lock:
            held = self._held.get(shard)
            return held is not None and time.monotonic() < held.valid_until

    def token(self, shard: int) -> int | None:
        with self._lock:
            held = self._held.get(shard)
            if held is None or time.monotonic() >= held.valid_until:
                return None
            return held.token

    def owned(self) -> list[int]:
        return [s for s in range(self.shards) if self.is_leader(s)]

    def leaders(self) -> dict[int, dict]:
        """{shard: {holder, url, fence, expired}} from the last observed
        lock records — the forward path's routing table."""
        now = time.time()
        with self._lock:
            out = {}
            for shard, obs in self._observed.items():
                out[shard] = {
                    "holder": obs.get("holder", ""),
                    "url": obs.get("url", ""),
                    "fence": obs.get("fence", 0),
                    "expired": obs.get("deadline", 0.0) <= now,
                }
            return out

    # -- the election loop -----------------------------------------------------

    def start(self) -> "ShardElection":
        if self._loop is None or not self._loop.is_alive():
            self._stop.clear()
            self._loop = threading.Thread(target=self._run, daemon=True,
                                          name="tpumounter-election")
            self._loop.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._loop is not None:
            self._loop.join(timeout=2.0)
            self._loop = None

    def _run(self) -> None:
        # first tick immediately: a fresh replica should pick up free
        # shards now, not one renew interval from now
        while True:
            try:
                self.tick()
            except Exception:        # noqa: BLE001 — loop must survive
                logger.exception("election tick failed")
            if self._stop.wait(self.config.renew_interval_s):
                return

    def tick(self, now: float | None = None) -> None:
        """One acquire-or-renew pass over every shard. ``now`` is
        wall-clock (tests inject); local validity always uses the real
        monotonic clock, anchored at TICK START: the lock's advertised
        deadline is ``now + lease_duration``, so anchoring validity any
        later (e.g. at patch completion, after one RTT per shard) would
        let this replica consider itself leader past the deadline a
        peer is entitled to take over at — an admission overlap."""
        now = time.time() if now is None else now
        mono0 = time.monotonic()
        for shard in range(self.shards):
            try:
                self._tick_shard(shard, now, mono0)
            except K8sApiError as e:
                # apiserver trouble: no state change — leadership decays
                # by itself via valid_until
                logger.warning("election tick shard %d failed: %s", shard,
                               e)
        self._export()

    def _tick_shard(self, shard: int, now: float,
                    mono0: float | None = None) -> None:
        name = self.lock_name(shard)
        mono0 = time.monotonic() if mono0 is None else mono0
        deadline = now + self.config.lease_duration_s
        try:
            cm = self.kube.get_config_map(self.config.namespace, name)
        except K8sApiError as e:
            if e.status != 404:
                raise
            self._try_create(shard, name, deadline, mono0)
            return
        meta = cm.get("metadata", {})
        ann = dict(meta.get("annotations") or {})
        obs = {
            "holder": ann.get("tpumounter.io/holder", ""),
            "url": ann.get("tpumounter.io/url", ""),
            "fence": int(ann.get(consts.STORE_FENCE_ANNOTATION) or 0),
            "deadline": float(ann.get("tpumounter.io/renew-unix") or 0.0),
        }
        with self._lock:
            self._observed[shard] = obs
            we_hold = shard in self._held
        if obs["holder"] == self.replica:
            self._renew(shard, name, meta, obs, deadline, mono0)
        else:
            if we_hold:
                # the lock names someone else: we were deposed (paused
                # past our TTL, fence bumped) — demote NOW, not at
                # valid_until
                self._demote(shard, f"lock held by {obs['holder']!r}")
            if obs["deadline"] <= now:
                self._takeover(shard, name, meta, obs, deadline, mono0)

    def _lock_annotations(self, fence: int, deadline: float) -> dict:
        return {
            "tpumounter.io/holder": self.replica,
            "tpumounter.io/url": self.config.advertise_url,
            consts.STORE_FENCE_ANNOTATION: str(fence),
            "tpumounter.io/renew-unix": f"{deadline:.3f}",
        }

    def _floor(self, shard: int) -> int:
        with self._lock:
            return self._fence_floor.get(shard, 0)

    def note_fence(self, shard: int, fence: int) -> None:
        """A store write bounced off this recorded fence: any future
        token for the shard must exceed it."""
        with self._lock:
            if fence > self._fence_floor.get(shard, 0):
                self._fence_floor[shard] = fence

    def _try_create(self, shard: int, name: str, deadline: float,
                    mono0: float) -> None:
        token = max(1, self._floor(shard) + 1)
        try:
            self.kube.create_config_map(
                self.config.namespace,
                {"apiVersion": "v1", "kind": "ConfigMap",
                 "metadata": {
                     "name": name,
                     "labels": {"app": "tpu-mounter-election"},
                     "annotations": self._lock_annotations(token,
                                                           deadline)}})
        except K8sApiError as e:
            if e.status == 409:
                return               # a peer created it first; next tick
            raise
        self._became_leader(shard, token, deadline, mono0)

    def _renew(self, shard: int, name: str, meta: dict, obs: dict,
               deadline: float, mono0: float) -> None:
        fence = obs["fence"]
        floor = self._floor(shard)
        if fence <= floor:
            # the lock's fence is at or below one the store already
            # refused (a deleted-and-recreated lock object): resuming
            # with it would be a dead token — bump past the floor in
            # the renew patch itself
            fence = floor + 1
        try:
            self.kube.patch_config_map(
                self.config.namespace, name,
                {"metadata": {"annotations":
                              self._lock_annotations(fence, deadline)}},
                resource_version=meta.get("resourceVersion"))
        except K8sApiError as e:
            if e.status in (404, 409):
                # lost a CAS against a peer's takeover (or the lock was
                # deleted): re-observe next tick; validity keeps decaying
                logger.warning("election renew lost CAS on shard %d: %s",
                               shard, e)
                return
            raise
        with self._lock:
            held = self._held.get(shard)
            # a held entry whose validity LAPSED is a resume, not a
            # plain renew: in the decayed window this replica stopped
            # acting (writes parked, is_leader False) — the acquire
            # hooks must re-run so broker state re-syncs with the store
            resumed = (held is None
                       or time.monotonic() >= held.valid_until)
            token = fence if resumed else max(held.token, fence)
            self._held[shard] = _Held(token,
                                      mono0
                                      + self.config.lease_duration_s)
            self._observed[shard] = dict(obs, fence=fence,
                                         deadline=deadline)
        if resumed:
            # the lock still/already named us (restart or decay within
            # our own TTL): resume leadership without bumping the fence
            self._announce_acquire(shard, token)

    def _takeover(self, shard: int, name: str, meta: dict, obs: dict,
                  deadline: float, mono0: float) -> None:
        token = max(obs["fence"], self._floor(shard)) + 1
        try:
            self.kube.patch_config_map(
                self.config.namespace, name,
                {"metadata": {"annotations":
                              self._lock_annotations(token, deadline)}},
                resource_version=meta.get("resourceVersion"))
        except K8sApiError as e:
            if e.status in (404, 409):
                return               # a peer won the takeover race
            raise
        self._became_leader(shard, token, deadline, mono0)

    def _became_leader(self, shard: int, token: int, deadline: float,
                       mono0: float | None = None) -> None:
        mono0 = time.monotonic() if mono0 is None else mono0
        with self._lock:
            self._held[shard] = _Held(token,
                                      mono0
                                      + self.config.lease_duration_s)
            self._observed[shard] = {"holder": self.replica,
                                     "url": self.config.advertise_url,
                                     "fence": token, "deadline": deadline}
        self._announce_acquire(shard, token)

    def _announce_acquire(self, shard: int, token: int) -> None:
        with self._lock:
            self.transitions += 1
        REGISTRY.election_transitions.inc(shard=str(shard),
                                          outcome="acquired")
        REGISTRY.election_is_leader.set(1, shard=str(shard))
        EVENTS.emit("election_acquired", shard=shard, fence=token,
                    replica=self.replica)
        logger.info("acquired shard %d (fence %d) as %s", shard, token,
                    self.replica)
        self.on_acquire(shard)

    def demote(self, shard: int, reason: str = "") -> None:
        """External demotion (a fenced store write proved a peer leads):
        drop leadership immediately."""
        with self._lock:
            held = shard in self._held
        if held:
            self._demote(shard, reason or "fenced store write")

    def _demote(self, shard: int, reason: str) -> None:
        with self._lock:
            if self._held.pop(shard, None) is None:
                return
            self.transitions += 1
        REGISTRY.election_transitions.inc(shard=str(shard),
                                          outcome="lost")
        REGISTRY.election_is_leader.set(0, shard=str(shard))
        EVENTS.emit("election_lost", shard=shard, replica=self.replica,
                    reason=reason)
        logger.warning("lost shard %d (%s)", shard, reason)
        self.on_lose(shard)

    def _export(self) -> None:
        for shard in range(self.shards):
            REGISTRY.election_is_leader.set(
                1 if self.is_leader(shard) else 0, shard=str(shard))

    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            shards = {}
            for shard in range(self.shards):
                obs = self._observed.get(shard) or {}
                held = self._held.get(shard)
                shards[str(shard)] = {
                    "holder": obs.get("holder", ""),
                    "url": obs.get("url", ""),
                    "fence": obs.get("fence", 0),
                    "expires_in_s": round(
                        (obs.get("deadline") or 0.0) - now, 3),
                    "leader": (held is not None
                               and time.monotonic() < held.valid_until),
                }
            return {"enabled": True, "replica": self.replica,
                    "transitions": self.transitions, "shards": shards}
