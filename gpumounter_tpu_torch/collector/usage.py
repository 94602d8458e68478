"""Worker-side GPU usage sampler: duty cycles + device-access accounting
(the port of :mod:`gpumounter_tpu.collector.usage`).

The control plane knows who was *granted* each GPU; this module says what
each GPU is *doing*. It keeps:

- a **bounded ring of per-GPU samples** (duty cycle 0..1 + busy/open
  state), taken by a dedicated background thread every
  ``TPU_USAGE_INTERVAL_S`` seconds — never on an attach/detach request
  thread (tests/test_torch_usage_lint.py pins that no hot-path module can
  even reach this one);
- a **probe seam** (:class:`UsageProbe`). The real path,
  :class:`GpuUsageProbe`, reads per GPU, in order of preference:

  1. **NVML utilization** where ``libnvidia-ml.so.1`` loads: the GPU's
     handle by its UUID (``nvmlDeviceGetHandleByUUID``; never by index or
     PCI address, since a container's ``/dev/nvidiaN`` need not be the
     card of the same number) and ``nvmlDeviceGetUtilizationRates().gpu /
     100``, the share of NVML's last sample period during which a
     kernel ran;
  2. **open-fd detection on the GPU's own node**: busy (duty 1.0) while a
     process holds ``/dev/nvidiaN`` open, through the enumerator's
     ``device_open_pids``. A holder of ``nvidiactl`` or ``nvidia-uvm``
     does not count: every CUDA process holds those, whichever GPU it
     uses.

  NVIDIA drivers have no per-device ``usage`` file, so the control
  plane's sysfs source has no counterpart. The probe reports each GPU's
  source (``duty_source``: ``"nvml"`` or ``"open-fd"``), as the
  enumerator reports ``uuid_source``. It holds NVML initialised for the
  sampler's life (``nvmlInit_v2`` in :meth:`ChipUsageSampler.start`,
  ``nvmlShutdown`` in :meth:`~ChipUsageSampler.stop`), never once per
  sample. A GPU that neither source can read (no NVML handle, and no
  readable ``/proc``) is unobserved: no sample, never a made-up 0.0;
  :class:`FakeUsageProbe` is the settable double tests drive;
- **ownership join**: each sampled GPU is attributed to its owner pod —
  GPUs held through slave pods resolve slave → owner via the worker's
  attachment records and the informer's slave-pod labels, GPUs in the
  pod's own spec attribute directly — so ``GET /utilz`` answers per-GPU
  AND per-owner utilization, the per-lease series the master joins to
  tenants;
- **device-open accounting**: every observed idle→busy transition counts
  one ``tpumounter_device_opens_total{tenant,outcome}`` — attributed to
  the owner's namespace, or ``unattributed`` when a device went busy with
  no owner on record.

``TPU_USAGE=0`` disables the sampler entirely: no thread, no new metric
series, and ``/utilz`` answers ``{"enabled": false}``.
"""

from __future__ import annotations

import abc
import collections
import ctypes
import os
import threading
import time

from gpumounter_tpu_torch.device.enumerator import load_nvml
from gpumounter_tpu_torch.device.model import DeviceState, GPUDevice
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("collector.usage")

# Duty at or below this is "idle" (float noise guard; real probes report
# exact 0.0 for an unopened device).
IDLE_DUTY_EPSILON = 1e-3
# Ring bound: at the 5 s default interval this holds ~1 h of samples.
DEFAULT_RING_SIZE = 720
# Open-fd scans bound the /proc listing so a pid-dense host can't make
# one sampling pass unbounded.
MAX_SCAN_PIDS = 4096
# Duty sources, as /utilz reports them per GPU.
SOURCE_NVML = "nvml"
SOURCE_OPEN_FD = "open-fd"


class UsageProbe(abc.ABC):
    """One observation of per-GPU activity. :meth:`sample` returns
    ``{uuid: duty fraction 0..1}``; a GPU absent from the result is
    unobserved (no sample recorded for it this pass). :meth:`source`
    names where a GPU's last duty came from."""

    @abc.abstractmethod
    def sample(self, chips: list[GPUDevice]) -> dict[str, float]:
        """Duty per GPU uuid for this instant."""

    @abc.abstractmethod
    def source(self, uuid: str) -> str:
        """Where the last duty of ``uuid`` came from."""

    def open(self) -> None:
        """Acquire what the probe holds for the sampler's life."""

    def close(self) -> None:
        """Release what :meth:`open` acquired."""


class FakeUsageProbe(UsageProbe):
    """Settable duties — the sim/fake path tests drive."""

    def __init__(self, default_duty: float = 0.0):
        self.default_duty = default_duty
        self._duties: dict[str, float] = {}
        self._lock = threading.Lock()

    def set_duty(self, uuid: str, duty: float) -> None:
        with self._lock:
            self._duties[uuid] = max(0.0, min(1.0, duty))

    def sample(self, chips: list[GPUDevice]) -> dict[str, float]:
        with self._lock:
            return {c.uuid: self._duties.get(c.uuid, self.default_duty)
                    for c in chips}

    def source(self, uuid: str) -> str:
        return "fake"


class _NvmlUtilization(ctypes.Structure):
    """``nvmlUtilization_t``."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


def load_usage_nvml():
    """``libnvidia-ml.so.1`` as the enumerator binds it, plus the two calls
    the probe adds; None where it does not load."""
    lib = load_nvml()
    if lib is None:
        return None
    for name, argtypes in (
            ("nvmlDeviceGetHandleByUUID",
             [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
            ("nvmlDeviceGetUtilizationRates",
             [ctypes.c_void_p, ctypes.POINTER(_NvmlUtilization)])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


class GpuUsageProbe(UsageProbe):
    """The real path: NVML utilization by UUID, else open-fd detection on
    the GPU's own node (see the module docstring).

    ``lib`` is the NVML library (tests pass a fake); without one,
    :meth:`open` calls ``load`` (:func:`load_usage_nvml`). NVML is used
    only between :meth:`open` and :meth:`close`."""

    def __init__(self, host, enumerator=None, lib=None,
                 load=load_usage_nvml):
        self.host = host
        self.enumerator = enumerator
        self._lib = lib
        self._load = load
        self._nvml = None          # the initialised library, while open
        self._handles: dict[str, ctypes.c_void_p] = {}
        self._sources: dict[str, str] = {}

    def open(self) -> None:
        if self._nvml is not None:
            return
        lib = self._lib if self._lib is not None else self._load()
        if lib is None:
            logger.warning("NVML did not load: GPU duty falls back to "
                           "open-fd detection on each GPU's node")
            return
        rc = lib.nvmlInit_v2()
        if rc != 0:
            logger.warning("nvmlInit_v2 failed (%d): GPU duty falls back "
                           "to open-fd detection on each GPU's node", rc)
            return
        self._nvml = lib

    def close(self) -> None:
        lib, self._nvml = self._nvml, None
        self._handles.clear()
        if lib is not None:
            lib.nvmlShutdown()

    def source(self, uuid: str) -> str:
        return self._sources.get(uuid, "")

    def _nvml_duty(self, chip: GPUDevice) -> float | None:
        lib = self._nvml
        if lib is None or not chip.uuid:
            return None
        handle = self._handles.get(chip.uuid)
        if handle is None:
            handle = ctypes.c_void_p()
            if lib.nvmlDeviceGetHandleByUUID(chip.uuid.encode(),
                                             ctypes.byref(handle)) != 0:
                return None
            self._handles[chip.uuid] = handle
        util = _NvmlUtilization()
        if lib.nvmlDeviceGetUtilizationRates(handle,
                                             ctypes.byref(util)) != 0:
            return None
        return max(0.0, min(1.0, util.gpu / 100.0))

    def _scan_pids(self) -> list[int] | None:
        try:
            entries = os.listdir(self.host.proc_root)
        except OSError:
            return None
        return [int(e) for e in entries if e.isdigit()][:MAX_SCAN_PIDS]

    def _open_paths(self, pids: list[int], paths: list[str]) -> set[str]:
        """Which of ``paths`` some pid in ``pids`` holds open — one
        readlink pass over the given pids' fd tables."""
        targets = set(paths)
        found: set[str] = set()
        for pid in pids:
            fd_dir = os.path.join(self.host.proc_root, str(pid), "fd")
            try:
                fds = os.listdir(fd_dir)
            except OSError:
                continue
            for fd in fds:
                try:
                    target = os.readlink(os.path.join(fd_dir, fd))
                except OSError:
                    continue
                if target in targets:
                    found.add(target)
                    if found == targets:
                        return found
        return found

    def sample(self, chips: list[GPUDevice]) -> dict[str, float]:
        out: dict[str, float] = {}
        fd_chips: list[GPUDevice] = []
        for chip in chips:
            duty = self._nvml_duty(chip)
            if duty is None:
                fd_chips.append(chip)
            else:
                out[chip.uuid] = duty
                self._sources[chip.uuid] = SOURCE_NVML
        if not fd_chips:
            return out
        pids = self._scan_pids()
        if pids is None:
            # neither source can read these GPUs: unobserved, not idle
            for chip in fd_chips:
                self._sources.pop(chip.uuid, None)
            return out
        # only the GPUs' own nodes: a companion's holders say nothing
        # about which GPU is in use
        paths = [c.device_path for c in fd_chips]
        # the pids x fds walk runs once for all GPUs (natively where
        # libgpuprobe is built), yielding the holder pids; the per-path
        # attribution then only walks those few
        holders = pids
        if self.enumerator is not None:
            try:
                holders = self.enumerator.device_open_pids(pids, paths)
            except OSError:
                holders = pids      # degraded: full Python pass
        open_paths = self._open_paths(holders, paths)
        for chip in fd_chips:
            out[chip.uuid] = 1.0 if chip.device_path in open_paths else 0.0
            self._sources[chip.uuid] = SOURCE_OPEN_FD
        return out


def slave_owner_resolver(reads, pool_namespace: str, service=None):
    """Build the sampler's ``owners_fn``: ``{slave pod name: (owner
    namespace, owner pod)}``. Two sources, cheap-first:

    - the worker's own attachment records (``service.attachment_owners``
      — in-memory knowledge of every attach THIS process performed);
    - the informer's cache-served slave-pod listing (owner labels cover
      attaches that predate this worker process).

    Both are best-effort: resolution failure degrades GPUs to
    unattributed (visible in /utilz and the audit counter), never raises
    into the sampler loop."""
    from gpumounter_tpu_torch.k8s import objects
    from gpumounter_tpu_torch.utils.errors import TPUMounterError
    selector = (f"{consts.SLAVE_POD_LABEL_KEY}="
                f"{consts.SLAVE_POD_LABEL_VALUE}")

    def owners() -> dict[str, tuple[str, str]]:
        out: dict[str, tuple[str, str]] = {}
        if reads is not None:
            try:
                for pod in reads.list_pods(pool_namespace,
                                           label_selector=selector):
                    labels = objects.labels(pod)
                    owner = labels.get(consts.OWNER_POD_LABEL_KEY)
                    owner_ns = labels.get(consts.OWNER_NAMESPACE_LABEL_KEY)
                    if owner and owner_ns:
                        out[objects.name(pod)] = (owner_ns, owner)
            except TPUMounterError:
                pass            # degraded to attachment records only
        if service is not None:
            out.update(service.attachment_owners())
        return out

    return owners


def resolve_owner(chip: GPUDevice, owners: dict[str, tuple[str, str]],
                  pool_namespace: str) -> tuple[str, str] | None:
    """The pod a GPU's grant belongs to: through its slave pod's owner for
    a GPU held in the pool namespace, else the pod holding it directly;
    None for a free GPU."""
    if chip.state is not DeviceState.ALLOCATED or not chip.pod_name:
        return None
    if chip.namespace == pool_namespace:
        return owners.get(chip.pod_name)
    return (chip.namespace, chip.pod_name)


class ChipUsageSampler:
    """Bounded-ring sampler + the /utilz snapshot it serves.

    Reads run on the sampler's OWN thread (``start()``) or a test driver
    calling :meth:`sample_once` — never on a request thread; the health
    handler serves :meth:`snapshot` from already-collected state.
    """

    # Inventory-refresh cadence: the kubelet allocation map changes only
    # on attach/detach — which already refresh the collector snapshot —
    # so the sampler's own refresh exists only to catch out-of-band
    # bindings. Refreshing per sample would put a kubelet List (and
    # collector-lock contention with the request path) on every pass.
    DEFAULT_REFRESH_INTERVAL_S = 30.0

    def __init__(self, collector, probe: UsageProbe, *,
                 interval_s: float = consts.DEFAULT_USAGE_INTERVAL_S,
                 ring_size: int = DEFAULT_RING_SIZE,
                 pool_namespace: str = consts.DEFAULT_POOL_NAMESPACE,
                 node_name: str = "", owners_fn=None,
                 refresh_inventory: bool = False,
                 refresh_interval_s: float = DEFAULT_REFRESH_INTERVAL_S,
                 gate=None):
        self.collector = collector
        self.probe = probe
        # Device gate (actuation/gate.py): where it is live, the kernel
        # program keeps exact per-syscall open counts per GPU — each pass
        # pumps them and skips edge accounting for gate-covered GPUs.
        self.gate = gate
        self.interval_s = interval_s
        self.pool_namespace = pool_namespace
        self.node_name = node_name
        # owners_fn() -> {slave pod name: (owner ns, owner pod)}; None =
        # only directly-bound GPUs attribute (unit rigs).
        self.owners_fn = owners_fn
        # refresh_inventory: re-derive the kubelet allocation map at most
        # every refresh_interval_s, ahead of the sample using it (the
        # first sample always refreshes); worker/main.py turns it on.
        self.refresh_inventory = refresh_inventory
        self.refresh_interval_s = refresh_interval_s
        self._last_refresh = -float("inf")
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=max(16, ring_size))
        self._samples = 0
        # uuid -> last observed busy state, for open/close edge
        # accounting; uuid -> cumulative observed opens for /utilz
        self._was_busy: dict[str, bool] = {}
        self._opens: dict[str, int] = {}
        self._opens_outcomes: dict[str, int] = {"attributed": 0,
                                                "unattributed": 0}
        self._exported_chips: set[str] = set()
        self._loop: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ChipUsageSampler":
        """Open the probe (NVML's one init for this sampler's life) and
        start the loop thread."""
        if self._loop is None or not self._loop.is_alive():
            self.probe.open()
            self._stop.clear()
            self._loop = threading.Thread(target=self._run, daemon=True,
                                          name="tpumounter-usage")
            self._loop.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._loop is not None:
            self._loop.join(timeout=2.0)
            self._loop = None
        self.probe.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:        # noqa: BLE001 — loop must survive
                logger.exception("usage sample failed")

    # -- one sampling pass -----------------------------------------------------

    def sample_once(self) -> dict:
        """Collect one sample; returns the recorded entry. Runs on the
        sampler thread or an explicit driver — request threads never
        call this (pinned by the usage lint)."""
        if self.refresh_inventory and (
                time.monotonic() - self._last_refresh
                >= self.refresh_interval_s):
            self.collector.update_status()
            self._last_refresh = time.monotonic()
        chips = self.collector.chips
        duties = self.probe.sample(chips)
        owners = {}
        if self.owners_fn is not None:
            try:
                owners = self.owners_fn() or {}
            except Exception:    # noqa: BLE001 — attribution degrades,
                logger.exception("owner resolution failed")  # never dies
        # Pump the gate's kernel counters first: exact per-syscall opens.
        # The returned coverage set tells the edge accounting below to
        # stand down for those GPUs.
        gate_opens: dict[tuple[int, int], int] = {}
        gate_covered: set[tuple[int, int]] = set()
        if self.gate is not None and self.gate.live:
            try:
                pumped = self.gate.pump()
                gate_opens = pumped["opens"]
                gate_covered = pumped["covered"]
            except Exception:    # noqa: BLE001 — accounting degrades,
                logger.exception("gate counter pump failed")  # never dies
        now = time.time()
        entry_chips: dict[str, dict] = {}
        for chip in chips:
            duty = duties.get(chip.uuid)
            if duty is None:
                continue         # unobserved this pass
            busy = duty > IDLE_DUTY_EPSILON
            owner = resolve_owner(chip, owners, self.pool_namespace)
            record = {
                "duty": round(duty, 4),
                "busy": busy,
                "duty_source": self.probe.source(chip.uuid),
                "device_path": chip.device_path,
                "slave_pod": (chip.pod_name
                              if chip.namespace == self.pool_namespace
                              else ""),
            }
            if owner is not None:
                record["owner"] = f"{owner[0]}/{owner[1]}"
            majmin = (chip.major, chip.minor)
            if majmin in gate_covered:
                record["gated"] = True
            entry_chips[chip.uuid] = record
            if majmin in gate_opens:
                with self._lock:
                    # monotonic: a re-attached map restarts its counter at
                    # 0 — the /utilz per-GPU opens figure never regresses
                    self._opens[chip.uuid] = max(
                        self._opens.get(chip.uuid, 0),
                        gate_opens[majmin])
        entry = {"ts": round(now, 3), "chips": entry_chips}
        with self._lock:
            self._ring.append(entry)
            self._samples += 1
            self._account_edges_locked(entry_chips)
        self._export_gauges(entry_chips)
        return entry

    def _account_edges_locked(self, chips: dict[str, dict]) -> None:
        """Open/close accounting: an idle→busy edge is one observed
        device open (the sampling-resolution view of open(2) on the
        node; the device gate counts the exact syscalls where live)."""
        for uuid, record in chips.items():
            was = self._was_busy.get(uuid, False)
            if record.get("gated"):
                self._was_busy[uuid] = record["busy"]
                continue
            if record["busy"] and not was:
                self._opens[uuid] = self._opens.get(uuid, 0) + 1
                owner = record.get("owner", "")
                outcome = "attributed" if owner else "unattributed"
                self._opens_outcomes[outcome] += 1
                # tenant = the owner pod's namespace: the node cannot
                # see request-time tenant headers, and namespace is the
                # broker's default tenant too — the labels agree
                REGISTRY.device_opens.inc(
                    tenant=owner.split("/", 1)[0] if owner else "",
                    outcome=outcome)
                if not owner:
                    logger.warning(
                        "GPU %s went busy with NO owner attachment on "
                        "record (unattributed device access)", uuid)
            self._was_busy[uuid] = record["busy"]

    def _export_gauges(self, chips: dict[str, dict]) -> None:
        for uuid, record in chips.items():
            REGISTRY.chip_duty_cycle.set(record["duty"], chip=uuid)
        # a GPU that vanished from the inventory must not freeze its last
        # duty on /metrics: zero it ONCE, then forget it
        for uuid in self._exported_chips - set(chips):
            REGISTRY.chip_duty_cycle.set(0.0, chip=uuid)
        self._exported_chips = set(chips)

    # -- the /utilz view -------------------------------------------------------

    def snapshot(self) -> dict:
        """The GET /utilz payload: latest per-GPU state, window averages,
        per-owner rollups and the open accounting — everything already
        collected; serving this performs NO sampling."""
        with self._lock:
            ring = list(self._ring)
            samples = self._samples
            opens = dict(self._opens)
            outcomes = dict(self._opens_outcomes)
        latest = ring[-1] if ring else {"ts": None, "chips": {}}
        sums: dict[str, float] = {}
        counts: dict[str, int] = {}
        last_busy: dict[str, float] = {}
        for entry in ring:
            for uuid, record in entry["chips"].items():
                sums[uuid] = sums.get(uuid, 0.0) + record["duty"]
                counts[uuid] = counts.get(uuid, 0) + 1
                if record["busy"]:
                    last_busy[uuid] = entry["ts"]
        chips_out = []
        owners_out: dict[str, dict] = {}
        unattributed_busy = 0
        for uuid in sorted(latest["chips"]):
            record = latest["chips"][uuid]
            owner = record.get("owner", "")
            avg = (round(sums[uuid] / counts[uuid], 4)
                   if counts.get(uuid) else 0.0)
            row = {
                "chip": uuid,
                "device_path": record["device_path"],
                "duty": record["duty"],
                "duty_source": record["duty_source"],
                "avg_duty": avg,
                "busy": record["busy"],
                "opens": opens.get(uuid, 0),
            }
            if record.get("slave_pod"):
                row["slave_pod"] = record["slave_pod"]
            if owner:
                row["owner"] = owner
            elif record["busy"]:
                row["unattributed_busy"] = True
                unattributed_busy += 1
            if uuid in last_busy:
                row["last_busy_unix"] = last_busy[uuid]
            chips_out.append(row)
            if owner:
                agg = owners_out.setdefault(
                    owner, {"chips": 0, "busy_chips": 0, "duty_sum": 0.0,
                            "last_busy_unix": None})
                agg["chips"] += 1
                agg["busy_chips"] += 1 if record["busy"] else 0
                agg["duty_sum"] += avg
                if uuid in last_busy and (
                        agg["last_busy_unix"] is None
                        or last_busy[uuid] > agg["last_busy_unix"]):
                    agg["last_busy_unix"] = last_busy[uuid]
        for agg in owners_out.values():
            agg["avg_duty"] = round(agg.pop("duty_sum") / agg["chips"], 4)
        return {
            "enabled": True,
            "node": self.node_name,
            "interval_s": self.interval_s,
            "samples": samples,
            "window_samples": len(ring),
            "ts": latest["ts"],
            "chips": chips_out,
            "owners": owners_out,
            "unattributed_busy": unattributed_busy,
            "opens": outcomes,
        }


def build_sampler(service, settings, enumerator=None,
                  gate=None) -> ChipUsageSampler:
    """Production wiring (worker/main.py): :class:`GpuUsageProbe` over the
    host tree and the enumerator's (possibly native) open-fd hook,
    ownership from attachment records + the informer's slave-pod labels,
    inventory refreshed per pass, exact open accounting pumped from the
    device gate where it is live."""
    probe = GpuUsageProbe(
        settings.host,
        enumerator or service.allocator.collector.enumerator)
    return ChipUsageSampler(
        service.allocator.collector, probe,
        interval_s=settings.usage_interval_s,
        pool_namespace=settings.pool_namespace,
        node_name=settings.node_name,
        owners_fn=slave_owner_resolver(service.reads,
                                       settings.pool_namespace,
                                       service=service),
        refresh_inventory=True,
        gate=gate)
