"""gpumounterctl: the operator's command line for the port's master.

The port of :mod:`gpumounter_tpu.cli` (``tpumounterctl``) to NVIDIA GPUs.
The reference's operator UX is raw curl against the master routes
(``docs/guide/QuickStart.md:42-97``, routes at
``cmd/GPUMounter-master/main.go:233-234``). This CLI wraps the same surface
with three things curl doesn't give you:

- **the retry contract**: ``add`` generates an ``X-Request-Id`` and retries
  transient failures WITH THE SAME ID, so a lost HTTP reply can never
  double-attach (the gateway + allocator adoption machinery make the retry
  a resume — see master/gateway.py retry contract);
- **typed exit codes** per result enum, so scripts can branch without
  parsing JSON;
- human-readable output (``--json`` for the raw payload).

It is an HTTP client and nothing more: the stdlib at module scope, the
port's ``utils`` imported lazily by the commands that parse what they
fetch, never ``torch`` (it opens no device and runs where an operator
runs it, with no CUDA context).

Usage (``python -m gpumounter_tpu_torch.cli`` or the ``gpumounterctl``
entry):

    gpumounterctl add  my-pod -n default --gpus 4 --entire
    gpumounterctl remove my-pod -n default --uuids GPU-...,GPU-... --force
    gpumounterctl status my-pod -n default
    gpumounterctl node my-gpu-node
    gpumounterctl slice add    -p ns/pod-a -p ns/pod-b --gpus-per-host 8
    gpumounterctl slice remove -p ns/pod-a -p ns/pod-b --force
    gpumounterctl renew my-pod -n default [--ttl 3600]
    gpumounterctl health
    gpumounterctl trace <request-id>
    gpumounterctl doctor [--node my-gpu-node]
    gpumounterctl cachez --master http://<worker>:1201
    gpumounterctl utilz --master http://<worker>:1201
    gpumounterctl gatez --master http://<worker>:1201

The master address comes from ``--master`` or ``$TPU_MOUNTER_MASTER``
(default ``http://127.0.0.1:8080`` — matching a
``kubectl -n kube-system port-forward svc/gpu-mounter 8080:80``).
Environment names, metric families and the ``chips`` keys of the master's
views are the control plane's; routes, flags and result names follow the
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

DEFAULT_MASTER = "http://127.0.0.1:8080"

# result string -> exit code (0 success; distinct codes for scriptability;
# enum values mirror the proto, api/gpu_mount.proto). The gateway emits
# SCREAMING_SNAKE names from worker enums and CamelCase from its own error
# paths (PodNotFound before a worker is ever dialled) — map both. The
# numbers are the control plane's, under the GPU names.
EXIT_CODES = {
    "SUCCESS": 0,
    "INSUFFICIENT_GPU": 3,
    "InsufficientGPU": 3,
    "POD_NOT_FOUND": 4,
    "PodNotFound": 4,
    "GPU_BUSY": 5,
    "GPUBusy": 5,
    "GPU_NOT_FOUND": 6,
    "GPUNotFound": 6,
    "TopologyMismatch": 7,
    "SliceAttachFailed": 8,
    "SliceDetachIncomplete": 9,
    # attach-broker results (master/admission.py): both are client-
    # retryable 429s, distinct codes so scripts can back off differently
    # (over-quota = wait for a lease to free; full queue = retry shortly)
    "QuotaExceeded": 13,
    "LeaseNotFound": 14,
    "QueueFull": 15,
}
EXIT_TRANSPORT = 10     # couldn't reach / bad response (2 is argparse's)
EXIT_OTHER = 1


class TransportError(Exception):
    pass


def _request(master: str, method: str, path: str, body: bytes | None = None,
             headers: dict[str, str] | None = None,
             timeout: float = 60.0) -> tuple[int, dict]:
    url = master.rstrip("/") + path
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except (json.JSONDecodeError, OSError):
            return e.code, {"result": f"HTTP{e.code}", "message": str(e)}
    except (urllib.error.URLError, TimeoutError, OSError) as e:
        raise TransportError(f"{method} {url}: {e}") from e
    except json.JSONDecodeError as e:
        raise TransportError(f"{method} {url}: unparseable response: "
                             f"{e}") from e


def _request_with_retry(master: str, method: str, path: str,
                        body: bytes | None, request_id: str,
                        attempts: int, timeout: float) -> tuple[int, dict]:
    """Same X-Request-Id on every attempt — the whole point of the retry
    contract: a retry after a lost reply resumes the original request
    instead of allocating a second GPU set."""
    delay = 0.5
    attempts = max(1, attempts)     # tolerate --retries < 0
    for attempt in range(attempts):
        try:
            return _request(master, method, path, body,
                            headers={"X-Request-Id": request_id},
                            timeout=timeout)
        except TransportError as e:
            if attempt == attempts - 1:
                raise
            print(f"transient failure ({e}); retrying with the same "
                  f"request id {request_id}", file=sys.stderr)
            time.sleep(delay)
            delay = min(delay * 2, 5.0)
    raise AssertionError("unreachable")


def _emit(payload: dict, as_json: bool, human: str) -> None:
    print(json.dumps(payload, indent=2) if as_json else human)


def _finish(status: int, payload: dict, as_json: bool,
            human: str) -> int:
    _emit(payload, as_json, human)
    result = str(payload.get("result", ""))
    if result in EXIT_CODES:
        return EXIT_CODES[result]
    return 0 if 200 <= status < 300 else EXIT_OTHER


def _parse_slice_pods(specs: list[str]) -> list[dict]:
    pods = []
    for spec in specs:
        ns, sep, pod = spec.partition("/")
        if not sep:
            ns, pod = "default", spec
        if not pod or not ns:
            raise ValueError(f"bad --pod {spec!r}: want [namespace/]name")
        pods.append({"namespace": ns, "pod": pod})
    return pods


def cmd_add(args) -> int:
    rid = args.request_id or uuid.uuid4().hex[:12]
    path = (f"/addgpu/namespace/{urllib.parse.quote(args.namespace)}"
            f"/pod/{urllib.parse.quote(args.pod)}/gpu/{args.gpus}"
            f"/isEntireMount/{'true' if args.entire else 'false'}")
    status, payload = _request_with_retry(
        args.master, "GET", path, None, rid, args.retries + 1, args.timeout)
    devices = payload.get("device_paths") or []
    human = (f"{payload.get('result')}: {len(devices)} GPU(s) -> "
             f"{args.namespace}/{args.pod}"
             + (f" {devices}" if devices else "")
             + f"  [request_id {payload.get('request_id', rid)}]")
    if payload.get("message"):
        human += f"\n  {payload['message']}"
    return _finish(status, payload, args.json, human)


def cmd_remove(args) -> int:
    path = (f"/removegpu/namespace/{urllib.parse.quote(args.namespace)}"
            f"/pod/{urllib.parse.quote(args.pod)}"
            f"/force/{'true' if args.force else 'false'}")
    body = urllib.parse.urlencode(
        {"uuids": args.uuids} if args.uuids else {}).encode()
    status, payload = _request(args.master, "POST", path, body,
                               timeout=args.timeout)
    human = f"{payload.get('result')}: {args.namespace}/{args.pod}"
    if payload.get("busy_pids"):
        human += f"\n  busy PIDs: {payload['busy_pids']} (use --force)"
    if payload.get("message"):
        human += f"\n  {payload['message']}"
    return _finish(status, payload, args.json, human)


def cmd_renew(args) -> int:
    """Extend a pod's attachment lease (the broker auto-detaches expired
    leases with TPU_LEASE_TTL_S set — long-running experiments heartbeat
    this to keep their GPUs)."""
    path = (f"/renew/namespace/{urllib.parse.quote(args.namespace)}"
            f"/pod/{urllib.parse.quote(args.pod)}")
    if args.ttl is not None:
        path += "?" + urllib.parse.urlencode({"ttl": args.ttl})
    status, payload = _request(args.master, "POST", path,
                               timeout=args.timeout)
    lease = payload.get("lease") or {}
    expires = lease.get("expires_in_s")
    human = (f"{payload.get('result')}: {args.namespace}/{args.pod}"
             + (f" lease extended, expires in {expires}s"
                if expires is not None else
                (" lease extended (never expires)"
                 if payload.get("result") == "SUCCESS" else "")))
    if payload.get("message"):
        human += f"\n  {payload['message']}"
    return _finish(status, payload, args.json, human)


def cmd_status(args) -> int:
    path = (f"/gpustatus/namespace/{urllib.parse.quote(args.namespace)}"
            f"/pod/{urllib.parse.quote(args.pod)}")
    status, payload = _request(args.master, "GET", path,
                               timeout=args.timeout)
    lines = [f"{args.namespace}/{args.pod}: "
             f"mount_type={payload.get('mount_type')}"]
    for gpu in payload.get("gpus", []):
        src = gpu.get("slave_pod") or "pod spec"
        busy = gpu.get("busy_pids") or []
        lines.append(f"  {gpu.get('device_id')}  "
                     f"{gpu.get('device_path')}  via {src}"
                     + (f"  busy:{busy}" if busy else ""))
    return _finish(status, payload, args.json, "\n".join(lines))


def cmd_node(args) -> int:
    path = f"/nodestatus/node/{urllib.parse.quote(args.node)}"
    status, payload = _request(args.master, "GET", path,
                               timeout=args.timeout)
    if "free" not in payload:       # error payload: result + message
        human = f"{payload.get('result')}: {payload.get('message', '')}"
        return _finish(status, payload, args.json, human)
    lines = [f"node {payload.get('node', args.node)}: "
             f"{payload.get('free')}/{payload.get('total')} GPUs free"]
    for gpu in payload.get("gpus", []):
        holder = (f"{gpu.get('namespace')}/{gpu.get('pod_name')}"
                  if gpu.get("state") == "ALLOCATED" else "free")
        extra = gpu.get("accelerator")
        lines.append(f"  {gpu.get('device_id')}  "
                     f"{gpu.get('device_path')}  {holder}"
                     + (f"  [{extra}]" if extra else ""))
    return _finish(status, payload, args.json, "\n".join(lines))


def cmd_slice(args) -> int:
    if args.slice_action == "status":
        return _slice_status(args)
    if not args.pod:
        print("slice add|remove|resize needs at least one --pod",
              file=sys.stderr)
        return EXIT_OTHER
    try:
        pods = _parse_slice_pods(args.pod)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return EXIT_OTHER
    if args.slice_action == "add":
        body = {"pods": pods, "gpusPerHost": args.gpus_per_host or 4}
        if args.strict:
            body["strict"] = True
        path = "/addgpuslice"
    elif args.slice_action == "resize":
        # target membership: the master computes the delta against the
        # group's current members, runs it as a slice txn, and bumps the
        # mesh generation once the new GPU set is fully actuated
        body = {"pods": pods}
        if args.gpus_per_host:
            body["gpusPerHost"] = args.gpus_per_host
        if args.group:
            body["group"] = args.group
        if args.strict:
            body["strict"] = True
        if args.force:
            body["force"] = True
        path = "/slice/resize"
    else:
        body = {"pods": pods, "force": args.force}
        path = "/removegpuslice"
    rid = args.request_id or uuid.uuid4().hex[:12]
    status, payload = _request_with_retry(
        args.master, "POST", path, json.dumps(body).encode(), rid,
        args.retries + 1, args.timeout)
    lines = [f"{payload.get('result')}: {len(pods)} host(s)"]
    if args.slice_action == "resize" and "generation" in payload:
        lines[0] += (f"  group {payload.get('group')} -> generation "
                     f"{payload.get('generation')} "
                     f"(+{len(payload.get('added') or [])} host(s), "
                     f"-{len(payload.get('removed') or [])})")
    for r in payload.get("pods", []):
        lines.append(f"  {r.get('namespace')}/{r.get('pod')}: "
                     f"{r.get('result')} "
                     f"{[d for d in r.get('device_ids', [])]}")
    if payload.get("queued_s") is not None:
        lines.append(f"  (gang-queued {payload['queued_s']}s)")
    if payload.get("rolled_back"):
        lines.append("  (rolled back cleanly)")
    return _finish(status, payload, args.json, "\n".join(lines))


def _slice_status(args) -> int:
    """``gpumounterctl slice status`` — the master's /slicez view: every
    slice group (members, GPUs, mesh generation) and in-flight slice
    transactions. Non-zero exit when a transaction is stranded. The
    payload keeps the control plane's ``chips`` keys (a device count)."""
    status, payload = _request(args.master, "GET", "/slicez",
                               timeout=args.timeout)
    groups = payload.get("groups") or {}
    txns = payload.get("txns") or {}
    lines = [f"{len(groups)} slice group(s), "
             f"{txns.get('pending', 0)} txn(s) in flight, "
             f"{txns.get('stranded', 0)} stranded"]
    for group, info in sorted(groups.items()):
        lines.append(
            f"  group {group}: tenant={info.get('tenant')} "
            f"generation={info.get('generation')} "
            f"gpus={info.get('chips')}")
        barrier = info.get("barrier")
        if barrier:
            joined = len(barrier.get("joined") or [])
            expected = barrier.get("expected")
            missing = ", ".join(barrier.get("missing") or [])
            lines.append(
                f"    barrier gen {barrier.get('generation')}: "
                f"{joined}/{expected} re-federated"
                + (f" ({barrier.get('age_s')}s)"
                   if barrier.get("age_s") is not None else "")
                + (f" STUCK — waiting on: {missing}"
                   if barrier.get("stuck") else
                   (f", waiting on: {missing}" if missing else "")))
        for member in info.get("members", []):
            expires = member.get("expires_in_s")
            lines.append(
                f"    {member.get('namespace')}/{member.get('pod')}: "
                f"{member.get('chips')} GPU(s)"
                + (f" on {member['node']}" if member.get("node") else "")
                + (f", lease expires in {expires}s"
                   if expires is not None else ""))
    for txn in (txns.get("in_flight") or []):
        lines.append(
            f"  txn {txn.get('txn_id')}: {txn.get('state')} "
            f"{len(txn.get('committed') or [])}/"
            f"{len(txn.get('pods') or [])} host(s) committed, "
            f"age {txn.get('age_s')}s rid={txn.get('rid')}")
    rc = _finish(status, payload, args.json, "\n".join(lines))
    if rc == 0 and (int(txns.get("stranded") or 0) > 0
                    or int(payload.get("stuck_barriers") or 0) > 0):
        return 1
    return rc


def _render_waterfall(trace: dict) -> list[str]:
    """ASCII waterfall of one trace dict (the /tracez span tree): one row
    per span, indented by depth, with a timeline bar scaled to the trace
    total so the dominant hop is visible at a glance."""
    total_ms = max(float(trace.get("total_ms") or 0.0), 1e-9)
    root = trace.get("spans") or {}
    t0 = float(root.get("start_unix") or 0.0)
    width = 40
    lines = [f"trace {trace.get('rid')} op={trace.get('op')} "
             f"result={trace.get('result')} "
             f"total={total_ms:.1f}ms"]

    def attrs_str(span: dict) -> str:
        attrs = span.get("attrs") or {}
        if not attrs:
            return ""
        inner = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        return f"  [{inner}]"

    def walk(span: dict, depth: int) -> None:
        dur_ms = float(span.get("duration_ms") or 0.0)
        offset_ms = (float(span.get("start_unix") or t0) - t0) * 1e3
        start = min(width - 1, int(offset_ms / total_ms * width))
        bar_len = max(1, int(dur_ms / total_ms * width))
        bar = ("." * start + "#" * bar_len)[:width].ljust(width, ".")
        name = ("  " * depth + span.get("name", "?"))[:28].ljust(28)
        lines.append(f"  {name} {dur_ms:>9.1f}ms |{bar}|{attrs_str(span)}")
        for child in span.get("children", []) or []:
            walk(child, depth + 1)

    if root:
        walk(root, 0)
    return lines


def cmd_trace(args) -> int:
    """Fetch the stitched trace for one request id from the master's
    /tracez and render it as an ASCII waterfall — master spans
    (resolve/dial/rpc) and the worker's phase spans in one tree."""
    query = urllib.parse.urlencode({"rid": args.request_id})
    status, payload = _request(args.master, "GET", f"/tracez?{query}",
                               timeout=args.timeout)
    traces = payload.get("traces") or []
    if not traces:
        _emit(payload, args.json,
              f"no stored trace for request id {args.request_id!r} "
              "(the store is a bounded ring — old requests rotate out)")
        return EXIT_OTHER
    lines = []
    for trace in traces:
        lines.extend(_render_waterfall(trace))
    for err in payload.get("stitch_errors", []):
        lines.append(f"  (worker spans incomplete: {err})")
    return _finish(status, payload, args.json, "\n".join(lines))


# Informer staleness above this is a WARN in doctor/cachez: with 30s watch
# chunks a healthy stream proves liveness at least every ~35s, so minutes
# of silence means the cache is coasting on its last LIST.
CACHE_STALENESS_WARN_S = 120.0

# Leadership transitions per doctor --window above this WARN as flapping:
# one clean failover is a single acquire (+ the deposed side's lose), so
# more than two transitions inside one observation window means shard
# ownership is bouncing, not failing over.
FLAP_WARN = 2


def cmd_cachez(args) -> int:
    """Shared-informer cache introspection from a worker's health port:
    per-scope staleness (seconds since the watch stream last proved
    liveness), watch restart count, fence position, and hit ratio."""
    try:
        payload = json.loads(_fetch_text(args.master, "/cachez",
                                         args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /cachez payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    if not payload.get("enabled"):
        _emit(payload, args.json,
              "informer disabled on this target (reads go straight to "
              "the apiserver)")
        return 0
    ratio = payload.get("hit_ratio")
    lines = [f"informer cache: {payload.get('hits', 0)} hits / "
             f"{payload.get('misses', 0)} misses"
             + (f" (ratio {ratio})" if ratio is not None else "")
             + f", fence timeout {payload.get('fence_timeout_s')}s"]
    rc = 0
    for scope in payload.get("scopes", []):
        staleness = float(scope.get("staleness_s") or 0.0)
        flags = []
        if not scope.get("seeded"):
            flags.append("NOT SEEDED")
        if not scope.get("running"):
            flags.append("STREAM DOWN")
        if staleness > CACHE_STALENESS_WARN_S:
            flags.append("STALE")
        if flags:
            rc = EXIT_OTHER
        lines.append(
            f"  scope {scope.get('namespace')}/"
            f"{scope.get('selector') or '*'}: {scope.get('pods')} pod(s) "
            f"@ rv {scope.get('resource_version') or '?'}, "
            f"staleness {staleness:.1f}s, "
            f"{scope.get('watch_restarts', 0)} watch restart(s), "
            f"{scope.get('events_seen', 0)} event(s)"
            + (f"  [{', '.join(flags)}]" if flags else ""))
    _emit(payload, args.json, "\n".join(lines))
    return rc


def cmd_agentz(args) -> int:
    """Resident actuation agent introspection from a worker's health
    port: cached namespace handles per container, revalidation outcomes,
    and the fallback count (non-zero = the fork-free warm path is
    degrading to the fallback actuator — doctor WARNs on a windowed
    rate)."""
    try:
        payload = json.loads(_fetch_text(args.master, "/agentz",
                                         args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /agentz payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    if not payload.get("enabled"):
        _emit(payload, args.json,
              "actuation agent disabled on this target (per-call "
              "actuation, no cached ns fds)")
        return 0
    counters = payload.get("counters", {})
    fallbacks = int(counters.get("fallbacks", 0))
    stale = int(counters.get("revalidations_stale", 0))
    lines = [
        f"actuation agent: mode={payload.get('mode')} "
        f"executor={'alive' if payload.get('executor_alive') else 'DOWN'}, "
        f"{counters.get('batches', 0)} batch(es), "
        f"{counters.get('revalidations_ok', 0)} revalidation(s) ok / "
        f"{stale} stale, {fallbacks} fallback(s)"]
    for handle in payload.get("ns_fds", []):
        lines.append(f"  ns fd pid {handle.get('pid')}: "
                     f"age {handle.get('age_s')}s, "
                     f"{handle.get('uses')} use(s) "
                     f"({handle.get('anchor')})")
    if not payload.get("ns_fds"):
        lines.append("  (no cached ns handles — no container actuated "
                     "since boot)")
    rc = 0
    if fallbacks:
        lines.append(f"  WARNING: {fallbacks} fallback(s) — the resident "
                     "path is degrading; check worker logs for the "
                     "fault reason")
        rc = EXIT_OTHER
    _emit(payload, args.json, "\n".join(lines))
    return rc


def cmd_gatez(args) -> int:
    """Render a worker's /gatez (kernel device gate): backend, per-
    container entries, the deny ring with revocation reasons, drift from
    the reconciler audit. Exit non-zero on denials (a workload is
    hammering access it lost — or never had) or on gate/lease drift (a
    grant outlived its attachment before the audit reclaimed it)."""
    try:
        payload = json.loads(_fetch_text(args.master, "/gatez",
                                         args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /gatez payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    if not payload.get("enabled"):
        _emit(payload, args.json,
              "device gate disabled on this target "
              f"(mode={payload.get('mode', 'legacy')} — cgroup writes / "
              "program replacement, no kernel policy maps)")
        return 0
    counts = payload.get("counts") or {}
    denials = payload.get("denials") or {}
    drift = payload.get("drift") or {}
    entries = payload.get("entries") or []
    lines = [
        f"device gate: backend={payload.get('backend')} "
        f"node={payload.get('node') or '?'}: "
        f"{len(entries)} gated container(s), "
        f"{counts.get('grants', 0)} grant(s) / "
        f"{counts.get('revokes', 0)} revoke(s), "
        f"{counts.get('faults', 0)} fault(s) degraded to legacy, "
        f"{denials.get('total', 0)} denial(s)"]
    for entry in entries:
        chips = entry.get("chips") or []
        lines.append(
            f"  {entry.get('namespace')}/{entry.get('pod')}: "
            f"{len(chips)} GPU(s), {entry.get('rules')} rule(s)"
            + ("" if entry.get("enforced") else "  [UNENFORCED: no "
               "device program on this cgroup]"))
    for deny in (denials.get("recent") or [])[-8:]:
        lines.append(
            f"  DENY {deny.get('device')} tenant={deny.get('tenant') or '?'}"
            f" reason={deny.get('reason')}"
            + (f" x{deny['count']}" if deny.get("count", 1) > 1 else ""))
    rc = 0
    if drift.get("count"):
        lines.append(f"  CRITICAL: {drift['count']} gate entr(ies) "
                     "granted GPUs with no live owner attachment "
                     "(reclaimed by the audit — revocation raced a crash)")
        rc = EXIT_OTHER
    if denials.get("total"):
        lines.append(f"  WARNING: {denials['total']} denial(s) — evicted "
                     "holders are still retrying revoked devices; "
                     "reasons above")
        rc = rc or EXIT_OTHER
    pending = payload.get("journal_pending", 0)
    if pending:
        lines.append(f"  note: {pending} gate journal record(s) pending "
                     "(mutation in flight or awaiting convergence)")
    _emit(payload, args.json, "\n".join(lines))
    return rc


def cmd_utilz(args) -> int:
    """Render a worker's /utilz (GPU utilization & device-access
    accounting): per-GPU duty cycle + window average and where the duty
    came from (``duty_source``: NVML utilization, or an open fd on the
    GPU's own node), per-lease attribution (GPU → slave pod → owner pod),
    idle flags and the device-open accounting. A GPU with no duty reading
    is shown as unobserved, never as 0%. Exit non-zero on UNATTRIBUTED
    busy GPUs — a device in use with no owner attachment on record is
    access outside the control plane's grants."""
    try:
        payload = json.loads(_fetch_text(args.master, "/utilz",
                                         args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /utilz payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    if not payload.get("enabled"):
        _emit(payload, args.json,
              "usage sampler disabled on this target (TPU_USAGE=0 — "
              "no duty cycles, no device-open accounting)")
        return 0
    gpus = payload.get("chips") or []
    busy = sum(1 for g in gpus if g.get("busy"))
    opens = payload.get("opens") or {}
    lines = [f"node {payload.get('node') or '?'}: {busy}/{len(gpus)} "
             f"GPU(s) busy, sampled every {payload.get('interval_s')}s "
             f"({payload.get('window_samples', 0)} sample(s) held); "
             f"opens: {opens.get('attributed', 0)} attributed / "
             f"{opens.get('unattributed', 0)} unattributed"]
    unattributed = 0
    for gpu in gpus:
        owner = gpu.get("owner")
        flags = []
        if gpu.get("unattributed_busy"):
            flags.append("UNATTRIBUTED BUSY")
            unattributed += 1
        elif not gpu.get("busy"):
            flags.append("idle")
        via = (f" via {gpu['slave_pod']}" if gpu.get("slave_pod")
               else "")
        if gpu.get("duty") is None:
            duty = "duty unobserved"
        else:
            duty = (f"duty {100 * float(gpu['duty']):.0f}% "
                    f"(avg {100 * float(gpu.get('avg_duty') or 0):.0f}%)"
                    f" from {gpu.get('duty_source') or '?'}")
        lines.append(
            f"  GPU {gpu.get('chip')}  {gpu.get('device_path')}  "
            f"{duty}  {owner or 'no owner'}{via}  "
            f"opens:{gpu.get('opens', 0)}"
            + (f"  [{', '.join(flags)}]" if flags else ""))
    for owner, agg in sorted((payload.get("owners") or {}).items()):
        lines.append(
            f"  lease {owner}: {agg.get('busy_chips')}/{agg.get('chips')}"
            f" GPU(s) busy, avg duty "
            f"{100 * float(agg.get('avg_duty') or 0):.0f}%")
    if unattributed:
        lines.append(f"  WARNING: {unattributed} busy GPU(s) with NO "
                     "owner attachment on record — device access outside "
                     "the control plane's grants")
    _emit(payload, args.json, "\n".join(lines))
    return EXIT_OTHER if unattributed else 0


def cmd_topo(args) -> int:
    """Render the master's /topoz fleet-topology view: per node its
    accelerator, an ASCII occupancy row (a GPU node's mesh is ``[1, N]``:
    each GPU at its rank, lettered by owner) and one line per GPU with its
    UUID, the fragmentation score, stranded-GPU count (always 0 on GPU
    nodes, kept for the control plane's payload), group contiguity and
    the defrag candidate report. Exit non-zero when any GPU is stranded."""
    try:
        payload = json.loads(_fetch_text(args.master, "/topoz",
                                         args.timeout))
    except TransportError as e:
        if "404" in str(e):
            # the master answers NoSuchRoute under TPU_TOPOLOGY=0 — a
            # disabled plane is a state, not a transport failure
            print("topology plane disabled on this target "
                  "(TPU_TOPOLOGY=0 — no /topoz, no fragmentation "
                  "scoring)")
            return 0
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /topoz payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    if not payload.get("enabled"):
        _emit(payload, args.json,
              "topology plane disabled on this target (TPU_TOPOLOGY=0 "
              "— no /topoz, no fragmentation scoring)")
        return 0
    fleet = payload.get("fleet") or {}
    fleet_nodes = fleet.get("nodes") or {}
    nodes = payload.get("nodes") or {}
    lines = []
    if fleet:
        lines.append(
            f"fleet: frag {float(fleet.get('score') or 0):.2f} "
            f"(largest free block {fleet.get('largest_free_block', 0)} "
            f"of {fleet.get('free', 0)} free), "
            f"{fleet.get('stranded', 0)} stranded GPU(s)")
    else:
        lines.append("fleet: no topology scored yet (no /topoz scrape "
                     "has completed)")
    # one letter per owner across the whole fleet, stable by sort order
    owners = sorted({g["owner"] for n in nodes.values()
                     for g in n.get("chips") or [] if g.get("owner")})
    letters = {owner: chr(ord("A") + i % 26)
               for i, owner in enumerate(owners)}
    for node in sorted(nodes):
        n = nodes[node]
        gpus = n.get("chips") or []
        scored = fleet_nodes.get(node) or {}
        mesh = n.get("mesh") or [0, 0]
        lines.append(
            f"  {node}: {n.get('free', 0)} free / "
            f"{n.get('leased', 0)} leased on "
            f"{mesh[0]}x{mesh[1]}"
            + (f" ({n['accelerator']})" if n.get("accelerator") else "")
            + f", {n.get('gpus_per_node') or len(gpus)} GPU(s) per node"
            + (f"  frag {float(scored.get('frag') or 0):.2f}"
               f"  largest free block "
               f"{scored.get('largest_free_block', 0)}"
               + (f"  {scored['stranded']} STRANDED"
                  if scored.get("stranded") else "")
               if scored else ""))
        rows, cols = (mesh + [0, 0])[:2]
        grid = [["?"] * max(cols, 0) for _ in range(max(rows, 0))]
        for gpu in gpus:
            r, c = (gpu.get("coord") or [0, 0])[:2]
            if not (0 <= r < rows and 0 <= c < cols):
                continue
            if gpu.get("state") == "free":
                grid[r][c] = "."
            else:
                grid[r][c] = letters.get(gpu.get("owner", ""), "#")
        for row in grid:
            lines.append("    " + " ".join(row))
        for gpu in gpus:
            lines.append(
                f"      {gpu.get('coord')}  {gpu.get('chip')}  "
                f"{gpu.get('device_path')}  {gpu.get('state')}"
                + (f"  {gpu['owner']}" if gpu.get("owner") else ""))
    for owner in owners:
        lines.append(f"  {letters[owner]} = {owner}")
    for group, info in sorted((fleet.get("groups") or {}).items()):
        verdict = {True: "contiguous", False: "SCATTERED",
                   None: "unknown"}[info.get("contiguous")]
        lines.append(f"  group {group}: hosts "
                     f"{','.join(info.get('hosts') or [])} — {verdict}")
    for cand in fleet.get("defrag_candidates") or []:
        lines.append(
            f"  defrag candidate: {cand.get('namespace')}/"
            f"{cand.get('pod')} (tenant {cand.get('tenant')}, "
            f"{cand.get('chips')} GPU(s) on {cand.get('node')}"
            + (", idle" if cand.get("idle") else "")
            + f") would grow the largest free block by "
            f"{cand.get('gain')}")
    stranded = int(fleet.get("stranded") or 0)
    if stranded:
        lines.append(f"  WARNING: {stranded} stranded GPU(s) — free "
                     "capacity in fragments no topology-aligned grant "
                     "can use")
    _emit(payload, args.json, "\n".join(lines))
    return EXIT_OTHER if stranded else 0


def cmd_defrag(args) -> int:
    """Render the fleet defragmenter's state (the ``defrag`` section of
    the master's /fleetz): mode, the standing gain-sorted plans, the
    recent move ring with outcomes, moves in flight and the sliding
    move budget. Exit non-zero when the budget is exhausted — the
    actuator has halted itself and the fleet stays fragmented until the
    window slides (or someone raises TPU_DEFRAG_BUDGET)."""
    try:
        payload = json.loads(_fetch_text(args.master, "/fleetz",
                                         args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /fleetz payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    defrag = payload.get("defrag")
    if not isinstance(defrag, dict):
        # TPU_DEFRAG_MODE=0 removes the actuator AND its /fleetz
        # section — a disabled defragmenter is a state, not an error
        _emit({"defrag": None}, args.json,
              "defragmenter disabled on this target (TPU_DEFRAG_MODE=0 "
              "— no planning, no moves; the topology plane may still "
              "report candidates under `gpumounterctl topo`)")
        return 0
    budget = defrag.get("budget") or {}
    mode = defrag.get("mode", "?")
    lines = [
        f"defrag: mode {mode}"
        + (" (journal + report only — no moves)" if mode == "plan"
           else "")
        + f", {defrag.get('inflight', 0)} move(s) in flight, "
        f"budget {budget.get('used', 0)}/{budget.get('limit', 0)} "
        f"move(s) in the last {float(budget.get('window_s') or 0):g}s"]
    if budget.get("exhausted"):
        lines.append("  BUDGET EXHAUSTED — actuator halted until the "
                     "window slides")
    plans = defrag.get("plans") or []
    for plan in plans:
        lines.append(
            f"  plan {plan.get('rid')}: move {plan.get('namespace')}/"
            f"{plan.get('pod')} (tenant {plan.get('tenant')}, "
            f"{plan.get('chips')} GPU(s)) off {plan.get('node')} — "
            f"grows the largest free block by {plan.get('gain')} "
            f"(group {plan.get('group')})")
    if not plans:
        lines.append("  no standing plans — nothing is eligible to "
                     "move (fragmentation below gain, leases busy, or "
                     "hysteresis still counting)")
    for entry in defrag.get("recent") or []:
        detail = " ".join(f"{k}={v}" for k, v in sorted(entry.items())
                          if k not in ("outcome", "unix"))
        lines.append(f"  recent: {str(entry.get('outcome', '?')).upper()}"
                     + (f"  {detail}" if detail else ""))
    _emit(defrag, args.json, "\n".join(lines))
    return EXIT_OTHER if budget.get("exhausted") else 0


def cmd_fleet(args) -> int:
    """Render the master's /fleetz cluster view: per-node scrape health,
    per-tenant GPUs in use, top SLO burn, and the merged lifecycle event
    tail. Exit non-zero when any node is stale (unscraped)."""
    path = ("/fleetz" if args.events <= 0
            else f"/fleetz?limit={args.events}")
    try:
        payload = json.loads(_fetch_text(args.master, path,
                                         args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /fleetz payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    nodes = payload.get("nodes") or {}
    lines = [f"fleet: {len(nodes)} worker(s), "
             f"{payload.get('ticks', 0)} scrape tick(s) "
             f"@ {payload.get('tick_interval_s')}s"]
    rc = 0
    topo_nodes = (payload.get("topology") or {}).get("nodes") or {}
    for node in sorted(nodes):
        n = nodes[node]
        state = n.get("state", "?")
        if state != "fresh":
            rc = EXIT_OTHER
        chips = n.get("chips") or {}
        chip_str = " ".join(f"{k.lower()}:{v}"
                            for k, v in sorted(chips.items())) or "-"
        # utilization column (the node's /utilz summary): busy/total
        # observed GPUs + mean duty; "-" for sampler-off workers
        util = n.get("utilization") or {}
        util_str = (f"{util.get('chips_busy', 0)}/"
                    f"{util.get('chips_total', 0)} busy "
                    f"{100 * float(util.get('avg_duty') or 0):.0f}%"
                    if util else "-")
        # frag column (the node's /topoz-derived score): 1 - largest
        # schedulable free block / free GPUs; "-" with the topology
        # plane off or the node not yet scored
        topo = topo_nodes.get(node) or {}
        frag_str = (f"{float(topo.get('frag') or 0.0):.2f}"
                    if topo else "-")
        extras = []
        if topo.get("stranded"):
            extras.append(f"{topo['stranded']} stranded GPU(s)")
        if util.get("unattributed_busy"):
            extras.append(f"{util['unattributed_busy']} unattributed "
                          "busy GPU(s)")
        if n.get("journal_backlog"):
            extras.append(f"journal backlog {n['journal_backlog']}")
        if n.get("missed_ticks"):
            extras.append(f"{n['missed_ticks']} missed tick(s)")
        if n.get("error"):
            extras.append(n["error"])
        lines.append(
            f"  {node}: {state.upper()}  gpus[{chip_str}]  "
            f"util[{util_str}]  "
            + (f"frag[{frag_str}]  " if topo_nodes else "")
            + f"events@{n.get('events_seq', 0)}"
            + (f"  [{'; '.join(extras)}]" if extras else ""))
    # HA posture of the answering master (docs/guide/HA.md): its role per
    # shard, the peers its lock records name, and store lag — a stuck
    # failover (leaderless shard, lagging store) is visible right here.
    masters = payload.get("masters") or {}
    if masters.get("enabled"):
        replica = masters.get("replica", "?")
        shards = (masters.get("election") or {}).get("shards")
        if not isinstance(shards, dict):
            # store-only HA (election off): NullElection reports shards
            # as a plain count — no per-shard roles to render
            shards = {}
        roles = []
        for shard in sorted(shards, key=lambda s: int(s)):
            s = shards[shard]
            holder = s.get("holder") or "NONE"
            expires = float(s.get("expires_in_s") or 0.0)
            if s.get("leader"):
                roles.append(f"{shard}:LEADER")
            elif expires <= 0:
                # observed lock expired and nobody here holds it: either
                # failover in flight or the shard is down — flag it
                roles.append(f"{shard}:NO-LEADER({holder})")
                rc = EXIT_OTHER
            else:
                roles.append(f"{shard}:follower({holder})")
        store = masters.get("store") or {}
        store_str = ""
        if store:
            lag = float(store.get("lag_s") or 0.0)
            store_str = (f"  store lag {lag:g}s"
                         + (f" ({store.get('dirty')} dirty)"
                            if store.get("dirty") else ""))
            if store.get("torn_records"):
                store_str += f" torn={store['torn_records']}"
        lines.append(f"  master {replica}: " + " ".join(roles)
                     + store_str)
    tenants = payload.get("tenants") or {}
    if tenants:
        lines.append("  tenants: " + ", ".join(
            f"{t}={c} GPU(s)" for t, c in sorted(tenants.items())))
    # fleet-wide fragmentation + the cross-shard tenant rollup (the
    # topology plane; absent under TPU_TOPOLOGY=0)
    topology = payload.get("topology") or {}
    if topology:
        lines.append(
            f"  topology: frag {float(topology.get('score') or 0):.2f} "
            f"(largest free block {topology.get('largest_free_block', 0)}"
            f" of {topology.get('free', 0)} free), "
            f"{topology.get('stranded', 0)} stranded GPU(s), "
            f"{len(topology.get('defrag_candidates') or [])} defrag "
            "candidate(s)")
    tenants_global = (payload.get("global_tenants") or {}).get("tenants")
    if tenants_global:
        lines.append("  global tenants: " + ", ".join(
            f"{t}={c} GPU(s)"
            for t, c in sorted(tenants_global.items())))
    # per-tenant utilization + the idle-lease list (GPUs held but not
    # computing — the capacity the broker's idle-aware preemption and
    # the fractional-sharing roadmap item reclaim/pack)
    utilization = payload.get("utilization") or {}
    util_tenants = utilization.get("tenants") or {}
    if util_tenants:
        lines.append("  utilization: " + ", ".join(
            f"{t}={100 * float(agg.get('avg_duty') or 0):.0f}% "
            f"({agg.get('busy_chips', 0)}/{agg.get('chips', 0)} busy)"
            for t, agg in sorted(util_tenants.items())))
    for idle in utilization.get("idle_leases") or []:
        lines.append(
            f"  idle lease: {idle.get('namespace')}/{idle.get('pod')} "
            f"(tenant {idle.get('tenant')}, {idle.get('chips')} GPU(s)"
            + (f" on {idle['node']}" if idle.get("node") else "")
            + f") idle {idle.get('idle_for_s')}s")
    top = (payload.get("slo") or {}).get("top_burn")
    if top:
        lines.append(f"  top burn: tenant {top.get('tenant')} "
                     f"slo {top.get('slo')} burn {top.get('burn')} (5m)")
    tail = (payload.get("events") or [])[-args.events:] \
        if args.events > 0 else []
    for event in tail:
        attrs = event.get("attrs") or {}
        detail = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(
            f"    {event.get('ts')} [{event.get('node') or 'master'}] "
            f"{event.get('kind')} rid={event.get('rid', '-') or '-'} "
            + detail)
    _emit(payload, args.json, "\n".join(lines))
    return rc


def cmd_nodes(args) -> int:
    """Render the master's node failure-domain view (/fleetz
    node_health + the broker's lease table): per-node judged health
    state, scrape staleness, and the leases still anchored to each
    node. Exit non-zero on a DEAD node that still holds leases — the
    exact state fencing exists to eliminate (stuck fence = stranded
    GPUs + quota)."""
    try:
        fleetz = json.loads(_fetch_text(args.master, "/fleetz",
                                        args.timeout))
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    except ValueError as e:
        print(f"bad /fleetz payload: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    try:
        brokerz = json.loads(_fetch_text(args.master, "/brokerz",
                                         args.timeout))
    except (TransportError, ValueError):
        brokerz = {}
    health = fleetz.get("node_health")
    if not isinstance(health, dict):
        _emit(fleetz, args.json,
              "node health subsystem disabled (TPU_NODE_HEALTH=0) — "
              "see `gpumounterctl fleet` for scrape state")
        return 0
    leases_by_node: dict[str, list[str]] = {}
    for lease in (brokerz.get("leases") or {}).get("leases") or []:
        leases_by_node.setdefault(lease.get("node") or "", []).append(
            f"{lease.get('namespace')}/{lease.get('pod')}")
    scrape_nodes = fleetz.get("nodes") or {}
    entries = health.get("nodes") or {}
    lines = [f"nodes: {len(entries)} tracked "
             f"(suspect after {health.get('suspect_after_ticks')} "
             f"missed tick(s), dead after "
             f"{health.get('dead_after_ticks')})"]
    rc = 0
    for node in sorted(set(entries) | (set(scrape_nodes) - {""})):
        entry = entries.get(node) or {}
        state = entry.get("state", "healthy")
        held = leases_by_node.get(node, [])
        extras = []
        if entry.get("reason"):
            extras.append(entry["reason"])
        if entry.get("missed_ticks"):
            extras.append(f"{entry['missed_ticks']} missed tick(s)")
        scrape = (scrape_nodes.get(node) or {}).get("state")
        if scrape and scrape != "fresh":
            extras.append(f"scrape {scrape}")
        if held:
            extras.append(f"{len(held)} lease(s): "
                          + ", ".join(sorted(held)))
        line = (f"  {node}: {state.upper()}"
                + (f"  [{'; '.join(extras)}]" if extras else ""))
        if state == "dead" and held:
            line += "  <-- DEAD WITH LIVE LEASES (fence stuck?)"
            rc = EXIT_OTHER
        lines.append(line)
    fenced = brokerz.get("fenced") or []
    for entry in fenced[-5:]:
        lines.append(f"  fenced: {entry.get('namespace')}/"
                     f"{entry.get('pod')} ({entry.get('chips')} "
                     f"GPU(s) on {entry.get('node') or '?'}, "
                     f"{entry.get('reason')})")
    _emit({"node_health": health, "fenced": fenced}, args.json,
          "\n".join(lines))
    return rc


def cmd_flight(args) -> int:
    """Inspect flight-recorder bundles (local TPU_FLIGHT_DIR — the
    recorder writes on the master/worker host, so run this where the
    process runs or on a copy of the directory)."""
    from gpumounter_tpu_torch.utils.flight import FlightRecorder
    flight_dir = args.dir or os.environ.get("TPU_FLIGHT_DIR", "")
    if not flight_dir:
        print("no flight dir: pass --dir or set TPU_FLIGHT_DIR",
              file=sys.stderr)
        return EXIT_OTHER
    if args.flight_action == "list":
        bundles = FlightRecorder.list_bundles(flight_dir)
        if args.json:
            print(json.dumps(bundles, indent=2))
            return 0
        if not bundles:
            print(f"no flight bundles in {flight_dir}")
            return 0
        for b in bundles:
            print(f"{b.get('id')}  trigger={b.get('trigger')}  "
                  f"rid={b.get('rid') or '-'}  ts={b.get('ts')}  "
                  f"{b.get('events', 0)} event(s)")
        return 0
    bundle = FlightRecorder.load(flight_dir, args.bundle_id)
    if bundle is None:
        print(f"no bundle {args.bundle_id!r} in {flight_dir}",
              file=sys.stderr)
        return EXIT_OTHER
    if bundle.get("error") and "trigger" not in bundle:
        print(f"bundle {args.bundle_id!r} is unreadable "
              f"(corrupt or partially written)", file=sys.stderr)
        return EXIT_OTHER
    if args.json:
        print(json.dumps(bundle, indent=2))
        return 0
    print(f"bundle {bundle.get('id')}  trigger={bundle.get('trigger')}  "
          f"rid={bundle.get('rid') or '-'}  ts={bundle.get('ts')}")
    if bundle.get("context"):
        print(f"  context: {bundle['context']}")
    rid_events = bundle.get("rid_events") or []
    for event in rid_events or (bundle.get("events") or [])[-10:]:
        attrs = event.get("attrs") or {}
        detail = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        print(f"  event {event.get('seq')}: {event.get('kind')} "
              f"rid={event.get('rid', '-') or '-'} {detail}")
    traces = bundle.get("traces") or {}
    for group in ("rid", "failed", "slowest"):
        for trace in traces.get(group) or []:
            print(f"  trace[{group}] op={trace.get('op')} "
                  f"rid={trace.get('rid')} result={trace.get('result')} "
                  f"total={trace.get('total_ms')}ms")
    journal = bundle.get("journal")
    if isinstance(journal, dict):
        print(f"  journal: backlog={journal.get('backlog')}, "
              f"{len(journal.get('records') or [])} record(s)")
    broker = bundle.get("broker")
    if isinstance(broker, dict):
        leases = (broker.get("leases") or {}).get("count")
        print(f"  broker: {leases} lease(s), queue depth "
              f"{(broker.get('queue') or {}).get('depth')}")
    return 0


def cmd_health(args) -> int:
    try:
        status, payload = _request(args.master, "GET", "/healthz",
                                   timeout=args.timeout)
    except TransportError as e:
        print(f"unreachable: {e}", file=sys.stderr)
        return EXIT_TRANSPORT
    return _finish(status, payload, args.json,
                   f"master {args.master}: {payload.get('status')}")


# -- doctor -------------------------------------------------------------------

def _fetch_text(master: str, path: str, timeout: float) -> str:
    url = master.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode()
    except (urllib.error.URLError, TimeoutError, OSError) as e:
        raise TransportError(f"GET {url}: {e}") from e


# The exposition parser lives next to the renderer it round-trips with
# (utils/metrics.py); wrapped under the historical name because doctor's
# helpers and the existing tests address it as cli._parse_exposition.
# Imported lazily: the CLI's module scope is stdlib-only, and commands
# that never scrape (health, add, remove) must not pay for constructing
# the full metrics Registry at startup.
def _parse_exposition(text: str) -> dict:
    from gpumounter_tpu_torch.utils.metrics import parse_exposition
    return parse_exposition(text)


def _histogram_quantile(metrics: dict, family: str, q: float,
                        **match: str) -> float | None:
    """Bucket-interpolated quantile (the promql histogram_quantile
    estimate) over the matching series of ``<family>_bucket``."""
    buckets: dict[float, float] = {}
    for labels, value in metrics.get(f"{family}_bucket", {}).items():
        d = dict(labels)
        if any(d.get(k) != v for k, v in match.items()):
            continue
        le = d.get("le", "")
        bound = float("inf") if le == "+Inf" else float(le)
        buckets[bound] = buckets.get(bound, 0.0) + value
    if not buckets:
        return None
    total = buckets.get(float("inf"), 0.0)
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound in sorted(buckets):
        count = buckets[bound]
        if count >= target:
            if bound == float("inf"):
                return prev_bound
            if count == prev_count:
                return bound
            frac = (target - prev_count) / (count - prev_count)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_count = bound, count
    return prev_bound


def _counter_total(metrics: dict, family: str, **match: str) -> float:
    return sum(value for labels, value in metrics.get(family, {}).items()
               if all(dict(labels).get(k) == v for k, v in match.items()))


EXIT_DOCTOR_CRIT = 12   # NOT 2 — argparse owns 2 for usage errors, and a
                        # cron wrapper's typo must never page as a CRIT


def cmd_doctor(args) -> int:
    """One-shot cluster diagnosis from the target's own surfaces: liveness,
    error counters, latency vs the 3s baseline, rollbacks, and (with
    --node) the node's GPU inventory. Exit 0 = healthy, 1 = warnings,
    12 = critical. Error counters are cumulative, so without --window they
    can only WARN; liveness/node failures, and windowed error activity,
    are what CRIT.

    Metric scope honesty: master and workers are separate processes with
    separate registries. Against the master (the default), the error/
    latency checks see the master's own counters (master_*/slice_* result
    labels, slice-level rollback spans); the worker-local families
    (attach_seconds, bare EXCEPTION, actuation rollbacks) live on each
    node's :1201 — point --master at a worker's metrics port to audit one
    node, and doctor says which view it found rather than reporting a
    blind 'all clear'. The reference had no equivalent — its runbook was
    'read the worker logs'."""
    checks: list[tuple[str, str]] = []     # (level, message)

    def check(level: str, message: str) -> None:
        checks.append((level, message))

    def finish() -> int:
        worst = max(({"ok": 0, "warn": 1, "crit": 2}[lvl]
                     for lvl, _ in checks), default=0)
        rc = {0: 0, 1: 1, 2: EXIT_DOCTOR_CRIT}[worst]
        if getattr(args, "json", False):
            print(json.dumps({"checks": [
                {"level": lvl, "message": msg} for lvl, msg in checks],
                "worst": ["ok", "warn", "crit"][worst],
                "exit_code": rc}, indent=2))
        else:
            icon = {"ok": "OK  ", "warn": "WARN", "crit": "CRIT"}
            for level, message in checks:
                print(f"{icon[level]} {message}")
        return rc

    try:
        # lenient parse: the master's /healthz is JSON, a worker's :1201
        # sidecar answers plain "ok" — doctor audits either
        raw = _fetch_text(args.master, "/healthz", args.timeout).strip()
        try:
            status_str = json.loads(raw).get("status")
        except (json.JSONDecodeError, AttributeError):
            status_str = raw[:40]
        check("ok", f"master reachable, status={status_str}")
    except TransportError as e:
        check("crit", f"master unreachable: {e}")
        return finish()

    try:
        metrics = _parse_exposition(
            _fetch_text(args.master, "/metrics", args.timeout))
    except TransportError as e:
        check("warn", f"/metrics unreadable: {e}")
        metrics = {}

    # Counters are cumulative since process start: a snapshot cannot
    # distinguish one historical incident from an ongoing one, so lifetime
    # totals may only WARN (a latched CRIT would page forever for a
    # long-resolved event). --window N scrapes again after N seconds and
    # diffs — activity inside the window is current and may CRIT, same
    # semantics as the shipped increase[10m] alert rules.
    window = getattr(args, "window", 0.0) or 0.0
    if metrics and window > 0:
        time.sleep(window)
        try:
            later = _parse_exposition(
                _fetch_text(args.master, "/metrics", args.timeout))
            metrics_delta = {
                fam: {labels: value - metrics.get(fam, {}).get(labels, 0.0)
                      for labels, value in series.items()}
                for fam, series in later.items()}
            # A lower second sample in a COUNTER family means the counter
            # reset — the process restarted between scrapes. The deltas
            # are then meaningless (negative counts would print, and a
            # negative-but-truthy exceptions delta would page CRIT for a
            # mere restart): fall back to lifetime/WARN semantics and say
            # why. Gauges (GPU counts, warm-pool size) go down in normal
            # operation and must not trip this.
            if any(v < 0 for fam, series in metrics_delta.items()
                   if fam.endswith(("_total", "_count", "_bucket", "_sum"))
                   for v in series.values()):
                check("warn",
                      f"counter reset inside the {window:g}s window "
                      "(target restarted?) — judging lifetime totals "
                      "instead")
                window, metrics_delta = 0.0, None
        except TransportError as e:
            check("warn", f"second /metrics scrape failed: {e}")
            window, metrics_delta = 0.0, None
    else:
        metrics_delta = None

    if metrics:
        # build identity straight from the scraped registry, so "which
        # version is this master/worker actually running" never needs a
        # kubectl describe
        versions = sorted({dict(labels).get("version", "")
                           for labels in
                           metrics.get("tpumounter_build_info", {})} - {""})
        if versions:
            check("ok", f"target version {', '.join(versions)} "
                        "(tpumounter_build_info)")
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime (use --window N for a current-activity "
                      "check)")
        # worker-local label (present when pointed at a worker's :1201 or
        # an in-process stack) + the failures the master itself records
        exceptions = (_counter_total(src, "tpumounter_attach_total",
                                     result="EXCEPTION")
                      + _counter_total(src, "tpumounter_detach_total",
                                       result="EXCEPTION"))
        slice_errors = (_counter_total(src, "tpumounter_attach_total",
                                       result="slice_ERROR")
                        + _counter_total(src, "tpumounter_detach_total",
                                         result="slice_ERROR"))
        bad = exceptions or slice_errors
        check(("crit" if metrics_delta is not None else "warn") if bad
              else "ok",
              f"exceptions: {int(exceptions)} worker-local, "
              f"{int(slice_errors)} slice transaction — {scope}")
        rollbacks = _counter_total(
            src, "tpumounter_attach_phase_seconds_count", phase="rollback")
        check("warn" if rollbacks else "ok",
              f"attach rollbacks: {int(rollbacks)} — {scope}")
        orphans = _counter_total(src, "tpumounter_orphans_reclaimed_total")
        # worker-local family (the reconciler runs per node); fresh reclaims
        # inside a window mean workloads are dying mid-hold right now
        check("warn" if (metrics_delta is not None and orphans) else "ok",
              f"orphaned slave pods reclaimed: {int(orphans)} worker-local "
              f"— {scope}")
        # Windowed mode diffs the _bucket/_count series like the counter
        # checks above (a histogram delta is itself a valid histogram), so
        # the p95 judges CURRENT latency; lifetime mode says so in the
        # message instead of presenting an all-time figure as current.
        attaches = _counter_total(src, "tpumounter_attach_seconds_count")
        master_attaches = sum(
            value for labels, value in
            metrics.get("tpumounter_attach_total", {}).items()
            if dict(labels).get("result", "").startswith("master_"))
        if attaches:
            p95 = _histogram_quantile(src, "tpumounter_attach_seconds",
                                      0.95)
            if p95 is None:
                check("warn", f"{int(attaches)} attach(es) recorded but "
                              "the latency histogram is unreadable")
            else:
                slow = p95 > 3.0
                check("warn" if slow else "ok",
                      f"attach p95 ~{p95:.2f}s over {int(attaches)} "
                      f"attach(es) (baseline < 3s) — {scope}"
                      f"{' — inspect the phase panel' if slow else ''}")
        elif master_attaches:
            check("ok",
                  f"{int(master_attaches)} attach(es) routed by this "
                  "master; latency histograms live on each worker's :1201 "
                  "(point --master there to audit a node)")
        else:
            check("ok", f"no attaches recorded — {scope}")

    if metrics:
        # Resilience layer: circuit breakers are CURRENT state (a gauge),
        # so an open circuit may page — it means a worker is failing fast
        # right now. Retry volume is cumulative: windowed deltas judge
        # current flakiness, lifetime totals only inform.
        circuits = metrics.get("tpumounter_circuit_state", {})
        open_targets = sorted(dict(labels).get("target", "?")
                              for labels, value in circuits.items()
                              if value >= 2)
        half_open = sorted(dict(labels).get("target", "?")
                           for labels, value in circuits.items()
                           if value == 1)
        if open_targets:
            check("crit", f"circuit OPEN for {', '.join(open_targets)} — "
                          "those workers are failing fast (429s)")
        elif half_open:
            check("warn", f"circuit half-open (probing) for "
                          f"{', '.join(half_open)}")
        elif circuits:
            check("ok", f"all {len(circuits)} circuit(s) closed")
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        retries = _counter_total(src, "tpumounter_retry_attempts_total")
        check("warn" if (metrics_delta is not None and retries) else "ok",
              f"transient-fault retries absorbed: {int(retries)} — {scope}")
        replay_failures = _counter_total(
            src, "tpumounter_journal_replays_total", outcome="failed")
        replays = _counter_total(src, "tpumounter_journal_replays_total")
        if replay_failures:
            check("warn", f"journal replays unresolved: "
                          f"{int(replay_failures)} of {int(replays)} — "
                          f"{scope}")
        elif replays:
            check("ok", f"journal replays (crash recoveries): "
                        f"{int(replays)}, all resolved — {scope}")

    # Attach broker: queue pressure and quota pressure are CURRENT state.
    # The live /brokerz snapshot is authoritative for the target master
    # (the gauge families are process-global, so an in-process test stack
    # can hold several brokers' stale exports); targets without /brokerz
    # fall back to the queue_depth / tenant_*_chips gauge families. Lease
    # expirations / preemptions are counters judged like the others —
    # windowed deltas describe current reclaim activity.
    try:
        brokerz = json.loads(_fetch_text(args.master, "/brokerz",
                                         args.timeout))
    except (TransportError, ValueError):
        brokerz = None
    if isinstance(brokerz, dict) and "queue" in brokerz:
        depth = {p: int(n)
                 for p, n in (brokerz["queue"].get("depth") or {}).items()}
        total_depth = sum(depth.values())
        oldest = float(brokerz["queue"].get("oldest_age_s") or 0.0)
        hot = [f"{tenant} ({int(t['in_use'])}/{int(t['quota'])} GPUs)"
               for tenant, t in (brokerz.get("tenants") or {}).items()
               if t.get("quota") and (t.get("pct_of_quota") or 0) >= 90]
        quota_count = sum(1 for t in (brokerz.get("tenants")
                                      or {}).values() if t.get("quota"))
    elif metrics:
        depth_series = metrics.get("tpumounter_queue_depth", {})
        depth = {dict(labels).get("priority", "?"): int(value)
                 for labels, value in depth_series.items()}
        total_depth = sum(depth.values()) if depth_series else None
        oldest = max(metrics.get("tpumounter_queue_oldest_age",
                                 {}).values(), default=0.0)
        quota_series = metrics.get("tpumounter_tenant_quota_chips", {})
        usage_series = metrics.get("tpumounter_tenant_chips_in_use", {})
        hot = []
        for labels, quota in quota_series.items():
            if quota <= 0:
                continue
            used = usage_series.get(labels, 0.0)
            if used / quota >= 0.9:
                tenant = dict(labels).get("tenant", "?")
                hot.append(f"{tenant} ({int(used)}/{int(quota)} GPUs)")
        quota_count = len(quota_series)
    else:
        total_depth = None
        hot, quota_count, oldest = [], 0, 0.0
    if total_depth is not None:
        if total_depth:
            by_prio = ", ".join(f"{priority}:{n}"
                                for priority, n in sorted(depth.items())
                                if n)
            check("warn",
                  f"attach queue: {total_depth} request(s) waiting "
                  f"({by_prio}), oldest {oldest:.1f}s — GPUs are "
                  "contended")
        else:
            check("ok", "attach queue empty")
    if hot:
        check("warn", f"tenant(s) at >90% quota: {', '.join(sorted(hot))}"
                      " — next attach may 429 or preempt")
    elif quota_count:
        check("ok", f"all {quota_count} quota'd tenant(s) under 90%")
    if metrics:
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        expirations = _counter_total(
            src, "tpumounter_lease_expirations_total")
        preemptions = _counter_total(src, "tpumounter_preemptions_total")
        if expirations or preemptions:
            check("ok",
                  f"broker reclaims: {int(expirations)} expired "
                  f"lease(s) auto-detached, {int(preemptions)} "
                  f"preemption(s) — {scope}")

    # Idle leased GPUs (the utilization plane): CURRENT state — a lease
    # the broker marked idle holds GPUs nobody is computing on, counted
    # against its tenant's quota; WARN with the leases so the operator
    # can renew-or-release. Windowed mode additionally judges fresh
    # idle_lease transitions (the events counter), so `--window N` says
    # whether leases are going idle RIGHT NOW, not just that some are.
    idle_leases = []
    if isinstance(brokerz, dict) and "leases" in brokerz:
        idle_leases = [
            f"{lease['namespace']}/{lease['pod']} "
            f"({lease.get('tenant')}, {lease.get('chips')} GPU(s), "
            f"idle {lease.get('idle_s')}s)"
            for lease in (brokerz.get("leases") or {}).get("leases", [])
            if lease.get("idle")]
    idle_gauge = sum(
        metrics.get("tpumounter_tenant_chips_idle", {}).values()) \
        if metrics else 0.0
    if metrics:
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        fresh_idle = _counter_total(src, "tpumounter_events_total",
                                    kind="idle_lease")
    else:
        fresh_idle = 0.0
    if idle_leases or idle_gauge:
        detail = (", ".join(sorted(idle_leases)) if idle_leases
                  else f"{int(idle_gauge)} GPU(s) "
                       "(tpumounter_tenant_chips_idle)")
        windowed = (f"; {int(fresh_idle)} went idle {scope}"
                    if metrics_delta is not None and fresh_idle else "")
        check("warn",
              f"idle leased GPUs: {detail}{windowed} — held against "
              "quota with zero observed duty; renew-or-release, or let "
              "idle-aware preemption reclaim them")
    elif metrics and metrics.get("tpumounter_tenant_chips_idle"):
        check("ok", "no leased GPUs idle past TPU_IDLE_LEASE_S")

    # Fleet topology plane: fragmentation and stranded GPUs are CURRENT
    # state (gauges recomputed every fleet tick). Both WARN — they cost
    # capacity, not correctness; the paired alert rules
    # (TPUMounterFleetFragmented / TPUMounterStrandedChips) add the
    # sustained-duration judgment a one-shot doctor cannot.
    if metrics and metrics.get("tpumounter_fleet_fragmentation_score"):
        from gpumounter_tpu_torch.master.topology import FRAG_WARN_THRESHOLD
        frag = max(metrics["tpumounter_fleet_fragmentation_score"]
                   .values(), default=0.0)
        stranded_chips = sum(
            metrics.get("tpumounter_stranded_chips", {}).values())
        if frag > FRAG_WARN_THRESHOLD:
            check("warn",
                  f"fleet fragmented: score {frag:.2f} (> "
                  f"{FRAG_WARN_THRESHOLD:g}) — free capacity is "
                  "shattered; `gpumounterctl topo` for the defrag "
                  "candidates")
        elif stranded_chips:
            pass    # the stranded check below carries the WARN
        else:
            check("ok", f"fleet fragmentation score {frag:.2f} "
                        f"(threshold {FRAG_WARN_THRESHOLD:g})")
        if stranded_chips:
            check("warn",
                  f"{int(stranded_chips)} stranded GPU(s): free "
                  "capacity in fragments no topology-aligned "
                  "grant can use — `gpumounterctl topo` maps them")

    # Fleet defragmenter: moves are designed to be RARE (hysteresis,
    # idle-only, sliding budget). More than one live migration inside
    # one doctor window is a migration storm — exactly the churn the
    # interlocks exist to prevent — and a budget_exhausted transition
    # means the actuator halted itself mid-consolidation. Both WARN:
    # the defragmenter defers rather than degrades, so this costs
    # compaction, never correctness.
    if metrics and metrics.get("tpumounter_defrag_moves_total"):
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        migrated = _counter_total(src, "tpumounter_defrag_moves_total",
                                  outcome="migrated")
        exhausted = _counter_total(src, "tpumounter_defrag_moves_total",
                                   outcome="budget_exhausted")
        storm = metrics_delta is not None and migrated > 1
        if storm:
            check("warn",
                  f"defrag migration storm: {int(migrated)} live "
                  f"migration(s) {scope} — moves should be rare "
                  "(hysteresis + sliding budget); check the "
                  "TPU_DEFRAG_* knobs and `gpumounterctl defrag`")
        if exhausted:
            check("warn",
                  f"defrag budget exhausted {int(exhausted)}x {scope} "
                  "— the actuator halted itself; the fleet stays "
                  "fragmented until the window slides "
                  "(`gpumounterctl defrag` for the standing plans)")
        elif migrated and not storm:
            check("ok", f"defrag: {int(migrated)} migration(s) {scope},"
                        " budget never exhausted")

    # Elastic slice subsystem: a STRANDED slice transaction (intent
    # record older than its deadline that nothing is driving) is a
    # half-attached slice nobody will resolve — GPUs held on some hosts
    # with no lease, no client, no adopter. That is the one state the
    # crash-safe protocol exists to prevent, so it pages CRIT.
    try:
        slicez = json.loads(_fetch_text(args.master, "/slicez",
                                        args.timeout))
    except (TransportError, ValueError):
        slicez = None
    if isinstance(slicez, dict) and "txns" in slicez:
        txns = slicez.get("txns") or {}
        stranded = int(txns.get("stranded") or 0)
        pending = int(txns.get("pending") or 0)
        groups = slicez.get("groups") or {}
        gangs = int(slicez.get("gang_queue_depth") or 0)
        if stranded:
            check("crit",
                  f"{stranded} STRANDED slice txn(s) past their "
                  "deadline with no resolver — half-attached slices; "
                  "`gpumounterctl slice status` for the records")
        elif pending or groups or gangs:
            check("ok",
                  f"slices: {len(groups)} group(s) live, {pending} "
                  f"txn(s) in flight, {gangs} gang(s) queued, 0 "
                  "stranded")
        # A re-federation barrier incomplete past
        # TPU_RESIZE_BARRIER_TIMEOUT_S: some member never re-federated
        # after a resize — killed mid-transition, or its process wedged.
        # Survivors are parked (they cannot restore without the full
        # world); resolution is a new generation without the missing
        # member (resize or slice self-healing). WARN, not CRIT: the
        # protocol is holding — that is the barrier doing its job.
        for group, info in sorted(groups.items()):
            barrier = (info or {}).get("barrier") or {}
            if barrier.get("stuck"):
                missing = ", ".join(barrier.get("missing") or [])
                check("warn",
                      f"slice group {group}: re-federation barrier for "
                      f"generation {barrier.get('generation')} stuck "
                      f"at {len(barrier.get('joined') or [])}/"
                      f"{barrier.get('expected')} for "
                      f"{barrier.get('age_s')}s — waiting on: "
                      f"{missing}; resize (or let slice self-healing) "
                      "move the generation past the missing member")

    # SLO burn rates (utils/slo.py, ticked by the master's fleet loop):
    # CURRENT state — a fast 5m burn means a tenant is eating its error
    # budget ~14x the sustainable rate RIGHT NOW and pages CRIT; a slow
    # 1h burn tickets WARN. The top-burning tenant is reported either
    # way. Thresholds come from the engine itself, so doctor pages at
    # exactly the bound the control plane acts on.
    if metrics:
        from gpumounter_tpu_torch.utils.slo import FAST_BURN, SLOW_BURN
        burns = metrics.get("tpumounter_slo_burn_rate", {})
        fast, slow = [], []
        top = None
        for labels, burn in burns.items():
            d = dict(labels)
            tenant, slo = d.get("tenant", "?"), d.get("slo", "?")
            if d.get("window") == "5m":
                if top is None or burn > top[2]:
                    top = (tenant, slo, burn)
                if burn >= FAST_BURN:
                    fast.append(f"{tenant}/{slo} ({burn:g}x)")
            elif d.get("window") == "1h" and burn >= SLOW_BURN:
                slow.append(f"{tenant}/{slo} ({burn:g}x)")
        if fast:
            check("crit", f"FAST SLO burn (5m >= {FAST_BURN:g}x): "
                          f"{', '.join(sorted(fast))} — the error budget "
                          "is being consumed at page rate")
        elif slow:
            check("warn", f"slow SLO burn (1h >= {SLOW_BURN:g}x): "
                          f"{', '.join(sorted(slow))}")
        elif top is not None:
            check("ok", f"SLO burn nominal; top: tenant {top[0]} "
                        f"slo {top[1]} at {top[2]:g}x (5m)")

    # Flight recorder: a dump inside the window means an anomaly trigger
    # fired RIGHT NOW (fast burn / fallback burst / journal backlog /
    # open circuit) and there is a fresh bundle to read.
    if metrics:
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        dumps = _counter_total(src, "tpumounter_flight_dumps_total")
        if dumps:
            check("warn" if metrics_delta is not None else "ok",
                  f"flight-recorder bundles: {int(dumps)} — {scope} — "
                  "`gpumounterctl flight list` to inspect")

    # Fleet staleness (master-side /fleetz; workers answer 404 → skipped):
    # a node unscraped for >= 2 ticks means the master is flying blind on
    # it — its health/journal/event numbers are frozen.
    try:
        fleetz = json.loads(_fetch_text(args.master, "/fleetz",
                                        args.timeout))
    except (TransportError, ValueError):
        fleetz = None
    if isinstance(fleetz, dict) and "nodes" in fleetz:
        nodes = fleetz.get("nodes") or {}
        warn_ticks = int(fleetz.get("stale_ticks_warn") or 2)
        stale = sorted(
            node for node, n in nodes.items()
            if n.get("state") != "fresh"
            and int(n.get("missed_ticks") or 0) >= warn_ticks)
        if not nodes:
            check("ok", "fleet: no workers discovered yet")
        elif stale:
            check("warn",
                  f"fleet: {len(stale)}/{len(nodes)} worker(s) stale "
                  f"(unscraped >= {warn_ticks} ticks): "
                  f"{', '.join(stale)} — their numbers are frozen")
        else:
            lagging = sorted(node for node, n in nodes.items()
                             if n.get("state") != "fresh")
            if lagging:
                check("ok",
                      f"fleet: {len(lagging)}/{len(nodes)} worker(s) "
                      f"missed their last scrape (< {warn_ticks} ticks, "
                      f"not yet a concern): {', '.join(lagging)}")
            else:
                check("ok", f"fleet: all {len(nodes)} worker(s) fresh")
        top = (fleetz.get("slo") or {}).get("top_burn")
        if top and not metrics.get("tpumounter_slo_burn_rate"):
            check("ok", f"top burn tenant (fleetz): {top.get('tenant')} "
                        f"slo {top.get('slo')} at {top.get('burn')}x")

    # Node failure domain (master/nodehealth.py): a DEAD node still
    # holding leases is the one state fencing exists to eliminate —
    # stranded GPUs counted against quota with no worker to detach
    # them — and pages CRIT. Prolonged suspect WARNs (the node is
    # cordoned; if it is really dead the dead window should have
    # fired); draining nodes are reported as routine.
    health = (fleetz or {}).get("node_health")
    if isinstance(health, dict):
        node_states = health.get("nodes") or {}
        leases_on = {}
        for lease in ((brokerz or {}).get("leases") or {}).get(
                "leases") or []:
            node = lease.get("node") or ""
            leases_on[node] = leases_on.get(node, 0) + 1
        dead_with_leases = sorted(
            node for node, entry in node_states.items()
            if entry.get("state") == "dead" and leases_on.get(node))
        dead = sorted(node for node, entry in node_states.items()
                      if entry.get("state") == "dead")
        suspects = sorted(
            node for node, entry in node_states.items()
            if entry.get("state") == "suspect"
            and time.time() - float(entry.get("since_unix") or 0) > 120)
        draining = sorted(node for node, entry in node_states.items()
                          if entry.get("state") == "draining")
        if dead_with_leases:
            check("crit",
                  f"DEAD node(s) still holding leases: "
                  f"{', '.join(dead_with_leases)} — fencing is stuck; "
                  "those GPUs and their quota are stranded "
                  "(`gpumounterctl nodes` for the leases)")
        elif dead:
            check("warn", f"dead node(s) (leases fenced): "
                          f"{', '.join(dead)}")
        if suspects:
            check("warn",
                  f"node(s) suspect > 120s: {', '.join(suspects)} — "
                  "cordoned from new grants; if really dead the "
                  "dead-tick window should fire, if flapping check "
                  "the health port")
        if draining:
            check("ok", f"node(s) draining (graceful): "
                        f"{', '.join(draining)}")
        if node_states and not (dead or suspects or draining):
            check("ok", f"node health: all {len(node_states)} node(s) "
                        "healthy")
        fenced = (brokerz or {}).get("fenced") or []
        if fenced and metrics:
            src = metrics_delta if metrics_delta is not None else metrics
            scope = (f"in the last {window:g}s"
                     if metrics_delta is not None else "lifetime")
            fresh = _counter_total(src, "tpumounter_lease_fences_total")
            check("warn" if (metrics_delta is not None and fresh)
                  else "ok",
                  f"lease fences: {len(fenced)} recent, "
                  f"{int(fresh)} — {scope}")

    # HA posture (docs/guide/HA.md): a shard with no live leader means
    # admission for its keyspace is DOWN right now — every request 503s
    # until a replica takes it over — and pages CRIT. Leadership
    # transitions are counters: windowed deltas above the flap threshold
    # WARN (a failover is 1 acquire; churn past FLAP_WARN means the lock
    # is bouncing — renew interval too tight, apiserver struggling, or
    # two replicas fighting); lifetime totals only inform.
    masters = (fleetz or {}).get("masters") or {}
    if masters.get("enabled"):
        election_view = masters.get("election") or {}
        shards = election_view.get("shards") or {}
        if election_view.get("enabled"):
            leaderless = sorted(
                shard for shard, s in shards.items()
                if not s.get("leader")
                and (not s.get("holder")
                     or float(s.get("expires_in_s") or 0.0) <= 0))
            if leaderless:
                check("crit",
                      f"shard(s) {', '.join(leaderless)} have NO live "
                      "leader — admission for their keyspace is down "
                      "until a replica takes over (watch "
                      "tpumounter_election_is_leader)")
            else:
                led = sum(1 for s in shards.values() if s.get("leader"))
                check("ok", f"HA: replica {masters.get('replica')} leads "
                            f"{led}/{len(shards)} shard(s), every shard "
                            "has a live leader")
        store_view = masters.get("store") or {}
        lag = float(store_view.get("lag_s") or 0.0)
        if lag > 0:
            check("warn",
                  f"intent store lagging {lag:g}s "
                  f"({store_view.get('dirty', 0)} dirty mutation(s) "
                  "parked) — a failover NOW would rehydrate stale "
                  "records")
        if store_view.get("torn_records"):
            check("warn",
                  f"{store_view['torn_records']} torn store record(s) "
                  "dropped at rehydration (crash mid-write) — those "
                  "leases degraded to slave-pod re-derivation")
    if metrics:
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        # judged PER SHARD (like the shipped sum-by-shard alert rule): a
        # clean multi-shard failover is one acquire on EACH shard and
        # must not read as flapping in aggregate
        per_shard: dict[str, float] = {}
        for labels, value in src.get(
                "tpumounter_election_transitions_total", {}).items():
            shard = dict(labels).get("shard", "?")
            per_shard[shard] = per_shard.get(shard, 0.0) + value
        transitions = sum(per_shard.values())
        flapping = sorted(shard for shard, n in per_shard.items()
                          if n > FLAP_WARN)
        if metrics_delta is not None and flapping:
            check("warn",
                  f"leadership flapping on shard(s) "
                  f"{', '.join(flapping)} (> {FLAP_WARN} transitions "
                  f"{scope}) — ownership is bouncing between replicas; "
                  "check TPU_ELECTION_RENEW_S vs apiserver latency")
        elif transitions:
            check("ok", f"leadership transitions: {int(transitions)} — "
                        f"{scope}")

    # Resident actuation agent: fallback RATE is the health signal — a
    # windowed non-zero delta means attaches are degrading to the
    # fallback actuator RIGHT NOW (stale ns fds beyond repair, executor
    # faults) and pages WARN; lifetime totals only inform, like every
    # other counter. Stale revalidations alone are normal operation
    # (container restarts), reported at ok level.
    if metrics:
        src = metrics_delta if metrics_delta is not None else metrics
        scope = (f"in the last {window:g}s" if metrics_delta is not None
                 else "lifetime")
        agent_batches = _counter_total(
            metrics, "tpumounter_actuation_agent_batches_total")
        if agent_batches:
            fallbacks = _counter_total(
                src, "tpumounter_actuation_agent_fallbacks_total")
            stale = _counter_total(
                src, "tpumounter_actuation_agent_revalidations_total",
                outcome="stale")
            if fallbacks > 0:
                check("warn",
                      f"actuation agent fallbacks: {int(fallbacks)} — "
                      f"{scope} — the fork-free warm path is degrading; "
                      "inspect /agentz")
            else:
                check("ok",
                      f"actuation agent healthy: "
                      f"{int(agent_batches)} batch(es) lifetime, "
                      f"0 fallbacks {scope}"
                      + (f", {int(stale)} stale-fd revalidation(s)"
                         if stale else ""))

    # Attach-journal backlog: worker-local /journalz (present when doctor
    # is pointed at a worker's :1201; the master answers 404 → skipped).
    # Backlog on a LIVE worker means a replay was deferred (e.g. devices
    # busy) — incomplete actuation state is sitting on the node.
    try:
        journalz = json.loads(_fetch_text(args.master, "/journalz",
                                          args.timeout))
    except (TransportError, ValueError):
        journalz = None
    if isinstance(journalz, dict) and "backlog" in journalz:
        backlog = journalz.get("backlog", 0)
        check("warn" if backlog else "ok",
              f"attach-journal backlog: {backlog} incomplete record(s)"
              + (" — inspect /journalz" if backlog else ""))

    # Kernel device gate: worker-local /gatez (the master answers 404 →
    # skipped). Drift is CRIT — a gate entry granting GPUs with no live
    # owner attachment means revocation raced a crash and a workload may
    # have held access past its lease (the audit reclaimed it, but the
    # window existed). A WINDOWED denial rate WARNs: denials right now
    # mean an evicted holder is hammering a device it lost.
    try:
        gatez = json.loads(_fetch_text(args.master, "/gatez",
                                       args.timeout))
    except (TransportError, ValueError):
        gatez = None
    if isinstance(gatez, dict) and "enabled" in gatez \
            and ("backend" in gatez or not gatez.get("enabled")):
        if not gatez.get("enabled"):
            check("ok", "device gate disabled (legacy cgroup "
                        "enforcement; no kernel policy maps)")
        else:
            drift = (gatez.get("drift") or {}).get("count", 0)
            denial_total = (gatez.get("denials") or {}).get("total", 0)
            faults = (gatez.get("counts") or {}).get("faults", 0)
            if drift:
                check("crit",
                      f"device gate drift: {drift} entr(ies) granted "
                      "GPUs with no live owner attachment — inspect "
                      "/gatez")
            src = metrics_delta if metrics_delta is not None else metrics
            scope = (f"in the last {window:g}s"
                     if metrics_delta is not None else "lifetime")
            denial_rate = _counter_total(
                src, "tpumounter_device_denials_total")
            if metrics_delta is not None and denial_rate > 0:
                check("warn",
                      f"device denials: {int(denial_rate)} {scope} — a "
                      "workload is retrying access the gate revoked; "
                      "`gpumounterctl gatez` for reasons")
            elif not drift:
                check("ok",
                      f"device gate healthy: backend "
                      f"{gatez.get('backend')}, "
                      f"{len(gatez.get('entries') or [])} gated "
                      f"container(s), {denial_total} denial(s) lifetime"
                      + (f", {int(faults)} fault(s) degraded to legacy"
                         if faults else ""))

    # Shared-informer cache health: worker-local /cachez (the master
    # answers 404 → skipped). Staleness is CURRENT state and may WARN: a
    # stale cache means the attach path is coasting on old pod data and
    # every fenced read is falling through to the apiserver.
    try:
        cachez = json.loads(_fetch_text(args.master, "/cachez",
                                        args.timeout))
    except (TransportError, ValueError):
        cachez = None
    if isinstance(cachez, dict) and "scopes" in cachez:
        if not cachez.get("enabled"):
            check("ok", "informer disabled (reads go straight to the "
                        "apiserver)")
        else:
            worst_staleness = 0.0
            restarts = 0
            broken = []
            for scope in cachez.get("scopes", []):
                worst_staleness = max(worst_staleness,
                                      float(scope.get("staleness_s") or 0))
                restarts += int(scope.get("watch_restarts") or 0)
                if not scope.get("seeded") or not scope.get("running"):
                    broken.append(f"{scope.get('namespace')}/"
                                  f"{scope.get('selector') or '*'}")
            ratio = cachez.get("hit_ratio")
            ratio_str = (f", hit ratio {ratio}" if ratio is not None
                         else "")
            if broken:
                check("warn", f"informer scope(s) down: "
                              f"{', '.join(broken)} — reads are falling "
                              "through to the apiserver")
            elif worst_staleness > CACHE_STALENESS_WARN_S:
                check("warn",
                      f"informer cache stale: {worst_staleness:.0f}s since "
                      f"the watch stream last proved liveness (> "
                      f"{CACHE_STALENESS_WARN_S:g}s) — inspect /cachez")
            else:
                check("ok",
                      f"informer cache fresh ({worst_staleness:.1f}s), "
                      f"{restarts} watch restart(s){ratio_str}")

    # Slowest stored trace: WHICH hop ate the worst request's seconds —
    # the one question the histograms can't answer. Informational (ok
    # level): the store is lifetime-scoped like the counters, and doctor's
    # contract is that only current activity pages.
    try:
        tracez = json.loads(_fetch_text(args.master, "/tracez?limit=1",
                                        args.timeout))
        slowest = (tracez.get("slowest") or [None])[0]
    except (TransportError, ValueError, AttributeError):
        slowest = None          # pre-/tracez target or non-JSON answer
    if isinstance(slowest, dict):
        dominant = max((slowest.get("spans") or {}).get("children") or [],
                       key=lambda s: s.get("duration_ms") or 0.0,
                       default=None)
        detail = (f", dominant span {dominant.get('name')} "
                  f"{float(dominant.get('duration_ms') or 0):.0f}ms"
                  if dominant else "")
        check("ok",
              f"slowest stored trace: op={slowest.get('op')} "
              f"rid={slowest.get('rid')} "
              f"{float(slowest.get('total_ms') or 0) / 1e3:.2f}s{detail} "
              f"— `gpumounterctl trace {slowest.get('rid')}` for the tree")

    if getattr(args, "node", None):
        try:
            _, payload = _request(
                args.master, "GET",
                f"/nodestatus/node/{urllib.parse.quote(args.node)}",
                timeout=args.timeout)
        except TransportError as e:
            check("crit", f"node {args.node}: inventory unreadable: {e}")
            return finish()
        if "free" in payload:
            free, total = payload.get("free"), payload.get("total")
            check("warn" if not free else "ok",
                  f"node {args.node}: {free}/{total} GPUs free")
        else:
            check("crit", f"node {args.node}: {payload.get('result')}: "
                          f"{payload.get('message', '')}")

    return finish()


def _add_common(p: argparse.ArgumentParser, suppress: bool) -> None:
    """--master/--json/--timeout work both before AND after the subcommand
    (operators type `gpumounterctl health --master ...`). Subparsers get
    SUPPRESS defaults so they don't clobber a value parsed at the top level;
    real defaults live on the top parser."""
    sup = argparse.SUPPRESS
    p.add_argument(
        "--master",
        default=sup if suppress else os.environ.get("TPU_MOUNTER_MASTER",
                                                    DEFAULT_MASTER),
        help="master base URL (env TPU_MOUNTER_MASTER)")
    p.add_argument("--json", action="store_true",
                   default=sup if suppress else False,
                   help="print the raw JSON payload")
    p.add_argument("--timeout", type=float,
                   default=sup if suppress else 120.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gpumounterctl",
        description="hot-attach/detach NVIDIA GPUs on running pods")
    import gpumounter_tpu_torch
    parser.add_argument(
        "--version", action="version",
        version=f"gpumounterctl {gpumounter_tpu_torch.__version__}")
    _add_common(parser, suppress=False)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("add", help="attach GPUs to a running pod")
    p.add_argument("pod")
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--gpus", type=int, default=1)
    p.add_argument("--entire", action="store_true",
                   help="one slave pod holding all the GPUs")
    p.add_argument("--request-id", default="",
                   help="idempotency key (default: generated)")
    p.add_argument("--retries", type=int, default=2,
                   help="transient-failure retries, same request id")
    p.set_defaults(fn=cmd_add)
    _add_common(p, suppress=True)

    p = sub.add_parser("remove", help="detach GPUs from a pod")
    p.add_argument("pod")
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--uuids", default="",
                   help="comma-separated GPU UUIDs (default: all "
                        "removable)")
    p.add_argument("--force", action="store_true",
                   help="kill holder processes if busy")
    p.set_defaults(fn=cmd_remove)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "renew",
        help="extend a pod's attachment lease (broker auto-detaches "
             "expired leases)")
    p.add_argument("pod")
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--ttl", type=float, default=None, metavar="SECONDS",
                   help="new time-to-expiry (default: the master's "
                        "configured TPU_LEASE_TTL_S)")
    p.set_defaults(fn=cmd_renew)
    _add_common(p, suppress=True)

    p = sub.add_parser("status", help="GPUs + busy PIDs of a pod")
    p.add_argument("pod")
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_status)
    _add_common(p, suppress=True)

    p = sub.add_parser("node", help="node-wide GPU inventory (free/used)")
    p.add_argument("node")
    p.set_defaults(fn=cmd_node)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "slice",
        help="multi-host slice transactions: add/remove a slice, "
             "resize a live one (elastic mesh reshaping), or show "
             "groups + in-flight txns (/slicez)")
    p.add_argument("slice_action",
                   choices=["add", "remove", "resize", "status"])
    p.add_argument("-p", "--pod", action="append", default=[],
                   metavar="NS/POD",
                   help="repeatable: one entry per host (for resize: "
                        "the full TARGET membership)")
    p.add_argument("--gpus-per-host", type=int, default=None,
                   help="GPUs per host (add default: 4; resize "
                        "default: the group's recorded size)")
    p.add_argument("--group", default="",
                   help="slice group id for resize (default: derived "
                        "from the target pods' leases)")
    p.add_argument("--strict", action="store_true",
                   help="accepted for the control plane's scripts; a "
                        "GPU node has no multi-host mesh, so it adds "
                        "nothing")
    p.add_argument("--force", action="store_true")
    p.add_argument("--request-id", default="")
    p.add_argument("--retries", type=int, default=2)
    p.set_defaults(fn=cmd_slice)
    _add_common(p, suppress=True)

    p = sub.add_parser("health", help="master liveness")
    p.set_defaults(fn=cmd_health)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "fleet",
        help="cluster view from the master's fleet aggregator (/fleetz): "
             "per-node scrape health, tenant usage, SLO burn, event tail")
    p.add_argument("--events", type=int, default=10,
                   help="merged lifecycle events to show (default 10)")
    p.set_defaults(fn=cmd_fleet)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "nodes",
        help="node failure-domain view: per-node health state "
             "(healthy/draining/suspect/dead), leases anchored to each "
             "node, recent fences (non-zero exit on dead-with-leases)")
    p.set_defaults(fn=cmd_nodes)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "flight",
        help="inspect flight-recorder anomaly bundles (TPU_FLIGHT_DIR)")
    p.add_argument("flight_action", choices=["list", "show"])
    p.add_argument("bundle_id", nargs="?", default="",
                   help="bundle id for `show` (from `flight list`)")
    p.add_argument("--dir", default="",
                   help="bundle directory (default: $TPU_FLIGHT_DIR)")
    p.set_defaults(fn=cmd_flight)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "cachez",
        help="shared-informer cache health from a worker's health port "
             "(staleness, watch restarts, hit ratio)")
    p.set_defaults(fn=cmd_cachez)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "agentz",
        help="resident actuation agent health from a worker's health "
             "port (cached ns fds, revalidations, fallbacks)")
    p.set_defaults(fn=cmd_agentz)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "utilz",
        help="GPU utilization from a worker's health port: per-GPU "
             "duty cycle and its source (nvml / open-fd), per-lease "
             "attribution, idle flags, device-open accounting (non-zero "
             "exit on unattributed busy GPUs)")
    p.set_defaults(fn=cmd_utilz)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "topo",
        help="fleet topology from the master's /topoz: per-node "
             "accelerator, GPU-occupancy row and GPU UUIDs, "
             "fragmentation score, slice contiguity and the defrag "
             "candidate report (non-zero exit on stranded GPUs)")
    p.set_defaults(fn=cmd_topo)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "defrag",
        help="fleet defragmenter state from the master's /fleetz: "
             "mode (plan/act), standing gain-sorted plans, recent move "
             "outcomes, in-flight count and the sliding move budget "
             "(non-zero exit when the budget is exhausted)")
    p.set_defaults(fn=cmd_defrag)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "gatez",
        help="kernel device gate from a worker's health port: backend, "
             "gated containers, deny ring with revocation reasons, "
             "gate/lease drift (non-zero exit on denials or drift)")
    p.set_defaults(fn=cmd_gatez)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "trace",
        help="ASCII waterfall of one request's stitched span tree "
             "(master + worker) from /tracez")
    p.add_argument("request_id",
                   help="the X-Request-Id / request_id of the request")
    p.set_defaults(fn=cmd_trace)
    _add_common(p, suppress=True)

    p = sub.add_parser(
        "doctor",
        help="one-shot diagnosis: liveness, errors, latency, rollbacks")
    p.add_argument("--node", default=None,
                   help="also check this node's GPU inventory")
    p.add_argument("--window", type=float, default=0.0, metavar="SECONDS",
                   help="scrape twice this many seconds apart and judge "
                        "only activity inside the window (counters are "
                        "lifetime totals otherwise, which can only WARN)")
    p.set_defaults(fn=cmd_doctor)
    _add_common(p, suppress=True)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except TransportError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_TRANSPORT


if __name__ == "__main__":
    sys.exit(main())
