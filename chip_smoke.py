#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpumounter_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line on stdout:
  1. environment — card name and power limit (nvidia-smi), device count,
     the card's published rates (perf.GPU_PEAKS; an unknown card fails
     here), and the kernel build (nvcc from the checkout's sources) with
     each kernel's registers, stack and spill bytes from ptxas (a wgmma
     kernel that spills fails here);
  2. parity — every kernel against its plain PyTorch version on the card:
     f32 at b1 h2 d64 (both forward contracts, ring offsets, a fully masked
     block merged away, a float64 oracle, T=768 and T=1536 through the
     trainable attention, whose T=1536 forward takes the K-blocked
     contract), then bf16 at the shapes the flagship and long-context
     steps give the kernels (the forward and the backward pair at each),
     with each kernel's time, its bound, the
     plain version's time and a PyTorch library call's as a yardstick;
     and the RMSNorm kernels at the 6.9B cells' shape ([8192, 4096] bf16):
     y against the plain version (bitwise in at least 99.9% of the rows,
     the rest one rounding step of the rsqrt away), dx and dg against the
     float64 derivative (no further than the plain autograd path, within
     1e-2) and the plain twin of the backward, two backward passes
     bitwise equal, each kernel's time beside its byte bound, the plain
     versions' and ``torch.nn.functional.rms_norm``'s (never called by the
     port) as the yardstick;
  3. probe — run_probe on the card (collectives are degenerate on 1 GPU);
  4. flagship — the full-width train step (mxu_config, b8 t1024 bf16,
     flash attention): loss finite and decreasing, step time, MFU, the
     launch counts of the kernels its timed steps ran, and one more step
     of the same state under torch.profiler (CUDA activity): the 10 device
     kernels with the most self time, each attention kernel by name, and
     attention's share of the step;
  5. long_context — the same model at seq 4096 b2, which runs the forward's
     K-blocked contract and the backward pair at T=4096, profiled the same
     way;
  6. parallel — (a) ``entry.dryrun_multichip`` (the dp x sp x tp, ep and
     pp train steps) and the probe's ``validate_training`` over NCCL, one
     process per card (one card: a world of one, marked
     ``degenerate_single_device``); (b) a 4-rank ring replayed on this
     card at the long-context attention shape (B2 T4096, 32 x 128, bf16,
     T_local 1024): the ring module's block steps, 16 whole-K
     ``flash_fwd`` launches at ring offsets, then its backward steps,
     held against the flash attention over the whole T; the kernel held
     against its plain version at each of the 16 blocks; each block
     kind's kernel time beside its bound, its plain version and SDPA, the
     16 launches timed as one pass, and the schedule's times; (c) the
     replay's launch count;
  7. elastic — (a) on one card, the flagship state at full width (the
     flash step, b8 x t1024, ~4.84 GB of bf16 parameters and AdamW
     moments) in a world of one over NCCL: two steps, ``drain_sharded``
     generation 1, one uninterrupted reference step, the state dropped,
     ``shutdown_distributed`` and ``initialize_distributed`` on a new port
     in this process, ``restore_sharded`` (every leaf bitwise equal to the
     drained host copy), and one step whose loss must be within 1e-3 of
     the reference; the drain and restore split into their parts, bytes,
     GB/s, free disk and peak device memory; then the legacy
     ``drain_restore_cycle`` on the probe's toy config. (c) the Pod's own
     ride through the port's control plane
     (``gpumounter_tpu_torch/testing/elastic_attach.py``): the master of
     phase 12 in front of its worker, whose ``mesh_gen_dir`` is set; a
     CUDA-free pod process (``elastic.ElasticSupervisor``, its ``dev_root``
     the fixture container's ``/dev``) started before any attach and
     waiting for the worker's file; ``GET /addgpu/.../gpu/1`` attaches the
     card and the worker's own stamp starts a world of one rank at full
     width (the flash step, b8 x t1024, ~4.84 GB of bf16 parameters and
     AdamW moments) on the UUID the attach returned; ``POST /removegpu``
     answers 409 ``GPU_BUSY`` with the rank's pid while it rides; then the
     bump: on one card the worker's own ``_stamp_mesh_generation`` stamps
     the same card anew (a respawn at the same width), on two or more a
     second ``/addgpu`` stamps both cards and the world grows to two ranks
     on the Megatron split; the rank drains and exits on the agreed bump,
     the fresh world restores and continues; step numbers strictly
     increase, the fingerprint and every leaf (SHA-256 of each whole leaf)
     are bitwise across the respawn, the first loss after it is within
     1e-3 (1e-2 for the grow) of the old rank's uninterrupted step, the old
     rank's pid is gone, each new rank holds an attached card's node, the
     pod process never initialised CUDA (no ``/dev/nvidia*`` open), and
     after the stop ``/removegpu`` leaves no slave pod and no node; the
     attach to the first step in parts (``/addgpu``'s return to the stamp
     seen, the spawn, the interpreter, the device, the process group, the
     fresh state, the first step), printed on a line of its own, and the
     respawn's downtime in parts. (b) with two or more cards,
     ``MemberRunner`` pod processes re-federate over NCCL at full width on
     the Megatron split (mesh (1, 1, n)), riding 1 -> 2 -> 1 members
     against the port's own master (``testing/sim.py``
     ``MultiNodeStack``: ``/addgpuslice``, ``/slicez``, ``/slice/barrier``
     and ``POST /slice/resize`` over fixture GKE GPU hosts whose
     allocatable ``nvidia.com/gpu`` is the cards per member): members of
     two cards each (two local rank processes; worlds of 2 -> 4 -> 2 GPUs)
     on four or more cards, of one card each on two or three; the
     resizes answered with generations 2 and 3, step numbers strictly
     increase, fingerprints survive each transition, the loss goes down,
     the members resized out exit 0, and only host 0 keeps its slave pod.
     On one card (b) is reported degenerate;
  8. selftest — ``gpu_selftest`` in a child process, its nine checks;
  9. device_layer — the enumerators (Python and native) on the real /dev
     and /proc, held against nvidia-smi by UUID;
 10. node_attach — the node half of an attach on the real device layer:
     both native libraries built, a fake kubelet listing the card's UUID
     (and one id the node lacks) for a slave pod, ``GPUCollector`` mapping
     it to the card's node, ``GPUMounter`` granting the card and its three
     companions through the cgroup-v1 device gate of a fixture container
     under ``build/node_attach/`` and making their nodes there (fake nodes:
     the checkout's filesystem may refuse mknod), a child holding a CUDA
     context on the card making the detach refuse, the detach completing
     after the child exits (companions revoked with the last GPU, kept in
     a container that held them before the attach), 20 timed cycles of
     ``update_status``, grant + mount and revoke + unmount, and the BPF
     program's length with ``BpfGate.supported()``;
 11. worker_attach — the worker half of an attach on the same device layer
     (``gpumounter_tpu_torch/testing/worker_attach.py``): ``AddGPU`` over
     gRPC to the port's worker (``build_server``, parking executor), a slave
     pod requesting ``nvidia.com/gpu`` in an HTTP apiserver facade read
     through the REST client and its informer, a scripted scheduler
     assigning the card's NVML UUID through a PodResources gRPC server, the
     card's node and companions granted by the v1 gate and made by the
     resident agent (fake nodes; its fallback count must stay 0), the
     journal committed, ``RemoveGPU`` answering ``GPUBusy`` with the PID of
     a child holding a CUDA context, the detach after it exits, a container
     that held the companions keeping them, and 20 timed attach/detach
     pairs with the apiserver requests of each;
 12. master_attach — the control-plane half of an attach on the same device
     layer (``gpumounter_tpu_torch/testing/master_attach.py``): the
     reference's ``GET /addgpu/.../gpu/1/isEntireMount/true`` over loopback
     HTTP to the port's master (``MasterGateway``: the attach broker, its
     lease, the worker directory, the multiplexed front) in front of the
     worker of phase 11, answered SUCCESS with the card's nvidia-smi UUID
     and ``/dev/nvidiaN``; the gate and the nodes in the fixture
     container; the in-pod proof — a child with ``CUDA_VISIBLE_DEVICES``
     set to the returned UUID launching the whole-K ``flash_fwd`` at a
     small bf16 shape, held against its plain version at the parity
     tolerances — during which ``POST /removegpu/...`` answers 409
     ``GPU_BUSY`` with its PID; the detach after it exits; 20 timed HTTP
     attach/detach pairs with the master's spans beside the worker's and
     the apiserver requests of each; one ``/fleetz`` (the worker fresh)
     and one ``/metrics`` read (every attach counted by master and
     worker); the resident agent's fallbacks 0;
 13. slice_attach — a four-host slice through the same master
     (``gpumounter_tpu_torch/testing/slice_attach.py``): host 0 is the
     worker of phase 11 on this machine's card, hosts 1-3 are fixture GKE
     GPU nodes (``nvidia-h100-80gb``, one GPU each); ``POST /addgpuslice``
     over the four pods answers SUCCESS with host 0's nvidia-smi UUID;
     ``/slicez`` shows the group at generation 1 with its generation-1
     barrier, which the four members complete with the port's
     ``BarrierClient``; ``/slice/resize`` 4 -> 2 -> 4 moves the generation
     to 2 and 3 in ``/slicez``, ``MasterSliceSignal`` and the members'
     ``tpumounter.io/mesh-generation`` annotations, re-arming the barrier;
     the in-pod proof on host 0's card makes ``/removegpuslice`` answer
     409 with host 0 ``GPU_BUSY``, and the repeat after it exits answers
     200 (the hosts already detached ``GPU_NOT_FOUND``); a gang parks
     behind a plain ``/addgpu`` on host 3 and completes when it is
     removed; 20 timed ``/addgpuslice`` + ``/removegpuslice`` pairs with
     the slice trace's spans and each host's attach time; the slice
     invariants, the agent's fallbacks 0, and the phase under 45 s;
 14. ha_attach — a leader fail-over under a live attach
     (``gpumounter_tpu_torch/testing/ha_attach.py``): the worker of phase
     11 behind TWO port masters with the HA plane on (2 shards, election,
     intent store, proxy forwarding, the production renew 2 s and TTL 6 s,
     group commit), each with its own REST client on the facade, so the
     election locks and the store's ConfigMaps cross HTTP; ``/addgpu``
     sent to the peer P is proxied to the owner O and answered with the
     card's nvidia-smi UUID, its lease record lands in O's shard ConfigMap;
     the in-pod proof makes ``/removegpu`` answer 409 ``GPU_BUSY`` through
     both masters; an attach for a second pod parks on O (its waiter record
     in the store); O is killed (crash: nothing released) and P takes the
     shard over with a bumped fence, merges the lease and adopts the
     waiter (timed); after the proof exits the detach through P succeeds
     and the adopted waiter completes on the same UUID, actuated once;
     O restarts fresh and does not take the shard back; 20 timed
     ``/addgpu`` + ``/removegpu`` pairs through the owner and 20 through
     the non-owner (proxied), with spans and the facade's ConfigMap and pod
     requests per pair; ``/fleetz`` ``masters`` and ``shard_forwards``;
     the broker invariants with the store, fallbacks 0, the phase under
     60 s;
 15. node_failure — a member host of a live slice dies
     (``gpumounter_tpu_torch/testing/node_failure.py``): the four hosts of
     phase 13 behind one master with node health on (a fleet interval of
     1 s, suspect after 2 missed scrapes, dead after 5), every worker with
     its health sidecar, host 0 on this machine's card holding a pod
     labelled ``tpumounter.io/slice-spare=true``; ``/addgpuslice`` over
     hosts 1-3 and the generation-1 barrier; host 2 killed (Node
     ``Ready=False``, gRPC and sidecar stopped), timed to suspect and to
     dead, a plain ``/addgpu`` there answered 503 ``NodeCordoned``; its
     lease fenced (slave pod deleted, ``tpumounter_lease_fences_total``
     moved), timed from dead; the group repaired onto the spare at
     generation 2 (``/slicez``, the barrier, ``MasterSliceSignal``, the
     annotations), timed from dead, with the facade requests of the repair;
     the repaired member's in-pod ``flash_fwd`` on the card's nvidia-smi
     UUID (its launch reported here, not in the kernels line); a drain on
     host 3 cordoned within one fleet tick, its migration deferred without
     a teardown; host 2 restarted with no grant resurrected and healthy
     only after 2 clean scrapes; the node-death, slice and broker
     invariants, fallbacks 0, the phase under 60 s;
 16. defrag — the topology plane and the defragmenter
     (``gpumounter_tpu_torch/testing/defrag.py``): the worker of phase 11
     on this machine's card as host 0 (a spare pod there), hosts 1-3
     fixture nodes without the accelerator label with two GPUs each,
     every sidecar serving ``/utilz`` and ``/topoz``, the master with a
     1 s fleet tick and ``TPU_DEFRAG_MODE=act``; ``/topoz`` on host 0
     lists exactly the card's nvidia-smi UUID; ``/utilz`` reads the card
     idle from NVML, busy (duty >= 0.5, source ``nvml``, one open) while
     a child loops ``flash_fwd`` on it for 3 s, and idle again; the fleet
     fragmented by ``/addgpuslice`` (an idle one-GPU group on host 1, busy
     two-GPU gangs on hosts 2 and 3) scores 0.5 with one candidate; the
     defragmenter moves the idle group onto the card through
     ``migrate_member`` after its hysteresis, the score reads 0.0 and the
     verify pass charges no budget, the gangs stay, and the moved member's
     in-pod ``flash_fwd`` runs on the card (its launch reported here, not
     in the kernels line); the topology, defrag and slice invariants,
     fallbacks 0, the phase under 60 s; with the GET, sampling, NVML,
     scoring and move times;
 17. operator — the operator's command line
     (``gpumounter_tpu_torch/testing/operator.py``, in a fresh interpreter,
     so doctor judges a registry holding only this phase's work):
     ``gpumounterctl``, one ``python3 -m gpumounter_tpu_torch.cli`` process
     per command (no CUDA context), against the master of phase 12 in
     front of the worker on this machine's card, the worker's usage
     sampler holding NVML and its ``/topoz`` view on the sidecar:
     ``add --gpus 1 --json`` exits 0 with the card's nvidia-smi UUID,
     ``status`` lists it, the in-pod ``flash_fwd`` proof runs on it (its
     launch reported here, not in the kernels line), ``utilz`` reads the
     card from ``nvml``, ``trace <rid>`` draws the master's and the
     worker's spans, ``node`` and ``topo`` exit 0 and ``topo`` lists the
     UUID, ``doctor --node`` exits 0 or 1 with only the warning the phase
     names (the node's one GPU is attached), ``remove`` leaves no slave
     pod; 10 timed add/remove pairs (each process from start to exit,
     beside the request's gateway span) and ``--version``; an unreachable
     master exits 10; an add whose first reply a proxy drops is retried
     under the same request id and makes one slave pod; fallbacks 0;
 18. chaos — a worker holding this machine's card crashed and replayed
     (``gpumounter_tpu_torch/testing/worker_chaos.py``, the worker of phase
     11, whose crash rebuilds the journal object, the device gate, the
     agent, the service and the gRPC server over the surviving cluster,
     fixture cgroup, nodes and journal file): 10 fault-free timed
     ``AddGPU`` + ``RemoveGPU`` pairs; the attach killed at each crash
     point (``before_actuate``, ``mid_actuate``, ``before_commit``), each
     crash asserted to have fired, the restart's replay completing it
     (timed from restart to replay done, with its facade requests) with the
     card's node matching the host node's ``st_rdev``, the gate granting
     exactly the card, one slave pod, no backlog, one resumed attach event,
     then a ``RemoveGPU`` leaving no companion rule and no node; the
     owner's death after ``before_commit`` replayed to a revert; the
     detach killed mid-revoke and inside the v1 gate's sync (a pending
     gate record), the restart re-granting and the retried detach
     revoking; eight transient plans over the facade (socket drops, 429s,
     latency, watch hang and death, event 500s, and the PodResources
     server stopped and restarted during the attach), one timed pair
     each against the fault-free median, with the retries and requests
     counted; the in-pod ``flash_fwd`` on the card after the first replay
     and after the plans (its launches reported here, not in the kernels
     line); the chaos invariants at every step, fallbacks 0, the phase
     under 60 s;
 19. worker_surface — what the worker serves in a GPU cluster, on the
     worker of phase 11 (``gpumounter_tpu_torch/testing/worker_surface.py``):
     a self-signed certificate carrying ``gpu-mounter-worker`` made under
     ``build/worker_surface``, the worker served over mTLS and dialed by
     IP with that name verified, a client without a certificate of its
     own and a plaintext client both refused; a Pod of two
     containers (``main``, ``sidecar``) into both of which ``AddGPU`` puts
     the card's node (the host node's ``st_rdev``) and the companions once,
     granted by the v1 gate in both; a CUDA holder in the sidecar named by
     ``GPUStatus`` over mTLS and by the master's ``/gpustatus`` (the
     master dialing the worker over mTLS), the master echoing a supplied
     ``X-Request-Id``, ``RemoveGPU`` answering ``GPUBusy`` with the
     holder's pid, the forced detach killing it and leaving no node or
     rule in either container; the in-pod ``flash_fwd`` from the sidecar
     after a re-attach (its launches reported here); 30 ``AddGPU`` +
     ``RemoveGPU`` pairs over mTLS within fds +3, threads +2, empty lock
     tables, a drained event queue, and the apiserver and kubelet
     requests per pair of tests/test_torch_round_trip_budget.py; 20 pairs
     through the master over mTLS beside 20 through a master over
     plaintext (host-clock medians, min, max, gateway and worker spans);
     fallbacks 0, the phase under 60 s;
 20. control_plane_bench — the port's bench (``gpumounter_tpu_torch/bench.py``,
     ``run_control_plane``) at trimmed sizes on fixture GPUs (the card is
     not needed; phase 8 already ran the selftest child its ``main``
     reads): overhead 50 cycles, the events, usage, topology and parking
     A/Bs 30 each, the entire 8-GPU mount 10, e2e at a 1.0 s scheduler
     delay 5, the warm pool 3 with the apiserver round trips counted,
     contention 1 cycle, multimaster on a 2.5 s window, sustained 550
     clients (e2e 20 and pool 10 took the phase to 104 s on the H100
     machine; each of their cycles waits the 1.0 s delay), in its own
     interpreter, so that the process-wide registry it reads holds its
     own attaches only. Its checks are the ``measure_*`` functions' own
     (a failed one raises), a pool hit on every cycle, no LIST on the
     warm path, every latency finite, and the phase under 90 s; the bars
     of the bench's ``main`` (the A/Bs within noise, the absolute 10 ms
     overhead bar) are reported beside them, not held here. It also
     reports the threads the earlier phases left in this process and
     this process's CPU share while it waits (each phase's line carries
     the threads it left, ``threads_left``);
 21. the kernels line (each entry names the device function and the line
     of its definition), the card line, and the device line.

Tolerances: f32 1e-4 (CUDA-core f32 in the kernels, TF32 off in the plain
versions); bf16 1e-2 on the normalised output and on gradients' relative
Frobenius error, 1e-3 on m and lse. Exits non-zero, without the device
line, when there is no GPU, when the package is missing, or when any phase
failed (then the last line is ``{"ok": false, "failed": [...]}``, and the
last line of stderr names each failed phase's false checks or error).
"""

from __future__ import annotations

import functools
import gc
import json
import math
import multiprocessing
import os
import re
import select
import shutil
import subprocess
import sys
import threading
import time
import traceback

import torch

PALLAS = "gpumounter_tpu/jaxcheck/pallas_attention.py"
CSRC = "gpumounter_tpu_torch/torchcheck/csrc"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def thread_names(threads) -> dict[str, int]:
    """Threads counted by name, each run of digits read as N."""
    counts: dict[str, int] = {}
    for t in threads:
        name = re.sub(r"\d+", "N", t.name)
        counts[name] = counts.get(name, 0) + 1
    return counts


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip() or f"nvidia-smi rc={proc.returncode}"


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    launches after ``warmup``."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, rates) -> dict:
    """The least time the card could take for ``flops`` operations and
    ``nbytes`` moved, at ``rates`` = (peak FLOP/s, memory bytes/s), and
    which of the two bounds it."""
    t_ops, t_bytes = flops / rates[0], nbytes / rates[1]
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def ptxas_summary(log: str) -> dict:
    """Registers, stack and spill bytes of each kernel in an ``nvcc
    -Xptxas -v`` report, keyed by kernel name and template arguments (for
    example ``flash_bwd_dq_wgmma_kernel<128>``,
    ``flash_fwd_kernel<f32, 64>``)."""
    kernels: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"(flash_\w+?_kernel)I(f?)", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            if base is None:
                name = mangled
            else:
                name = (f"{base.group(1)}<"
                        f"{'f32, ' if base.group(2) else ''}"
                        f"{', '.join(args)}>")
            kernels[name] = {}
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill:
            kernels[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                     map(int, spill.groups())))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            kernels[name]["registers"] = int(used.group(1))
    return kernels


def max_abs(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_fro(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


class Checks:
    """Collects named pass/fail results of one phase."""

    def __init__(self):
        self.results: dict[str, dict] = {}

    def add(self, name: str, err: float, tol: float) -> None:
        self.results[name] = {"err": err, "tol": tol,
                              "ok": bool(math.isfinite(err) and err <= tol)}

    @property
    def ok(self) -> bool:
        return all(r["ok"] for r in self.results.values())


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _normalized(pv, l):
    return pv / l.transpose(1, 2).clamp_min(1e-30)


def _attention_f64(q4, k4, v4, w):
    """Causal attention of [B, T, H, D] inputs in float64 on the CPU, with
    autograd: (out, dq, dk, dv) of sum(out * w), the oracle of the f32
    trainable attention."""
    leaves = [x.detach().cpu().double().requires_grad_(True)
              for x in (q4, k4, v4)]
    q, k, v = (x.transpose(1, 2) for x in leaves)
    t = q.shape[2]
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -math.inf)
    out = (torch.softmax(s, dim=-1) @ v).transpose(1, 2)
    (out * w.cpu().double()).sum().backward()
    return (out, *(x.grad for x in leaves))


def _cpu_math() -> dict:
    """The CPU settings that decide the plain versions' f32 rounding."""
    mkldnn = torch.backends.mkldnn
    return {"threads": torch.get_num_threads(),
            "capability": torch.backends.cpu.get_cpu_capability(),
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "mkldnn_enabled": mkldnn.enabled,
            "mkldnn_matmul_fp32_precision": getattr(
                getattr(mkldnn, "matmul", None), "fp32_precision", None)}


def parity_small(fa, kernels, ra) -> dict:
    """f32 at b1 h2 d64: contracts, offsets, masking, oracle, T=768/1536;
    bf16 at d64 and d128 at every block pair of a 4-rank ring; and the same
    T=768/1536 trainable attention in bf16. The f32
    trainable attention is also held against a float64 oracle, the card's
    side gated and the CPU side reported, so that a drift shows its side."""
    checks = Checks()
    cpu_vs_f64: dict[str, list[float]] = {}
    gen = torch.Generator("cuda").manual_seed(0)
    f32 = torch.float32
    q, k, v = (_rand((2, 256, 64), f32, gen) for _ in range(3))
    scale = 64 ** -0.5
    for skip in ((0, 0), (128, 128)):
        for offsets in ((0, 0), (1024, 1024), (0, 4096)):
            got = kernels.flash_fwd(q, k, v, *offsets, scale, *skip)
            want = fa._flash_fwd_plain(q, k, v, *offsets, scale, *skip)
            tag = f"fwd_f32_skip{skip[0]}_off{offsets[0]}_{offsets[1]}"
            checks.add(tag + "_out", max_abs(_normalized(got[0], got[2]),
                                             _normalized(want[0], want[2])),
                       1e-4)
            checks.add(tag + "_m", max_abs(got[1], want[1]), 1e-4)
            checks.add(tag + "_l", rel_fro(got[2], want[2].clamp_min(1e-30))
                       if float(want[2].abs().max()) > 0
                       else max_abs(got[2], want[2]), 1e-4)
    # bf16 at every block pair of a 4-rank ring of T_local 256: diagonal,
    # wholly visible (q_offset > k_offset) and wholly future blocks
    ring = [(r * 256, src * 256) for r in range(4) for src in range(4)]
    for d in (64, 128):
        qb, kb, vb = (_rand((2, 256, d), torch.bfloat16, gen)
                      for _ in range(3))
        for skip in ((0, 0), (128, 128)):
            errs = {"out": 0.0, "m": 0.0}
            for offsets in ring:
                got = kernels.flash_fwd(qb, kb, vb, *offsets, d ** -0.5, *skip)
                want = fa._flash_fwd_plain(qb, kb, vb, *offsets, d ** -0.5,
                                           *skip)
                errs["out"] = max(errs["out"], max_abs(
                    _normalized(got[0], got[2]), _normalized(want[0],
                                                             want[2])))
                errs["m"] = max(errs["m"], max_abs(got[1], want[1]))
            tag = f"fwd_bf16_d{d}_skip{skip[0]}_ring_offsets"
            checks.add(tag + "_out", errs["out"], 1e-2)
            checks.add(tag + "_m", errs["m"], 1e-3)
    # a block wholly in the future merges away (whole-K contract)
    pv0, m0, l0 = kernels.flash_fwd(q, k, v, 0, 0, scale)
    pv1, m1, l1 = kernels.flash_fwd(q, k, v, 0, 4096, scale)
    to_bthd = (lambda x: x.reshape(1, 2, 256, 64).transpose(1, 2))
    acc, _, l = ra.merge_block(to_bthd(pv0), m0.reshape(1, 2, 256),
                               l0.reshape(1, 2, 256), to_bthd(pv1),
                               m1.reshape(1, 2, 256), l1.reshape(1, 2, 256))
    checks.add("fully_masked_merge_acc", max_abs(acc, to_bthd(pv0)), 1e-6)
    checks.add("fully_masked_merge_l", max_abs(l, l0.reshape(1, 2, 256)),
               1e-6)
    # float64 oracle
    s = (q.double() @ k.double().transpose(1, 2)) * scale
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool,
                                  device="cuda").tril(), -math.inf)
    oracle = torch.softmax(s, dim=-1) @ v.double()
    checks.add("fwd_f32_vs_float64_oracle",
               max_abs(_normalized(pv0, l0).double(), oracle), 1e-4)
    # the trainable attention (kernel fwd + bwd) against the same Function
    # on CPU copies, i.e. the plain versions
    attn = fa.make_flash_attention()
    for dtype, tol in ((f32, 1e-4), (torch.bfloat16, 1e-2)):
        for t in (768, 1536):
            q4, k4, v4, w = (_rand((1, t, 2, 64), dtype, gen)
                             for _ in range(4))
            results = []
            for dev in ("cuda", "cpu"):
                leaves = [x.detach().to(dev).requires_grad_(True)
                          for x in (q4, k4, v4)]
                out = attn(*leaves)
                (out.float() * w.to(dev).float()).sum().backward()
                results.append((out, *(x.grad for x in leaves)))
            name = f"attn_{str(dtype).split('.')[-1]}_t{t}"
            checks.add(name + "_out", max_abs(results[0][0].cpu(),
                                              results[1][0]), tol)
            for g, gname in zip(range(1, 4), ("dq", "dk", "dv")):
                checks.add(f"{name}_{gname}",
                           rel_fro(results[0][g].cpu(), results[1][g]), tol)
            if dtype != f32:
                continue
            oracle = _attention_f64(q4, k4, v4, w)
            cuda_side, cpu_side = ([max_abs(r[0].cpu(), oracle[0])]
                                   + [rel_fro(r[g].cpu(), oracle[g])
                                      for g in range(1, 4)]
                                   for r in results)
            for err, part in zip(cuda_side, ("out", "dq", "dk", "dv")):
                checks.add(f"{name}_{part}_vs_float64_oracle", err, tol)
            cpu_vs_f64[name] = cpu_side
    return {"checks": checks.results, "ok": checks.ok,
            "cpu_plain_vs_float64_oracle": {"out_dq_dk_dv": cpu_vs_f64,
                                            "cpu_math": _cpu_math()}}


def _library_bwd_ms(q4, k4, v4, do4):
    """One backward of F.scaled_dot_product_attention (the library's
    fused dq+dk+dv) — a yardstick the port never calls."""
    import torch.nn.functional as F
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    return cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do4, retain_graph=True), reps=5)


def check_shape(fa, kernels, checks, rows, path, b, t, skip, gen,
                rates) -> float:
    """bf16 at the shape one main path gives the kernels (B=b, H32, T=t,
    D128 -> [b*32, t, 128]): the forward (whole-K when ``skip`` is (0, 0),
    else K-blocked over ``skip``) and the backward pair, each held against
    its plain version and timed beside its bound, its plain version and a
    library call. The backward's lse and drow come from the plain
    forward, as the train step makes them from the forward's. Adds rows
    keyed by kernel and ``path``; returns SDPA's forward+backward ms at
    this shape."""
    import torch.nn.functional as F
    h, d, es = 32, 128, 2
    bh, scale = b * h, d ** -0.5
    fwd = "fwd_kblocked" if skip[0] else "fwd_whole_k"
    q, k, v, do = (_rand((bh, t, d), torch.bfloat16, gen) for _ in range(4))
    q4, k4, v4, do4 = (x.view(b, h, t, d) for x in (q, k, v, do))
    pairs = bh * t * (t + 1) / 2          # causal (q, k) pairs, offsets 0
    io = bh * t * d * es                  # one [BH, T, D] bf16 tensor
    acc = bh * t * d * 4                  # one [BH, T, D] f32 tensor
    stats = 2 * bh * t * 4                # two [BH, 1, T] f32 rows
    shape = {"path": path, "shape": [bh, t, d], "dtype": "bfloat16"}

    got = kernels.flash_fwd(q, k, v, 0, 0, scale, *skip)
    want = fa._flash_fwd_plain(q, k, v, 0, 0, scale, *skip)
    out = _normalized(want[0], want[2])
    lse = want[1] + torch.log(want[2])
    out_err = max_abs(_normalized(got[0], got[2]), out)
    checks.add(f"{fwd}_out", out_err, 1e-2)
    checks.add(f"{fwd}_m", max_abs(got[1], want[1]), 1e-3)
    checks.add(f"{fwd}_lse", max_abs(got[1] + torch.log(got[2]), lse), 1e-3)
    drow = (do.float() * out).sum(-1)[:, None]
    del got, want, out
    rows[fwd] = {
        **shape, "max_abs_err": out_err,
        "ms": cuda_ms(lambda: kernels.flash_fwd(q, k, v, 0, 0, scale,
                                                *skip)),
        "plain_ms": cuda_ms(lambda: fa._flash_fwd_plain(
            q, k, v, 0, 0, scale, *skip), reps=3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)),
        **bound(4 * d * pairs, 3 * io + acc + stats, rates)}

    args = (q, k, v, do, lse, drow, scale)
    dq, dq_ref = kernels.flash_bwd_dq(*args), fa._flash_dq_plain(*args)
    (dk, dv), (dk_ref, dv_ref) = (kernels.flash_bwd_dkdv(*args),
                                  fa._flash_dkdv_plain(*args))
    for name, a, r in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                       ("dv", dv, dv_ref)):
        checks.add(f"bwd_{name}_{path}_rel_fro", rel_fro(a, r), 1e-2)
    lib_bwd = _library_bwd_ms(q4, k4, v4, do4)
    rows[f"bwd_dq_{path}"] = {
        **shape, "max_abs_err": max_abs(dq, dq_ref),
        "rel_fro_err": rel_fro(dq, dq_ref),
        "ms": cuda_ms(lambda: kernels.flash_bwd_dq(*args)),
        "plain_ms": cuda_ms(lambda: fa._flash_dq_plain(*args), reps=3),
        "library_ms": lib_bwd,
        **bound(6 * d * pairs, 4 * io + stats + acc, rates)}
    rows[f"bwd_dkdv_{path}"] = {
        **shape, "max_abs_err": max(max_abs(dk, dk_ref), max_abs(dv, dv_ref)),
        "rel_fro_err": max(rel_fro(dk, dk_ref), rel_fro(dv, dv_ref)),
        "ms": cuda_ms(lambda: kernels.flash_bwd_dkdv(*args)),
        "plain_ms": cuda_ms(lambda: fa._flash_dkdv_plain(*args), reps=3),
        "library_ms": lib_bwd,
        **bound(8 * d * pairs, 4 * io + stats + 2 * acc, rates)}
    del dq, dq_ref, dk, dk_ref, dv, dv_ref

    def fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, do4)

    library_fwd_bwd_ms = cuda_ms(fwd_bwd, reps=5)
    del q, k, v, do, q4, k4, v4, do4, lse, drow, args
    torch.cuda.empty_cache()
    return library_fwd_bwd_ms


def parity_main_path(fa, kernels, rates) -> tuple[dict, dict]:
    """bf16 at the main paths' shapes: the flagship step's (B8 T1024, the
    whole-K forward) and the long-context step's (B2 T4096, the K-blocked
    forward), with the backward pair at both. Returns (phase report,
    per-kernel numbers for the kernels line)."""
    checks = Checks()
    rows: dict[str, dict] = {}
    gen = torch.Generator("cuda").manual_seed(1)
    t = 4096
    skip = (fa._fit_tile(fa.FWD_TILE_Q, t), fa._fit_tile(fa.FWD_K_BLOCK, t))
    library = {
        "flagship": check_shape(fa, kernels, checks, rows, "flagship", 8,
                                1024, (0, 0), gen, rates),
        "long_context": check_shape(fa, kernels, checks, rows,
                                    "long_context", 2, t, skip, gen, rates)}
    return ({"checks": checks.results, "library_fwd_bwd_ms": library,
             "kernels": rows, "ok": checks.ok}, rows)


def norm_kernels(kernels, model_lib, rates, rows: int = 8192,
                 d: int = 4096) -> tuple[dict, dict]:
    """The RMSNorm kernels at the 6.9B cells' shape ([rows, d] bf16), held
    against the plain versions and the float64 derivative, and timed
    beside their byte bounds (x and y; x, dy and dx; the gain and the f32
    rsqrt once), the plain versions and ``F.rms_norm``. Returns (phase
    report, per-kernel numbers for the kernels line)."""
    import torch.nn.functional as F
    checks = Checks()
    gen = torch.Generator("cuda").manual_seed(4)
    dtype, es = torch.bfloat16, 2
    x = _rand((rows, d), dtype, gen)
    g = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    dy = _rand((rows, d), dtype, gen)
    shape = {"path": "norm", "shape": [rows, d], "dtype": "bfloat16"}

    y, rstd = kernels.rmsnorm_fwd(x, g)
    want = model_lib._rmsnorm_plain(x, g)
    plain_rstd = torch.rsqrt(x.float().square().mean(-1) + 1e-6)
    steps = (rstd.to(dtype).view(torch.int16).int()
             - plain_rstd.to(dtype).view(torch.int16).int()).abs()
    fwd_err = max_abs(y, want)
    other_rows = float(1 - (y == want).all(-1).float().mean())
    checks.add("fwd_rows_not_bitwise", other_rows, 1e-3)
    checks.add("fwd_rsqrt_steps", float(steps.max()), 1)
    checks.add("fwd_y_from_its_rsqrt", max_abs(
        y, (x * rstd.to(dtype)[:, None]) * g), 0.0)

    dx, dg = kernels.rmsnorm_bwd(x, g, rstd, dy)
    again = kernels.rmsnorm_bwd(x, g, rstd, dy)
    checks.add("bwd_bitwise_twice", max(max_abs(dx, again[0]),
                                        max_abs(dg, again[1])), 0.0)
    twin = model_lib._rmsnorm_bwd_plain(x, g, rstd, dy)
    xt, gt = (t.double().requires_grad_(True) for t in (x, g))
    (xt * torch.rsqrt(xt.square().mean(-1, keepdim=True) + 1e-6)
     * gt).backward(dy.double())
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    model_lib._rmsnorm_plain(xl, gl).backward(dy)
    errors = {}
    for name, got, plain, truth, same in (
            ("dx", dx, xl.grad, xt.grad, twin[0]),
            ("dg", dg, gl.grad, gt.grad, twin[1])):
        errors[name] = {"kernel": rel_fro(got.double(), truth),
                        "plain_autograd": rel_fro(plain.double(), truth),
                        "twin": rel_fro(got, same)}
        checks.add(f"bwd_{name}_f64_rel_fro", errors[name]["kernel"],
                   min(errors[name]["plain_autograd"], 1e-2))
        checks.add(f"bwd_{name}_twin_rel_fro", errors[name]["twin"], 1e-2)
    bwd_err = max_abs(dx, xl.grad)
    del again, twin, xt, gt, xl, gl, want, plain_rstd

    row_bytes = rows * d * es
    small = d * es + rows * 4                 # the gain and the f32 rsqrt
    rows_out = {}
    xr = x.detach().requires_grad_(True)
    gr = g.detach().requires_grad_(True)
    lib_y = F.rms_norm(xr, (d,), gr, eps=1e-6)
    plain_y = model_lib._rmsnorm_plain(xr, gr)
    rows_out["rmsnorm_fwd"] = {
        **shape, "max_abs_err": fwd_err,
        "ms": cuda_ms(lambda: kernels.rmsnorm_fwd(x, g), reps=20),
        "plain_ms": cuda_ms(lambda: model_lib._rmsnorm_plain(x, g)),
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), g, eps=1e-6)),
        **bound(4 * rows * d, 2 * row_bytes + small, rates)}
    rows_out["rmsnorm_bwd"] = {
        **shape, "max_abs_err": bwd_err,
        "rel_fro_err": errors,
        "ms": cuda_ms(lambda: kernels.rmsnorm_bwd(x, g, rstd, dy), reps=20),
        "plain_ms": cuda_ms(lambda: model_lib._rmsnorm_bwd_plain(
            x, g, rstd, dy)),
        "plain_autograd_ms": cuda_ms(lambda: torch.autograd.grad(
            plain_y, (xr, gr), dy, retain_graph=True)),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_y, (xr, gr), dy, retain_graph=True)),
        **bound(8 * rows * d, 3 * row_bytes + small + d * es, rates)}
    del x, g, dy, y, rstd, dx, dg, xr, gr, lib_y, plain_y
    torch.cuda.empty_cache()
    return ({"checks": checks.results, "errors": errors,
             "kernels": rows_out, "ok": checks.ok}, rows_out)


def ring_replay(fa, kernels, ra, rates) -> tuple[dict, dict, dict]:
    """A 4-rank ring replayed on one card at the long-context attention
    shape (B2, T4096, 32 heads x 128, bf16; T_local 1024): for each rank r
    and rotation i, the ring module's own block step on the block
    (r - i) mod 4 — 16 whole-K ``flash_fwd`` launches, 4 diagonal, 6 wholly
    visible, 6 wholly future — then its backward steps the same way. Held
    against the flash attention over the whole T. Returns (report, the
    kernels-line row, the replay's launch counts)."""
    import torch.nn.functional as F
    b, t, h, d, n = 2, 4096, 32, 128, 4
    tl, bh, scale = t // n, b * h, d ** -0.5
    gen = torch.Generator("cuda").manual_seed(2)
    q, k, v, do = (_rand((b, t, h, d), torch.bfloat16, gen) for _ in range(4))
    qs, ks, vs, dos = (x.split(tl, dim=1) for x in (q, k, v, do))

    def forward():
        outs, lses = [], []
        for r in range(n):
            state = ra.ring_state(qs[r])
            for i in range(n):
                src = (r - i) % n
                state = ra.ring_step(state, qs[r], ks[src], vs[src], r * tl,
                                     src * tl, block_impl="pallas")
            out, lse = ra.ring_output(state, q.dtype)
            outs.append(out)
            lses.append(lse)
        return outs, lses

    def backward(outs, lses):
        zeros = [torch.zeros((b, tl, h, d), device="cuda") for _ in range(n)]
        dq, dk, dv = [], list(zeros), [z.clone() for z in zeros]
        for r in range(n):
            drow = fa.softmax_jacobian_diag(dos[r], outs[r])
            g_q = torch.zeros((b, tl, h, d), device="cuda")
            for i in range(n):
                src = (r - i) % n
                g_q, dk[src], dv[src] = ra.ring_bwd_step(
                    (g_q, dk[src], dv[src]), qs[r], ks[src], vs[src], dos[r],
                    drow, lses[r], r * tl, src * tl)
            dq.append(g_q)
        return tuple(torch.cat(x, dim=1) for x in (dq, dk, dv))

    kernels.reset_launch_counts()
    outs, lses = forward()
    grads = backward(outs, lses)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)

    checks = Checks()
    attn = fa.make_flash_attention()
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref_out = attn(*leaves)
    ref_grads = torch.autograd.grad(ref_out, leaves, do)
    _, m, l = fa.flash_block_bthd(q, k, v, 0, 0, tile_q=fa.FWD_TILE_Q,
                                  k_block=fa.FWD_K_BLOCK)
    out_err = max_abs(torch.cat(outs, dim=1), ref_out)
    checks.add("ring_out", out_err, 1e-2)
    checks.add("ring_lse", max_abs(torch.cat(lses, dim=2), m + torch.log(l)),
               1e-3)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        checks.add(f"ring_{name}_rel_fro", rel_fro(got, want), 1e-2)
    del ref_out, ref_grads, leaves, m, l, grads

    # The whole-K kernel against its plain version at each of the replay's
    # 16 blocks, [BH, T_local, D] at (1024 r, 1024 src).
    qh, kh, vh = ([fa._to_bhd(x) for x in xs] for xs in (qs, ks, vs))
    schedule = [(r, (r - i) % n) for r in range(n) for i in range(n)]

    def kind_of(r, src):
        return ("diagonal" if r == src else "visible" if r > src
                else "future")

    block_errs = {kd: {"out": 0.0, "m": 0.0, "l": 0.0}
                  for kd in ("diagonal", "visible", "future")}
    for r, src in schedule:
        args = (qh[r], kh[src], vh[src], r * tl, src * tl, scale)
        got, want = kernels.flash_fwd(*args), fa._flash_fwd_plain(*args)
        errs = block_errs[kind_of(r, src)]
        errs["out"] = max(errs["out"], max_abs(_normalized(got[0], got[2]),
                                               _normalized(want[0], want[2])))
        errs["m"] = max(errs["m"], max_abs(got[1], want[1]))
        errs["l"] = max(errs["l"], rel_fro(got[2], want[2]))
        del got, want
    for kind, errs in block_errs.items():
        checks.add(f"block_{kind}_out", errs["out"], 1e-2)
        checks.add(f"block_{kind}_m", errs["m"], 1e-3)
        checks.add(f"block_{kind}_l_rel_fro", errs["l"], 1e-3)
    block_err = max(e for errs in block_errs.values() for e in errs.values())

    # Bytes and operations each kind of block needs. A wholly future block
    # has every score masked to exactly -1e30, so p = 1 at every key: its
    # pv is the sum of v over the keys and l = T_local, whatever q and k
    # hold. It reads v only, and sums it once.
    io = bh * tl * d * 2                  # one [BH, T_local, D] bf16 tensor
    out_bytes = bh * tl * d * 4 + 2 * bh * tl * 4     # pv, m, l in f32
    need = {"diagonal": (4 * d * bh * tl * (tl + 1) / 2, 3 * io + out_bytes),
            "visible": (4 * d * bh * tl * tl, 3 * io + out_bytes),
            "future": (bh * tl * d, io + out_bytes)}
    per_kind = {}
    for kind, (r, src) in (("diagonal", (1, 1)), ("visible", (2, 0)),
                           ("future", (0, 1))):
        args = (qh[r], kh[src], vh[src], r * tl, src * tl, scale)
        q4, k4, v4 = (x.view(b, h, tl, d) for x in args[:3])
        library = None
        if kind != "future":
            library = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=kind == "diagonal"))
        per_kind[kind] = {
            "offsets": [r * tl, src * tl],
            "per_ring_forward": sum(kind_of(*rs) == kind for rs in schedule),
            "ms": cuda_ms(lambda: kernels.flash_fwd(*args)),
            "plain_ms": cuda_ms(lambda: fa._flash_fwd_plain(*args), reps=3),
            "library_ms": library,
            **{f"err_{key}": e for key, e in block_errs[kind].items()},
            **bound(*need[kind], rates)}

    # The 16 launches of one ring forward, each timing one pass over the
    # schedule (no merges): the kernel, its plain version, and SDPA on the
    # 10 blocks that are not wholly future (SDPA has no fully masked row).
    def over_schedule(fn, blocks=schedule):
        def run():
            for r, src in blocks:
                fn(qh[r], kh[src], vh[src], r * tl, src * tl, scale)
        return run

    def sdpa(q_, k_, v_, q_offset, k_offset, _):
        F.scaled_dot_product_attention(
            *(x.view(b, h, tl, d) for x in (q_, k_, v_)),
            is_causal=q_offset == k_offset)

    visible = [rs for rs in schedule if kind_of(*rs) != "future"]
    flops, nbytes = (sum(need[kind_of(*rs)][i] for rs in schedule)
                     for i in (0, 1))
    row = {"max_abs_err": block_err,
           "ms": cuda_ms(over_schedule(kernels.flash_fwd)),
           "plain_ms": cuda_ms(over_schedule(fa._flash_fwd_plain), warmup=1,
                               reps=3),
           "library_ms": cuda_ms(over_schedule(sdpa, visible)),
           **bound(flops, nbytes, rates),
           "shape": [bh, tl, d], "dtype": "bfloat16",
           "unit": "one 4-rank ring forward: 16 launches, timed as one pass "
                   "(library: SDPA on its 10 blocks that are not wholly "
                   "future)"}
    del qh, kh, vh

    def fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(attn(*leaves), leaves, do)

    with torch.no_grad():
        flash_fwd_ms = cuda_ms(lambda: attn(q, k, v), reps=5)
    timing = {
        "ring_forward_ms": cuda_ms(forward, warmup=1, reps=3),
        "ring_backward_ms": cuda_ms(lambda: backward(outs, lses), warmup=1,
                                    reps=3),
        "flash_attention_fwd_ms": flash_fwd_ms,
        "flash_attention_fwd_bwd_ms": cuda_ms(fwd_bwd, warmup=1, reps=3)}
    del q, k, v, do, qs, ks, vs, dos, outs, lses
    torch.cuda.empty_cache()
    return ({"shape": {"batch": b, "seq": t, "heads": h, "head_dim": d,
                       "ranks": n, "t_local": tl}, "checks": checks.results,
             "blocks": per_kind, "schedule": timing, "launches": counts,
             "ok": checks.ok}, row, counts)


def ring_rank(device, seed: int) -> dict:
    """One rank of the ring over NCCL (two or more cards): the same
    B2 x T4096 x 32 x 128 bf16 inputs on every rank (one seed), the
    trainable ring attention over the world with ``block_impl="pallas"``
    on this rank's sequence shard, forward and backward, held against the
    flash attention over the whole T on this card; the ring's
    forward+backward time and this rank's kernel launches."""
    import torch.distributed as dist

    from gpumounter_tpu_torch.torchcheck import flash_attention as fa
    from gpumounter_tpu_torch.torchcheck import kernels
    from gpumounter_tpu_torch.torchcheck import ring_attention as ra
    torch.backends.cuda.matmul.allow_tf32 = False
    n, r = dist.get_world_size(), dist.get_rank()
    b, t, h, d = 2, 4096, 32, 128
    mine = slice(r * t // n, (r + 1) * t // n)
    gen = torch.Generator(device).manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [x[:, mine].contiguous().requires_grad_(True) for x in (q, k, v)]
    do_mine = do[:, mine].contiguous()
    attn = ra.make_ring_attention(dist.group.WORLD, block_impl="pallas")
    kernels.reset_launch_counts()
    out = attn(*leaves)
    grads = torch.autograd.grad(out, leaves, do_mine)
    torch.cuda.synchronize(device)
    counts = dict(kernels.LAUNCHES)
    ref_leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref = fa.make_flash_attention()(*ref_leaves)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    errors = {"out": max_abs(out, ref[:, mine])}
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        errors[name + "_rel_fro"] = rel_fro(got, want[:, mine])

    def fwd_bwd():
        torch.autograd.grad(attn(*leaves), leaves, do_mine)

    return {"rank": r, "t_local": t // n, "errors": errors,
            "launches": counts,
            "ring_fwd_bwd_ms": cuda_ms(fwd_bwd, warmup=1, reps=3)}


# Substrings of the device-kernel names of the port's attention kernels
# (demangled "flash::flash_..." or mangled "_ZN5flash...").
ATTENTION_KERNELS = ("flash::flash_", "_ZN5flash")


def profile_step(step, state, tokens, step_ms: float) -> dict:
    """One more step of a path's own warm ``step`` and ``state`` under
    torch.profiler with CUDA activity: the 10 device kernels with the most
    self time, each of the port's attention kernels by name, their device
    time and its share of all device time and of ``step_ms`` (the path's
    timed step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, tokens)
        torch.cuda.synchronize()
    rows = sorted(({"kernel": e.key[:160],
                    "ms": e.self_device_time_total / 1e3,
                    "calls": e.count} for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.is_user_annotation), key=lambda r: -r["ms"])
    if not rows:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    device_ms = sum(r["ms"] for r in rows)
    attention = [r for r in rows
                 if any(n in r["kernel"] for n in ATTENTION_KERNELS)]
    attn_ms = sum(r["ms"] for r in attention)
    return {"device_ms": device_ms, "attention_ms": attn_ms,
            "attention_share_of_device": attn_ms / device_ms,
            "attention_share_of_step": attn_ms / step_ms,
            "step_ms": step_ms, "top10": rows[:10], "attention": attention}


def run_path(kernels, measure):
    """Run one main path, ``measure(profile=...)``, with every launch count
    at 0 just before. The counts are read just after its timed steps,
    before ``profile_step`` runs one more step on the same state; that
    step's launches are not counted. Returns (report, counts)."""
    counts: dict[str, int] = {}

    def profiled(step, state, tokens, step_ms):
        counts.update(kernels.LAUNCHES)
        return profile_step(step, state, tokens, step_ms)

    kernels.reset_launch_counts()
    return measure(profile=profiled), counts


REPO = os.path.dirname(os.path.abspath(__file__))
# Checkpoints of the elastic phase: under the checkout's build directory
# (not committed), removed when the phase ends.
ELASTIC_DIR = os.path.join(REPO, "build", "elastic")


def _tree_pairs(a, b, path=""):
    """(path, leaf of a, leaf of b) for every leaf of two trees of dicts
    with the same keys."""
    if isinstance(a, dict):
        for key in a:
            yield from _tree_pairs(a[key], b[key], f"{path}/{key}")
    else:
        yield path, a, b


def drain_restore_one_card(kernels, card: str) -> dict:
    """Part (a) of the elastic phase: the flagship state's sharded drain,
    an in-process NCCL teardown and re-init, and its restore, at full
    width in a world of one (``tpu_selftest.check_drain_cycle`` at the
    flagship width, on the flash step)."""
    from gpumounter_tpu_torch.torchcheck import drain, elastic, federation
    from gpumounter_tpu_torch.torchcheck import model, perf, probe, train

    device = torch.device("cuda", 0)
    root = os.path.join(ELASTIC_DIR, "one_card")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free_before = shutil.disk_usage(root).free
    cfg = perf.mxu_config()
    specs = elastic.state_specs(cfg)
    torch.cuda.reset_peak_memory_stats(device)
    probe.initialize_distributed(f"127.0.0.1:{federation.free_port()}", 1, 0,
                                 device)
    kernels.reset_launch_counts()
    mesh = model.make_mesh(device=device)
    state = train.init_state(cfg, seed=0, device=device, mesh=mesh)
    step = train.make_train_step(cfg, mesh, attn_impl="flash")
    tokens = train.make_batch(torch.Generator(device).manual_seed(1), 8, 1024,
                              cfg.vocab)
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    n_params = sum(p.numel() for p in state.model.parameters())

    drain_t: dict = {}
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    drain.drain_sharded(train.state_tree(state), root, 1, specs=specs,
                        mesh=mesh, timings=drain_t)
    drain_s = time.perf_counter() - t0
    host = drain._map(lambda x: x.detach().to("cpu", copy=True)
                      if isinstance(x, torch.Tensor) else x,
                      train.state_tree(state))
    _, ref_loss = step(state, tokens)           # the uninterrupted step
    ref_loss = float(ref_loss)

    # drop the state and leave the world, then join a new one
    del state, step, mesh, loss
    gc.collect()
    t0 = time.perf_counter()
    left = probe.shutdown_distributed()
    shutdown_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe.initialize_distributed(f"127.0.0.1:{federation.free_port()}", 1, 0,
                                 device)
    init_s = time.perf_counter() - t0

    restore_t: dict = {}
    t0 = time.perf_counter()
    mesh = model.make_mesh(device=device)
    tree = drain.restore_sharded(root, specs, mesh=mesh, device=device,
                                 expect_generation=1, timings=restore_t)
    restore_s = time.perf_counter() - t0
    # the check against the drained host copy (not timed)
    mismatched = [path for path, got, want in _tree_pairs(tree, host)
                  if not (isinstance(want, int) and int(got) == want
                          or isinstance(want, torch.Tensor)
                          and got.dtype == want.dtype
                          and torch.equal(got.cpu(), want))]
    t0 = time.perf_counter()
    state = train.state_from_tree(cfg, tree, device)
    torch.cuda.synchronize(device)
    restore_t["optimizer_rebuild_s"] = time.perf_counter() - t0
    restore_s += restore_t["optimizer_rebuild_s"]
    del tree
    step = train.make_train_step(cfg, mesh, attn_impl="flash")
    state, loss = step(state, tokens)
    resumed_loss = float(loss)
    torch.cuda.synchronize(device)
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    del state, step, mesh, host
    probe.shutdown_distributed()
    shutil.rmtree(root, ignore_errors=True)

    nbytes = drain_t.get("bytes", 0)
    err = abs(resumed_loss - ref_loss)
    ran = all(counts[n] > 0 for n in ("flash_fwd_whole_k", "flash_bwd_dq",
                                      "flash_bwd_dkdv"))
    return {
        "nvidia_smi": card, "parameters": n_params, "state_bytes": nbytes,
        "losses": losses, "ref_loss": ref_loss, "resumed_loss": resumed_loss,
        "abs_err": err, "tol": 1e-3, "leaves_mismatched": mismatched,
        "drain_s": drain_s, "drain_split_s": drain_t,
        "drain_gb_per_s": nbytes / drain_s / 1e9,
        "left_world": left, "shutdown_s": shutdown_s, "initialize_s": init_s,
        "restore_s": restore_s, "restore_split_s": restore_t,
        "restore_gb_per_s": nbytes / restore_s / 1e9,
        "free_disk_bytes_before": free_before,
        "peak_device_memory_bytes": peak, "launches": counts,
        "kernels_ran": ran,
        "ok": bool(not mismatched and math.isfinite(resumed_loss)
                   and err <= 1e-3 and ran and left)}


def legacy_cycle_toy() -> dict:
    """The legacy single-file ``drain_restore_cycle`` on the probe's toy
    config, on the card."""
    from gpumounter_tpu_torch.torchcheck import drain, elastic, model, train

    device = torch.device("cuda", 0)
    cfg = model.ModelConfig()
    state = train.init_state(cfg, seed=0, device=device)
    step = train.make_train_step(cfg)
    tokens = train.make_batch(torch.Generator(device).manual_seed(1), 4, 64,
                              cfg.vocab)
    for _ in range(3):
        state, _ = step(state, tokens)
    tree = train.state_tree(state)
    t0 = time.perf_counter()
    restored = drain.drain_restore_cycle(tree, elastic.state_specs(cfg),
                                         device=device)
    cycle_s = time.perf_counter() - t0
    same = all(int(got) == want if isinstance(want, int)
               else torch.equal(got.cpu(), want.cpu())
               for _, got, want in _tree_pairs(restored, tree))
    _, ref_loss = step(state, tokens)
    again = train.state_from_tree(cfg, restored, device)
    _, loss = step(again, tokens)
    err = abs(float(loss) - float(ref_loss))
    return {"cycle_s": cycle_s, "bitwise": same, "abs_err": err,
            "ok": bool(same and err <= 1e-3)}


def federation_member(index: int, cards: str, base: str, group: str,
                      root: str, status_path: str, stop_path: str) -> None:
    """One member pod process of part (b), ``default/workload-<index>``:
    the flagship config on the Megatron split (the model dim absorbs the
    world), the flash step, one rank per card of ``cards`` (``cuda:i[,j]``,
    named explicitly: the slice's hosts are fixture nodes). CUDA-free
    itself."""
    import faulthandler
    faulthandler.enable()           # a native crash prints its stacks
    sys.path.insert(0, REPO)
    from gpumounter_tpu_torch.torchcheck import federation, perf, train

    runner = federation.MemberRunner(
        base, group, f"default/workload-{index}", root,
        local_devices=cards.count(",") + 1, device=cards,
        status_path=status_path, stop_path=stop_path,
        barrier_timeout_s=300.0, lr=3e-4, seq_len=1024, batch=8,
        cfg=perf.mxu_config(), data=1, seq=1, model=None,
        step_factory=functools.partial(train.make_train_step,
                                       attn_impl="flash"))
    sys.exit(runner.run())


# How long part (b) waits for each stage of the ride (the members' steps
# in a generation, a resized-out member's exit).
RESIZE_WAIT_S = 240.0


def _post_json(url: str, obj: dict) -> tuple[int, dict]:
    from gpumounter_tpu_torch.testing.master_attach import _http
    return _http("POST", url, json.dumps(obj).encode())


def refederate_cards(count: int, card: str) -> dict:
    """Part (b) of the elastic phase: member pod processes ride resizes
    1 -> 2 -> 1 members at full width over NCCL, against the port's own
    master (``testing/sim.py`` ``MultiNodeStack``: its ``/addgpuslice``,
    ``/slicez``, ``/slice/barrier`` and ``POST /slice/resize``, over two
    fixture GKE GPU hosts whose allocatable ``nvidia.com/gpu`` is the cards
    per member): members of two cards each on four or more cards (worlds
    of 2 -> 4 -> 2 GPUs), of one card each on two or three (1 -> 2 -> 1)."""
    from gpumounter_tpu_torch.testing.elastic_attach import read_records
    from gpumounter_tpu_torch.testing.sim import MultiNodeStack
    from gpumounter_tpu_torch.utils.config import HostPaths

    per = 2 if count >= 4 else 1
    small, large = 1, 2
    root = os.path.join(ELASTIC_DIR, "federation")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free_before = shutil.disk_usage(root).free
    hosts = []
    for i in range(large):
        base = os.path.join(root, "hosts", f"node{i}")
        for sub in ("dev", "proc", "sys/fs/cgroup"):
            os.makedirs(os.path.join(base, sub))
        hosts.append(HostPaths(
            dev_root=os.path.join(base, "dev"),
            proc_root=os.path.join(base, "proc"),
            sys_root=os.path.join(base, "sys"),
            cgroup_root=os.path.join(base, "sys", "fs", "cgroup")))
    stack = MultiNodeStack(hosts, n_chips=per)

    def target(n):
        return {"pods": [{"namespace": "default", "pod": f"workload-{i}"}
                         for i in range(n)], "gpusPerHost": per}

    ctx = multiprocessing.get_context("spawn")
    procs: dict[int, multiprocessing.Process] = {}
    status = {i: os.path.join(root, f"member-{i}.jsonl")
              for i in range(large)}
    stop = os.path.join(root, "stop")
    answers: list = []

    def spawn(i):
        cards = ",".join(str(i * per + j) for j in range(per))
        procs[i] = ctx.Process(target=federation_member, args=(
            i, f"cuda:{cards}", stack.base, group, root, status[i], stop))
        procs[i].start()

    def steps(i, generation):
        return [r for r in read_records(status[i]) if r["phase"] == "step"
                and r["generation"] == generation]

    def wait_for(what, predicate):
        deadline = time.monotonic() + RESIZE_WAIT_S
        while not predicate():
            dead = {i: p.exitcode for i, p in procs.items()
                    if p.exitcode not in (None, 0)}
            if dead:
                raise RuntimeError(f"member(s) failed while waiting for "
                                   f"{what}, exit codes {dead}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {what} within {RESIZE_WAIT_S:.0f}s")
            time.sleep(0.5)

    def resize(n):
        code, body = _post_json(f"{stack.base}/slice/resize", target(n))
        answers.append({"status": code, "generation": body.get("generation")
                        if isinstance(body, dict) else None})
        if code != 200:
            raise RuntimeError(f"/slice/resize to {n} answered {code}: "
                               f"{body}")

    try:
        code, body = _post_json(f"{stack.base}/addgpuslice", target(small))
        if code != 200:
            raise RuntimeError(f"/addgpuslice answered {code}: {body}")
        group = body["group"]
        for i in range(small):
            spawn(i)
        wait_for("generation-1 steps", lambda: len(steps(0, 1)) >= 2)
        resize(large)
        for i in range(small, large):
            spawn(i)
        wait_for("generation-2 steps", lambda: len(steps(0, 2)) >= 2
                 and len(steps(large - 1, 2)) >= 1)
        resize(small)
        wait_for("generation-3 steps", lambda: len(steps(0, 3)) >= 2)
        resized_out = {}
        for i in range(small, large):
            procs[i].join(timeout=RESIZE_WAIT_S)
            resized_out[i] = procs[i].exitcode
        with open(stop, "w") as f:
            f.write("1")
        for i in range(small):
            procs[i].join(timeout=RESIZE_WAIT_S)
        exits = {i: p.exitcode for i, p in procs.items()}
        slave_pods = [len(rig.sim.slave_pods()) for rig in stack.rigs]
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        stack.close()

    records = read_records(status[0])
    step_rows = [r for r in records if r["phase"] == "step"]
    numbers = [r["step"] for r in step_rows]
    worlds = {r["generation"]: r["world_devices"] for r in step_rows}
    begins = [r for r in records if r["phase"] == "reshape_begin"]
    dones = [r for r in records if r["phase"] == "reshape_done"]
    transitions = []
    for begin, done in zip(begins, dones):
        first = next((r for r in step_rows
                      if r["generation"] == done["generation"]), None)
        transitions.append({
            "generation": done["generation"],
            "world": done["world_devices"],
            "fingerprint_before": begin["fingerprint"],
            "fingerprint_after": done["fingerprint"],
            "downtime_s": (first["unix"] - begin["unix"]) if first else None,
            "downtime_parts_s": done.get("downtime_s"),
            "member0_timings_s": done.get("timings")})
    losses = [r["loss"] for r in step_rows]
    checks = {
        "resizes_answered_by_the_ports_master":
            [a["generation"] for a in answers] == [2, 3],
        "steps_strictly_increase": numbers == sorted(set(numbers))
        and len(numbers) >= 6,
        "worlds": worlds == {1: small * per, 2: large * per,
                             3: small * per},
        "fingerprints_preserved": len(transitions) == 2 and all(
            t["fingerprint_before"] == t["fingerprint_after"]
            for t in transitions),
        "loss_goes_down": len(losses) >= 4
        and sum(losses[-2:]) < sum(losses[:2]),
        "resized_out_exit_0": all(code == 0 for code in resized_out.values())
        and all(any(r["phase"] == "resized_out"
                    for r in read_records(status[i])) for i in resized_out),
        "all_exit_0": all(code == 0 for code in exits.values()),
        "slave_pods_follow_the_slice": slave_pods == [1] + [0] * (large - 1)}
    shutil.rmtree(root, ignore_errors=True)
    return {"nvidia_smi": card, "resizes": [small, large, small],
            "cards_per_member": per, "master": "gpumounter_tpu_torch",
            "resize_answers": answers,
            "free_disk_bytes_before": free_before, "steps": numbers,
            "losses": losses, "worlds": worlds, "transitions": transitions,
            "exit_codes": exits, "slave_pods": slave_pods, "checks": checks,
            "ok": all(checks.values())}


def ride_attached(card: str, grow: bool) -> dict:
    """Part (c) of the elastic phase (``testing/elastic_attach.py``): the
    Pod's CUDA-free pod process waits for its first GPU, the port's master
    attaches the card (``GET /addgpu``) and the worker's own stamp starts a
    world of one rank at full width (the flagship state, the flash step);
    ``/removegpu`` is refused while it rides; then the bump — with
    ``grow``, a second ``/addgpu`` (a world of two ranks on both attached
    cards), else the worker's own ``_stamp_mesh_generation`` of the same
    card; the respawned world restores every leaf bitwise; the detach after
    the stop. Every attached UUID must be one nvidia-smi names."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.elastic_attach import (
        Ride, run_elastic_attach)
    from gpumounter_tpu_torch.torchcheck import perf
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    # a world of two on the Megatron split against the one rank's
    # uninterrupted step: bf16 partial sums in another order
    ride = Ride("cuda", perf.mxu_config(), batch=8, seq_len=1024,
                attn_impl="flash", tol=1e-2 if grow else 1e-3)
    report = run_elastic_attach(
        os.path.join(ELASTIC_DIR, "grow" if grow else "respawn"),
        PyEnumerator(HostPaths()), ride, grow=grow)
    checks = report["checks"]
    checks["cards_are_nvidia_smi_uuids"] = bool(report.get("uuids")) and all(
        u in smi_uuids for u in report["uuids"])
    emit("attach_to_first_step", nvidia_smi=card, grow=grow,
         parts_s=report.get("attach_to_first_step_s"),
         total_s=report.get("attach_to_first_step_total_s"),
         respawn_parts_s=report.get("downtime_parts_s"))
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


# The selftest's own limit: its nine checks take a few minutes on one H100.
SELFTEST_TIMEOUT_S = 600.0


def selftest_headline(name: str, r: dict) -> dict:
    """The numbers of one selftest check worth a line of their own."""
    head = {"ok": r.get("ok"), "seconds": r.get("seconds")}
    if "error" in r:
        return {**head, "error": r["error"]}
    if name == "collectives":
        head.update(n_devices=r.get("n_devices"),
                    degenerate=r.get("degenerate_single_device"))
    elif name == "training":
        head.update(step_ms=r.get("step_ms"), first_loss=r.get("first_loss"),
                    final_loss=r.get("final_loss"))
    elif name == "perf":
        head.update(
            primary={k: r.get(k) for k in ("train_step_ms", "mfu")},
            full_attention={k: r.get("xla_attention", {}).get(k)
                            for k in ("train_step_ms", "mfu", "error")},
            tuned={k: r.get("tuned", {}).get(k)
                   for k in ("train_step_ms", "mfu", "error")})
    elif name == "pallas_parity":
        head.update({k: r.get(k) for k in (
            "err_pallas_vs_oracle", "err_einsum_vs_oracle",
            "err_pallas_vs_einsum", "tol")})
    elif name == "attention_kernels":
        head["rows"] = r.get("rows")
    elif name == "long_context":
        head["flash"] = [{"seq": row["seq"], "batch": row["batch"],
                          **{k: row["flash"].get(k) for k in (
                              "train_step_ms", "mfu", "ok", "error")}}
                         for row in r.get("rows", [])]
        head["full_attention"] = r.get("xla_full_attention")
    elif name == "roofline":
        head.update({k: r.get(k) for k in (
            "measured_step_ms", "measured_mfu", "matmul_pred_ms",
            "matmul_ceiling_mfu", "identity_step_ms", "attention_core_ms",
            "optimizer_ms", "remainder_ms", "explained_fraction")})
        head["gemm_eff"] = {g: v.get("eff") for g, v in
                            r.get("gemms", {}).items()}
    elif name == "drain_cycle":
        head.update(abs_err=r.get("abs_err"),
                    drain_restore_s=r.get("drain_restore_s"))
    elif name == "backend_reinit":
        head.update(cycles=r.get("cycles"),
                    reinit_s_per_cycle=r.get("reinit_s_per_cycle"),
                    devices_reenumerated=r.get("devices_reenumerated"))
    return head


def device_layer(probe) -> dict:
    """The device layer on this machine's real /dev and /proc, held
    against nvidia-smi by UUID and PCI address."""
    from gpumounter_tpu_torch.device import enumerator as en
    from gpumounter_tpu_torch.device import native_enumerator as ne
    from gpumounter_tpu_torch.utils import consts
    from gpumounter_tpu_torch.utils.config import HostPaths

    build = subprocess.run(
        ["make", "-C", os.path.join(REPO, "gpumounter_tpu_torch", "native")],
        capture_output=True, text=True, timeout=300)
    if build.returncode != 0:
        return {"native_build": build.stdout[-1000:] + build.stderr[-1000:],
                "ok": False}
    host = HostPaths()
    py, native = en.PyEnumerator(host), ne.NativeEnumerator(host)
    found = {"python": py.enumerate(), "native": native.enumerate()}

    def shape(devices):
        return [(d.index, d.device_path, d.major, d.minor, d.uuid,
                 d.pci_address, [(c.host_path, c.major, c.minor)
                                 for c in d.companions]) for d in devices]

    smi = []
    for line in nvidia_smi("index,uuid,pci.bus_id").splitlines():
        index, uuid, bus = (x.strip() for x in line.split(","))
        # a machine may hide the card's PCI address: nvidia-smi then says
        # "[N/A]", and the node must carry none either ("")
        known = bool(bus) and not bus.startswith("[")
        smi.append({"index": int(index), "uuid": uuid,
                    "pci": en.normalize_pci_address(bus) if known else ""})
    by_uuid = {d.uuid: d for d in found["python"] if d.uuid}
    majors = en.read_proc_devices(host.proc_root)
    pid = os.getpid()
    cards = []
    for card in smi:
        dev = by_uuid.get(card["uuid"])
        row = {**card, "node": dev.device_path if dev else None}
        if dev is not None:
            row.update(
                major=dev.major, minor=dev.minor, node_pci=dev.pci_address,
                major_195=dev.major == consts.NVIDIA_MAJOR,
                pci_equal=dev.pci_address == card["pci"],
                busy_python=py.device_open_pids([pid], [dev.device_path]),
                busy_native=native.device_open_pids([pid],
                                                    [dev.device_path]))
            row["own_pid_busy"] = (row["busy_python"] == [pid]
                                   == row["busy_native"])
        cards.append(row)
    companions = {os.path.basename(c.host_path): (c.major, c.minor)
                  for c in (found["python"][0].companions
                            if found["python"] else ())}
    uvm = majors.get(consts.NVIDIA_UVM_PROC_DEVICES_NAME)
    pin = probe.configure_visible_chips(env={})
    by_minor = sorted((by_uuid[c["uuid"]].minor, c["uuid"]) for c in smi
                      if c["uuid"] in by_uuid)
    checks = {
        "python_equals_native": shape(found["python"])
        == shape(found["native"]),
        "uuid_source_equal": py.uuid_source == native.uuid_source,
        "every_card_matched": bool(smi) and all(c["node"] for c in cards),
        "major_195": all(c.get("major_195") for c in cards),
        "pci_equal": all(c.get("pci_equal") for c in cards),
        "own_pid_busy": all(c.get("own_pid_busy") for c in cards),
        "nvidiactl": companions.get(consts.NVIDIA_CTL_NAME)
        == (consts.NVIDIA_MAJOR, consts.NVIDIA_CTL_MINOR),
        "nvidia_uvm_major": uvm is not None
        and companions.get(consts.NVIDIA_UVM_NAME, (None,))[0] == uvm,
        "pin_is_the_cards": pin == ",".join(u for _, u in by_minor)}
    return {"uuid_source": py.uuid_source, "nvidia_smi": smi,
            "pci_known": all(c["pci"] for c in smi),
            "nodes": shape(found["python"]), "cards": cards,
            "companions": companions,
            "proc_devices": {k: v for k, v in majors.items()
                             if k.startswith("nvidia")},
            "configure_visible_chips": pin, "checks": checks,
            "ok": all(checks.values())}


# The node_attach phase's fixture tree: under the checkout's build directory
# (not committed), removed when the phase ends. Its filesystem may refuse
# mknod(2), so the container's nodes are fake (``.majmin`` sidecars).
NODE_ATTACH_DIR = os.path.join(REPO, "build", "node_attach")
NODE_ATTACH_CYCLES = 20
# An id no node has: the collector must log it and skip it.
ABSENT_UUID = "GPU-00000000-0000-0000-0000-000000000000"
# A child that holds a CUDA context on the card until its stdin closes.
CUDA_HOLDER = ("import sys, torch; torch.zeros(1, device='cuda'); "
               "torch.cuda.synchronize(); print('ready', flush=True); "
               "sys.stdin.read()")
IDLE_HOLDER = "import sys; sys.stdin.read()"


def _ms_stats(values: list[float]) -> dict:
    ordered = sorted(values)
    return {"median": ordered[len(ordered) // 2], "min": ordered[0],
            "max": ordered[-1], "n": len(ordered)}


def node_attach(card: str) -> dict:
    """The node half of an attach on this machine's real device layer:
    the collector maps a kubelet listing of the card's UUID to its node,
    the mounter grants it and its companions through the v1 device gate of
    a fixture container and makes the nodes there, a child holding a CUDA
    context on the card makes the detach refuse, and after it exits the
    detach completes; then the same cycle timed, and the BPF codegen."""
    import logging

    from gpumounter_tpu_torch.actuation import bpf
    from gpumounter_tpu_torch.collector.collector import GPUCollector
    from gpumounter_tpu_torch.collector.podresources import \
        FakePodResourcesClient
    from gpumounter_tpu_torch.device import enumerator as en
    from gpumounter_tpu_torch.testing.node_fixture import FixtureNode
    from gpumounter_tpu_torch.utils import consts
    from gpumounter_tpu_torch.utils.config import HostPaths
    from gpumounter_tpu_torch.utils.errors import DeviceBusyError

    native = os.path.join(REPO, "gpumounter_tpu_torch", "native")
    build = subprocess.run(["make", "-C", native], capture_output=True,
                           text=True, timeout=300)
    libs = {name: os.path.exists(os.path.join(native, "build", name))
            for name in ("libgpuprobe.so", "libbpfgate.so")}
    if build.returncode != 0 or not all(libs.values()):
        return {"native_build": build.stdout[-1000:] + build.stderr[-1000:],
                "libs": libs, "ok": False}
    checks: dict[str, bool] = {"native_libs_built": True}

    # 2-3: the collector over the real enumerator and a fake kubelet
    enum = en.PyEnumerator(HostPaths())
    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    warnings: list[str] = []

    class Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())
    catch = Catch(logging.WARNING)
    logging.getLogger("tpumounter.collector").addHandler(catch)
    kubelet = FakePodResourcesClient()
    slave = "workload-slave-pod-node-attach"
    try:
        cards = [d for d in enum.enumerate() if d.uuid in smi_uuids]
        kubelet.assign(consts.DEFAULT_POOL_NAMESPACE, slave,
                       [cards[0].uuid, ABSENT_UUID])
        collector = GPUCollector(enum, kubelet)
        gpus = collector.get_pod_gpu_resources_exact("workload", "default",
                                                     {slave})
    finally:
        logging.getLogger("tpumounter.collector").removeHandler(catch)
    gpu = cards[0]
    checks["collector_maps_uuid_to_node"] = [
        (g.uuid, g.major, g.minor, g.device_path) for g in gpus] == [
        (gpu.uuid, consts.NVIDIA_MAJOR, gpu.minor, gpu.device_path)]
    checks["unknown_id_logged_and_skipped"] = any(
        ABSENT_UUID in w for w in warnings)
    companions = {os.path.basename(c.host_path): (c.major, c.minor)
                  for c in gpu.companions}
    checks["three_companions"] = sorted(companions) == sorted(
        consts.NVIDIA_COMPANION_NAMES)
    host_rdev = {}
    for path in [gpu.device_path] + [c.host_path for c in gpu.companions]:
        st = os.stat(path)
        host_rdev[os.path.basename(path)] = (os.major(st.st_rdev),
                                             os.minor(st.st_rdev))
    granted = {(gpu.major, gpu.minor), *companions.values()}

    # 4-5: the mounter on a fixture container, busy detach, then detach
    shutil.rmtree(NODE_ATTACH_DIR, ignore_errors=True)
    procs: list[subprocess.Popen] = []

    def spawn(code: str) -> subprocess.Popen:
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        procs.append(proc)
        return proc

    report: dict = {}
    try:
        idle, idle_held = spawn(IDLE_HOLDER), spawn(IDLE_HOLDER)
        node = FixtureNode(NODE_ATTACH_DIR)
        box = node.container("workload", [idle.pid],
                             held=[("/dev/null", 1, 3)])
        mounter = node.mounter(enum, collector.plans)
        t0 = time.perf_counter()
        created = mounter.mount_chips(box.pod, gpus, gpus)
        first_mount_ms = (time.perf_counter() - t0) * 1e3
        key = node.controller.container_dir(box.pod, box.container_id)

        def gate_pairs() -> set:
            live, _opens, _denies = node.gate.backend.read(key)
            return {(k[1], k[2]) for k in live}

        expect_nodes = {os.path.basename(gpu.device_path): host_rdev[
            os.path.basename(gpu.device_path)], **{
            name: host_rdev[name] for name in companions}, "null": (1, 3)}
        allow = box.cgroup_lines("devices.allow")
        checks["gate_holds_gpu_and_companions"] = (
            gate_pairs() == granted
            and sorted(allow) == sorted(f"c {a}:{b} rw" for a, b in granted))
        checks["nodes_match_host_rdev"] = (created == 4
                                           and box.nodes() == expect_nodes)

        holder = spawn(CUDA_HOLDER)
        # a child stuck in CUDA's init must not hang the script
        ready = (bool(select.select([holder.stdout], [], [], 300)[0])
                 and holder.stdout.readline().strip() == "ready")
        box.set_pids([idle.pid, holder.pid])
        busy_pids = mounter.pod_device_processes(box.pod, gpu)
        try:
            mounter.unmount_chips(box.pod, gpus, [])
            refused = None
        except DeviceBusyError as e:
            refused = e.pids
        checks["busy_detach_refused"] = (ready and busy_pids == [holder.pid]
                                         and refused == [holder.pid])
        checks["busy_detach_left_everything"] = (
            box.nodes() == expect_nodes and gate_pairs() == granted)
        holder.stdin.close()
        holder_rc = holder.wait(timeout=120)
        mounter.unmount_chips(box.pod, gpus, [])
        deny = box.cgroup_lines("devices.deny")
        checks["detach_completes_after_exit"] = (
            box.nodes() == {"null": (1, 3)} and gate_pairs() == set()
            and sorted(deny) == sorted(f"c {a}:{b} rw" for a, b in granted))

        # a container the runtime gave another GPU at creation keeps the
        # companions when the hot-attached card leaves (the other GPU's
        # minor is never the card's: the card may be /dev/nvidia0)
        other = 0 if gpu.minor else 1
        held = [(f"/dev/nvidia{other}", consts.NVIDIA_MAJOR, other)] + [
            (name, *majmin) for name, majmin in companions.items()]
        kept = node.container("workload-held", [idle_held.pid], held=held)
        mounter.mount_chips(kept.pod, gpus, gpus)
        mounter.unmount_chips(kept.pod, gpus, [])
        checks["held_companions_stay"] = (
            kept.nodes() == {os.path.basename(p): (a, b)
                             for p, a, b in held}
            and kept.cgroup_lines("devices.deny") == [
                f"c {gpu.major}:{gpu.minor} rw"])

        # 6: the same cycle, timed on the host clock (the absent id has
        # been checked; it leaves the listing)
        kubelet.assign(consts.DEFAULT_POOL_NAMESPACE, slave, [gpu.uuid])
        box.set_pids([idle.pid])
        times = {"update_status": [], "grant_mount": [],
                 "revoke_unmount": []}
        for _ in range(NODE_ATTACH_CYCLES):
            t0 = time.perf_counter()
            collector.update_status()
            t1 = time.perf_counter()
            mounter.mount_chips(box.pod, gpus, gpus)
            t2 = time.perf_counter()
            mounter.unmount_chips(box.pod, gpus, [])
            t3 = time.perf_counter()
            times["update_status"].append((t1 - t0) * 1e3)
            times["grant_mount"].append((t2 - t1) * 1e3)
            times["revoke_unmount"].append((t3 - t2) * 1e3)
        checks["cycles_end_clean"] = box.nodes() == {"null": (1, 3)}
        report.update(first_mount_ms=first_mount_ms, holder_rc=holder_rc,
                      busy_pids=busy_pids,
                      ms={k: _ms_stats(v) for k, v in times.items()})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(NODE_ATTACH_DIR, ignore_errors=True)

    # 7: the BPF program for this card, and whether the kernel loads one
    lib = bpf.BpfGate()
    program = lib.build_program(bpf.rules_for_chips(gpus))
    return {"nvidia_smi": card, "uuid_source": enum.uuid_source,
            "card": {"uuid": gpu.uuid, "node": gpu.device_path,
                     "majmin": [gpu.major, gpu.minor]},
            "companions": companions,
            "unidentified": [d.device_path for d in collector.unidentified],
            "gate_backend": node.gate.backend.name,
            "nodes": "fake (.majmin sidecars)",
            "bpf_program_insns": len(program),
            "bpf_supported": lib.supported(), **report,
            "checks": checks, "ok": all(checks.values())}


# The worker_attach phase's fixture tree, beside node_attach's.
WORKER_ATTACH_DIR = os.path.join(REPO, "build", "worker_attach")


def worker_attach(card: str) -> dict:
    """The worker half of an attach on this machine's real device layer,
    over real sockets (``testing/worker_attach.py``): ``AddGPU`` over gRPC
    to the port's worker, a slave pod requesting ``nvidia.com/gpu`` in an
    HTTP apiserver facade, scheduled by a script that assigns the card's
    NVML UUID through a PodResources gRPC server, the listing mapped to
    ``/dev/nvidiaN``, the v1 gate and the nodes in a fixture container, a
    child holding a CUDA context making ``RemoveGPU`` answer ``GPUBusy``,
    the detach after it exits, then 20 timed attach/detach pairs with the
    apiserver requests of each. The resident agent must not fall back."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.worker_attach import (
        cuda_holder, run_worker_attach)
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_worker_attach(WORKER_ATTACH_DIR, PyEnumerator(HostPaths()),
                               cuda_holder)
    checks = report["checks"]
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


MASTER_ATTACH_DIR = os.path.join(REPO, "build", "master_attach")


def master_attach(card: str) -> dict:
    """The control-plane half of an attach over HTTP on this machine's real
    device layer, with the in-pod proof on the attached card
    (``testing/master_attach.py``). The returned UUID must be one
    nvidia-smi names."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.master_attach import (
        cuda_proof, run_master_attach)
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_master_attach(MASTER_ATTACH_DIR, PyEnumerator(HostPaths()),
                               cuda_proof)
    checks = report["checks"]
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


SLICE_ATTACH_DIR = os.path.join(REPO, "build", "slice_attach")


def slice_attach(card: str) -> dict:
    """A four-host slice through the port's master: host 0 on this
    machine's real device layer with the in-pod proof on its card, hosts
    1-3 fixture GPU nodes (``testing/slice_attach.py``). Host 0's UUID must
    be one nvidia-smi names."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.master_attach import cuda_proof
    from gpumounter_tpu_torch.testing.slice_attach import run_slice_attach
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_slice_attach(SLICE_ATTACH_DIR, PyEnumerator(HostPaths()),
                              cuda_proof)
    checks = report["checks"]
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


HA_ATTACH_DIR = os.path.join(REPO, "build", "ha_attach")


def ha_attach(card: str) -> dict:
    """A leader fail-over through two of the port's masters with the HA
    plane on, on this machine's real device layer, with the in-pod proof
    on the attached card (``testing/ha_attach.py``). The card's UUID must
    be one nvidia-smi names."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.ha_attach import run_ha_attach
    from gpumounter_tpu_torch.testing.master_attach import cuda_proof
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_ha_attach(HA_ATTACH_DIR, PyEnumerator(HostPaths()),
                           cuda_proof)
    checks = report["checks"]
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


NODE_FAILURE_DIR = os.path.join(REPO, "build", "node_failure")


def node_failure(card: str) -> dict:
    """A member host of a live slice dies and the slice is repaired onto a
    spare pod on this machine's card, with the in-pod proof there
    (``testing/node_failure.py``). The card's UUID must be one nvidia-smi
    names."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.master_attach import cuda_proof
    from gpumounter_tpu_torch.testing.node_failure import run_node_failure
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_node_failure(NODE_FAILURE_DIR, PyEnumerator(HostPaths()),
                              cuda_proof)
    checks = report["checks"]
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


DEFRAG_DIR = os.path.join(REPO, "build", "defrag")


def defrag(card: str) -> dict:
    """A fragmented fleet consolidated onto this machine's card by the
    defragmenter, with the usage proof on the card beforehand and the
    in-pod proof on it after the move (``testing/defrag.py``). The card's
    UUID must be one nvidia-smi names."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.defrag import cuda_load, run_defrag
    from gpumounter_tpu_torch.testing.master_attach import cuda_proof
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_defrag(DEFRAG_DIR, PyEnumerator(HostPaths()), cuda_proof,
                        cuda_load)
    checks = report["checks"]
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


OPERATOR_DIR = os.path.join(REPO, "build", "operator")


def operator(card: str) -> dict:
    """gpumounterctl driving an attach of this machine's card through the
    port's master, with the in-pod proof on the card
    (``testing/operator.py``, run in its own interpreter). The card's UUID
    must be one nvidia-smi names."""
    from gpumounter_tpu_torch.testing.operator import run_in_subprocess

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_in_subprocess(OPERATOR_DIR)
    checks = report.get("checks", {})
    checks["card_is_an_nvidia_smi_uuid"] = (
        report.get("card", {}).get("uuid") in smi_uuids)
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": bool(report.get("ok")) and all(checks.values())}


WORKER_CHAOS_DIR = os.path.join(REPO, "build", "worker_chaos")
CHAOS_LIMIT_S = 60.0


def worker_chaos(card: str) -> dict:
    """A worker holding this machine's card crashed and replayed
    (``testing/worker_chaos.py``): the attach dies at each crash point and
    the restarted worker's replay completes it, the owner's death makes
    the replay revert, the detach dies mid-revoke and inside the v1 gate's
    sync, the transient plans run over the HTTP apiserver facade, and the
    in-pod proof launches ``flash_fwd`` on the card after the first replay
    and after the plans. The card's UUID must be one nvidia-smi names, and
    the phase must stay under a minute."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.master_attach import cuda_proof
    from gpumounter_tpu_torch.testing.worker_chaos import run_worker_chaos
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_worker_chaos(WORKER_CHAOS_DIR, PyEnumerator(HostPaths()),
                              cuda_proof)
    checks = report["checks"]
    uuid = report.get("card", {}).get("uuid")
    checks["card_is_an_nvidia_smi_uuid"] = uuid in smi_uuids
    checks["in_pod_pinned_to_the_card"] = all(
        report.get(label, {}).get("visible") == uuid
        for label in ("in_pod_after_replay", "in_pod_after_plans"))
    checks["phase_under_a_minute"] = report["phase_s"] < CHAOS_LIMIT_S
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


WORKER_SURFACE_DIR = os.path.join(REPO, "build", "worker_surface")
SURFACE_LIMIT_S = 60.0


def worker_surface(card: str) -> dict:
    """What the worker serves in a GPU cluster, on this machine's card
    (``testing/worker_surface.py``): mTLS dialed by IP, a Pod of two
    containers, a CUDA holder in the sidecar named by ``GPUStatus`` and
    the master's ``/gpustatus``, the forced detach, the in-pod proof from
    the sidecar, and a storm over mTLS within the leak thresholds and the
    request budgets, then mTLS pairs timed beside plaintext ones. The
    card's UUID must be one nvidia-smi names, and the phase must stay
    under a minute."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.testing.master_attach import cuda_proof
    from gpumounter_tpu_torch.testing.worker_attach import cuda_holder
    from gpumounter_tpu_torch.testing.worker_surface import \
        run_worker_surface
    from gpumounter_tpu_torch.utils.config import HostPaths

    smi_uuids = [u.strip() for u in nvidia_smi("uuid").splitlines()]
    report = run_worker_surface(WORKER_SURFACE_DIR,
                                PyEnumerator(HostPaths()), cuda_holder,
                                cuda_proof)
    checks = report["checks"]
    uuid = report.get("card", {}).get("uuid")
    checks["card_is_an_nvidia_smi_uuid"] = uuid in smi_uuids
    checks["in_pod_pinned_to_the_card"] = \
        report.get("in_pod", {}).get("visible") == uuid
    checks["phase_under_a_minute"] = report["phase_s"] < SURFACE_LIMIT_S
    return {"nvidia_smi": card, **report, "checks": checks,
            "ok": all(checks.values())}


BENCH_LIMIT_S = 90.0
# the full sizes are gpumounter_tpu_torch.bench's own run; the e2e and
# warm-pool cycles each wait the 1.0 s scheduler delay
BENCH_SIZES = dict(overhead=50, events_off=30, usage_off=30, topo_off=30,
                   parking=30, single=0, multi=10, e2e=5, pool=3,
                   contention=1, multimaster_window_s=2.5, sustained=550,
                   sustained_2k=0)
BENCH_CHILD = (
    "import json\n"
    "from gpumounter_tpu_torch import bench\n"
    "result, p50s = bench.run_control_plane(bench.Sizes(**{sizes!r}))\n"
    "print(json.dumps({{'result': result, 'main_bars': {{\n"
    "    name: held for name, held, _ in bench.bars(result, p50s)}}}}))\n")


def control_plane_bench(card: str) -> dict:
    """The port's control-plane bench at trimmed sizes
    (``bench.run_control_plane``), in its own interpreter, so that the
    earlier phases' attaches in the process registry are not in its
    readings: host-CPU figures on fixture GPUs. The
    ``measure_*`` functions' own selftests are the checks (a failed one
    fails the child), with a pool hit on every warm cycle, no LIST on the
    warm path, finite latencies and the phase under 90 s. The bars of the
    bench's ``main`` are reported, not held."""
    # what the earlier phases left running here: the threads alive, and
    # this process's CPU time over 2 s in which it does nothing itself
    alive = thread_names(t for t in threading.enumerate()
                         if t is not threading.current_thread())
    cpu0 = time.process_time()
    time.sleep(2.0)
    idle_cpu_share = (time.process_time() - cpu0) / 2.0
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", BENCH_CHILD.format(sizes=BENCH_SIZES)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    phase_s = time.perf_counter() - t0
    parent = {"threads_alive": alive, "idle_cpu_share": idle_cpu_share}
    if proc.returncode != 0:
        return {"rc": proc.returncode, "phase_s": phase_s, "parent": parent,
                "error": proc.stderr[-2000:], "ok": False}
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    result = child["result"]
    latencies = [v for k, v in result.items()
                 if k.endswith("_s") and isinstance(v, float)]
    checks = {
        "pool_hit_every_cycle": (result["pool_hits"] == BENCH_SIZES["pool"]
                                 and result["pool_misses"] == 0),
        "no_list_on_the_warm_path": result[
            "apiserver_round_trips_per_attach"].get("LIST/pods", 0) == 0,
        "latencies_finite": all(math.isfinite(v) and v >= 0
                                for v in latencies),
        "phase_under_90s": phase_s < BENCH_LIMIT_S,
    }
    return {"nvidia_smi": card, "sizes": BENCH_SIZES, "result": result,
            "main_bars": child["main_bars"], "phase_s": phase_s,
            "parent": parent,
            "checks": checks, "ok": all(checks.values())}


def definition_line(src: str, func: str) -> int | None:
    """The line of ``src`` (under csrc/) where device function ``func`` is
    defined: its name at the start of a line, followed by its parameters."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), CSRC,
                        src)
    with open(path) as f:
        for number, text in enumerate(f, 1):
            if re.match(rf"\s*{func}\(", text):
                return number
    return None


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gpumounter_tpu_torch import entry
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    from gpumounter_tpu_torch.torchcheck import flash_attention as fa
    from gpumounter_tpu_torch.torchcheck import kernels
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import perf, probe
    from gpumounter_tpu_torch.torchcheck import ring_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    rates = (perf.chip_peak_tflops(kind), perf.chip_hbm_tb_per_s(kind))
    failed: list[str] = []
    why: dict[str, list[str]] = {}      # phase -> its false checks or error
    kernel_rows: dict[str, dict] = {}
    launches: dict[str, dict] = {}

    def phase(name, fn):
        before = {t.ident for t in threading.enumerate()}
        t0 = time.perf_counter()
        try:
            report = fn()
        except Exception:
            traceback.print_exc()
            report = {"ok": False, "error": traceback.format_exc()[-2000:]}
        report["seconds"] = time.perf_counter() - t0
        # threads a phase leaves running in this process
        report["threads_left"] = thread_names(
            t for t in threading.enumerate() if t.ident not in before)
        if not report.get("ok"):
            failed.append(name)
            error = str(report.get("error", "")).strip().splitlines()
            checks = report.get("checks")
            why[name] = [k for k, v in (checks if isinstance(checks, dict)
                                        else {}).items()
                         if not v] or error[-1:] or ["not ok"]
        emit(name, **report)

    def environment():
        info = kernels.build()
        ptxas = {src: ptxas_summary(log) for src, log in info["ptxas"].items()}
        # the main path's wgmma kernels must not spill (the f32 CUDA-core
        # instances, for parity only, are reported and not held to it)
        wgmma = {name: r for summary in ptxas.values()
                 for name, r in summary.items() if "_wgmma_kernel<" in name}
        spilled = sorted(name for name, r in wgmma.items()
                         if r.get("spill_stores", 1) or r.get("spill_loads", 1))
        # the kernels' bounds need the card's published rates
        return {"nvidia_smi": card, "device": kind,
                "device_count": torch.cuda.device_count(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "peak_bf16_tflops": rates[0], "hbm_tb_per_s": rates[1],
                "kernel_build_s": info["seconds"], "built": info["built"],
                "ptxas": ptxas, "wgmma_spilled": spilled,
                "ok": None not in rates and bool(wgmma) and not spilled}

    def parity():
        small = parity_small(fa, kernels, ra)
        main_path, rows = parity_main_path(
            fa, kernels, tuple(r * 1e12 for r in rates))
        kernel_rows.update(rows)
        norm, rows = norm_kernels(kernels, model_lib,
                                  tuple(r * 1e12 for r in rates))
        kernel_rows.update(rows)
        return {"small": small, "main_path": main_path, "norm": norm,
                "ok": small["ok"] and main_path["ok"] and norm["ok"]}

    def probe_phase():
        # run_probe pins CUDA_VISIBLE_DEVICES (for this process's children);
        # the later phases keep the environment they started with, and the
        # pin itself is held against nvidia-smi in phase device_layer
        before = os.environ.get("CUDA_VISIBLE_DEVICES")
        try:
            report = probe.run_probe(device="cuda")
        finally:
            if before is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = before
        return {"report": report, "ok": report["ok"]}

    def flagship():
        report, counts = run_path(kernels, lambda profile: (
            perf.measure_train_perf(perf.mxu_config(), batch=8, t_len=1024,
                                    attn_impl="flash", profile=profile)))
        launches["flagship"] = counts
        ran = all(counts[n] > 0 for n in ("flash_fwd_whole_k", "flash_bwd_dq",
                                          "flash_bwd_dkdv"))
        return {"nvidia_smi": card,
                "clocks_power": nvidia_smi(
                    "clocks.sm,power.draw,power.limit,temperature.gpu"),
                "report": report, "launches": counts, "kernels_ran": ran,
                "ok": bool(report["ok"] and ran)}

    def long_context():
        # the seq-4096 row alone (the selftest runs all three rows)
        def row(profile):
            r = perf.measure_long_context_row(4096, 2, profile=profile)
            return {"config": r["config"], "rows": [
                {"seq": 4096, "batch": 2, "tokens_per_step": 8192,
                 "flash": r}], "ok": r["ok"]}

        report, counts = run_path(kernels, row)
        launches["long_context"] = counts
        ran = all(counts[n] > 0 for n in ("flash_fwd_kblocked",
                                          "flash_bwd_dq", "flash_bwd_dkdv"))
        return {"report": report, "launches": counts, "kernels_ran": ran,
                "ok": bool(report["ok"] and ran)}

    def parallel():
        count = torch.cuda.device_count()
        # (a) the entry points over NCCL, one process per card
        dryrun = entry.dryrun_multichip(count, device="cuda")
        training = probe.validate_training(device="cuda", n_devices=count)
        report = {}
        ring_ok = True
        if count > 1:     # the ring itself over NCCL at full width
            ranks = dist_lib.run_world(count, ring_rank, (3,), device="cuda")
            checks = Checks()
            for rank in ranks:
                for name, err in rank["errors"].items():
                    checks.add(f"rank{rank['rank']}_{name}", err, 1e-2)
            ring_ok = checks.ok and all(
                rank["launches"]["flash_fwd_whole_k"] == count
                for rank in ranks)
            report["nccl_ring"] = {"ranks": ranks, "checks": checks.results,
                                   "ok": ring_ok}
        # (b) the 4-rank ring replayed on this card, (c) its launches
        replay, row, counts = ring_replay(fa, kernels, ra, tuple(
            r * 1e12 for r in rates))
        kernel_rows["fwd_whole_k_ring"] = row
        launches["parallel"] = counts
        ran = counts["flash_fwd_whole_k"] > 0
        return {"n_devices": count,
                # one card: a world of one, no link crossed
                "degenerate_single_device": count == 1,
                "dryrun_multichip": dryrun, "validate_training": training,
                **report, "ring_replay": replay, "kernels_ran": ran,
                "ok": bool(training["ok"] and replay["ok"] and ran
                           and ring_ok)}

    def part(fn, *args) -> dict:
        """One part of a phase; a failure is reported in the part and
        fails the phase, and the other parts still run."""
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            return {"ok": False, "error": traceback.format_exc()[-2000:]}

    def elastic_phase():
        one_card = part(drain_restore_one_card, kernels, card)
        launches["elastic"] = one_card.get("launches", {})
        torch.cuda.empty_cache()
        legacy = part(legacy_cycle_toy)
        torch.cuda.empty_cache()
        count = torch.cuda.device_count()
        # one card: the respawn at the same width; two or more: the pod's
        # device set grows by a second attach
        respawn = part(ride_attached, card, count > 1)
        if count > 1:
            cards = part(refederate_cards, count, card)
        else:
            cards = {"degenerate": True, "ok": True,
                     "reason": "re-federation over NCCL needs two or more "
                               "cards; this machine has one"}
        return {"n_devices": count, "one_card": one_card,
                "legacy_cycle": legacy, "respawn": respawn,
                "multi_card": cards,
                "ok": bool(one_card["ok"] and legacy["ok"]
                           and respawn["ok"] and cards["ok"])}

    def selftest():
        from gpumounter_tpu_torch.torchcheck import gpu_selftest
        torch.cuda.empty_cache()
        rc, report, error = gpu_selftest.run_in_subprocess(
            timeout=SELFTEST_TIMEOUT_S)
        if report is None:
            return {"rc": rc, "error": error, "ok": False}
        for name in gpu_selftest.CHECKS:
            emit("selftest_check", check=name,
                 **selftest_headline(name, report.get(name, {})))
        return {"rc": rc, "nvidia_smi": card, "report": report,
                "checks_ok": {n: report.get(n, {}).get("ok")
                              for n in gpu_selftest.CHECKS},
                "ok": bool(rc == 0 and report["ok"])}

    phase("environment", environment)
    if failed:             # nothing can run without the kernels and rates
        return 1
    phase("parity", parity)
    phase("probe", probe_phase)
    phase("flagship", flagship)
    torch.cuda.empty_cache()
    phase("long_context", long_context)
    torch.cuda.empty_cache()
    phase("parallel", parallel)
    torch.cuda.empty_cache()
    phase("elastic", elastic_phase)
    torch.cuda.empty_cache()
    phase("selftest", selftest)
    phase("device_layer", lambda: device_layer(probe))
    phase("node_attach", lambda: node_attach(card))
    phase("worker_attach", lambda: worker_attach(card))
    phase("master_attach", lambda: master_attach(card))
    phase("slice_attach", lambda: slice_attach(card))
    phase("ha_attach", lambda: ha_attach(card))
    phase("node_failure", lambda: node_failure(card))
    phase("defrag", lambda: defrag(card))
    phase("operator", lambda: operator(card))
    phase("chaos", lambda: worker_chaos(card))
    phase("worker_surface", lambda: worker_surface(card))
    phase("control_plane_bench", lambda: control_plane_bench(card))

    fwd = ("flash_fwd.cu", "flash_fwd_wgmma_kernel")
    dq = ("flash_bwd.cu", "flash_bwd_dq_wgmma_kernel")
    dkdv = ("flash_bwd.cu", "flash_bwd_dkdv_wgmma_kernel")
    entries = (
        ("flash_fwd (whole-K contract)", fwd, 60, "fwd_whole_k",
         "flagship", "flash_fwd_whole_k"),
        ("flash_fwd (K-blocked contract)", fwd, 273, "fwd_kblocked",
         "long_context", "flash_fwd_kblocked"),
        ("flash_bwd_dq (flagship)", dq, 332, "bwd_dq_flagship", "flagship",
         "flash_bwd_dq"),
        ("flash_bwd_dkdv (flagship)", dkdv, 368, "bwd_dkdv_flagship",
         "flagship", "flash_bwd_dkdv"),
        ("flash_bwd_dq (long context)", dq, 332, "bwd_dq_long_context",
         "long_context", "flash_bwd_dq"),
        ("flash_bwd_dkdv (long context)", dkdv, 368,
         "bwd_dkdv_long_context", "long_context", "flash_bwd_dkdv"),
        ("flash_fwd (whole-K, ring offsets)", fwd, 60, "fwd_whole_k_ring",
         "parallel", "flash_fwd_whole_k"),
        ("rmsnorm_fwd", ("rmsnorm.cu", "rmsnorm_fwd_kernel"), None,
         "rmsnorm_fwd", "flagship", "rmsnorm_fwd"),
        ("rmsnorm_bwd + rmsnorm_dg", ("rmsnorm.cu", "rmsnorm_bwd_kernel"),
         None, "rmsnorm_bwd", "flagship", "rmsnorm_bwd"),
    )
    line = []
    for name, (src, func), pallas_line, row_key, path, counter in entries:
        row = kernel_rows.get(row_key, {})
        count = launches.get(path, {}).get(counter, 0)
        if count == 0 and "kernels" not in failed:
            failed.append("kernels")
            why["kernels"] = ["a kernel of the main path never launched"]
        line.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "kernel": func, "source_line": definition_line(src, func),
            "replaces": pallas_line and f"{PALLAS}:{pallas_line}",
            "launches": count,
            "path": path,
            **{key: row.get(key) for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "dtype")},
            **({"unit": row["unit"]} if "unit" in row else {})})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"total_seconds": time.perf_counter() - t_start}),
          flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}; why: {why}",
              file=sys.stderr)
        print(json.dumps({"ok": False, "failed": failed}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
