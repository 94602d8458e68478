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
  7. the kernels line (each entry names the device function and the line
     of its definition), the card line, and the device line.

Tolerances: f32 1e-4 (CUDA-core f32 in the kernels, TF32 off in the plain
versions); bf16 1e-2 on the normalised output and on gradients' relative
Frobenius error, 1e-3 on m and lse. Exits non-zero, without the device
line, when there is no GPU, when the package is missing, or when any phase
failed.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import torch

PALLAS = "gpumounter_tpu/jaxcheck/pallas_attention.py"
CSRC = "gpumounter_tpu_torch/torchcheck/csrc"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gpumounter_tpu_torch import entry
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    from gpumounter_tpu_torch.torchcheck import flash_attention as fa
    from gpumounter_tpu_torch.torchcheck import kernels
    from gpumounter_tpu_torch.torchcheck import perf, probe
    from gpumounter_tpu_torch.torchcheck import ring_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    rates = (perf.chip_peak_tflops(kind), perf.chip_hbm_tb_per_s(kind))
    failed: list[str] = []
    kernel_rows: dict[str, dict] = {}
    launches: dict[str, dict] = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            report = fn()
        except Exception:
            traceback.print_exc()
            report = {"ok": False, "error": traceback.format_exc()[-2000:]}
        report["seconds"] = time.perf_counter() - t0
        if not report.get("ok"):
            failed.append(name)
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
        return {"small": small, "main_path": main_path,
                "ok": small["ok"] and main_path["ok"]}

    def probe_phase():
        report = probe.run_probe(device="cuda")
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
        report, counts = run_path(kernels, perf.measure_long_context)
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
    )
    line = []
    for name, (src, func), pallas_line, row_key, path, counter in entries:
        row = kernel_rows.get(row_key, {})
        count = launches.get(path, {}).get(counter, 0)
        if count == 0 and "kernels" not in failed:
            failed.append("kernels")
        line.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "kernel": func, "source_line": definition_line(src, func),
            "replaces": f"{PALLAS}:{pallas_line}", "launches": count,
            "path": path,
            **{key: row.get(key) for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "dtype")},
            **({"unit": row["unit"]} if "unit" in row else {})})
    print(json.dumps({"kernels": line}), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
