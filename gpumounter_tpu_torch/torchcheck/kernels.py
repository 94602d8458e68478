"""Build, load and launch the hand-written Hopper kernels.

The CUDA sources under ``csrc/`` compile with ``nvcc`` into one shared
library per source, with a plain C interface bound through ``ctypes``. The
build happens at first use, into ``build/torch_kernels/`` of the checkout,
keyed on a hash of the sources and flags; the sources build in parallel,
one ``nvcc`` each. Nothing is built or imported when this module is
imported, so it loads on a machine with no CUDA toolkit.

Each wrapper checks device, dtype, contiguity and shape and raises on what
its kernel does not take, allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream and raises if the launch returned a
CUDA error. A wrapper adds one to its entry of :data:`LAUNCHES` for every
launch, and nowhere else, so a run can show that its path went through the
kernels. The wrappers take CUDA tensors only: the plain PyTorch version of
each kernel, for CPU tensors, lives beside its caller in
:mod:`.flash_attention`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
HEADERS = ("flash_common.cuh", "hopper_common.cuh")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900

# Launches per kernel (and per contract of flash_fwd) since the last reset.
LAUNCHES: dict[str, int] = {"flash_fwd_whole_k": 0, "flash_fwd_kblocked": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkdv": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}   # csrc DType enum
_HEAD_DIMS = (64, 128)
SEQ_MULTIPLE = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, pv, m, l, bh, tq, tk, d, q_offset, k_offset, scale,
    # skip_tq, skip_tk, dtype, stream
    "flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # q, k, v, do, lse, drow, dq, bh, t, d, scale, dtype, stream
    "flash_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, do, lse, drow, dk, dv, bh, t, d, scale, dtype, stream
    "flash_bwd_dkdv": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
}

_lock = threading.Lock()
_funcs: dict[str, ctypes._CFuncPtr] = {}
BUILD_INFO: dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found on PATH or at {found}; the CUDA "
                           "kernels need the CUDA toolkit to build")
    return found


def _library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, object]:
    """Build (where the hash-keyed library is missing) and load every
    kernel library. Returns what was built, the seconds it took and the
    ptxas report (registers, shared memory, spills) of each source."""
    with _lock:
        if _funcs:
            return BUILD_INFO
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {src: _library_path(src) for src in SOURCES}
        pending = {src: p for src, p in paths.items() if not p.exists()}
        procs = {}
        for src, path in pending.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, (tmp, proc) in procs.items():
            try:
                out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, paths[src])
                paths[src].with_suffix(".log").write_text(out)
            else:
                failed.append(f"{src} (rc={proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        funcs = {}
        for path in paths.values():
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    funcs[name] = fn
        missing = set(_SIGNATURES) - set(funcs)
        if missing:
            raise RuntimeError(f"kernel libraries lack {sorted(missing)}")
        logs = {src: paths[src].with_suffix(".log") for src in SOURCES}
        BUILD_INFO.update(
            built=sorted(pending), seconds=time.perf_counter() - t0,
            libraries={src: str(p) for src, p in paths.items()},
            ptxas={src: log.read_text() if log.exists() else ""
                   for src, log in logs.items()})
        _funcs.update(funcs)
        return BUILD_INFO


def _check(name: str, tensors: dict[str, torch.Tensor],
           shapes: dict[str, tuple[int, ...]], dtypes: dict[str, object]):
    """Raise ValueError unless every tensor is a contiguous, 16-byte aligned
    CUDA tensor on one device with its expected shape and dtype."""
    device = None
    for key, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got "
                             f"{x.device}")
        if device is None:
            device = x.device
        elif x.device != device:
            raise ValueError(f"{name}: {key} on {x.device}, expected {device}")
        if tuple(x.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"expected {shapes[key]}")
        if x.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} has dtype {x.dtype}, expected "
                             f"{dtypes[key]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if x.data_ptr() % 16:     # TMA and 16-byte vector loads
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    return device


def _check_dims(name: str, dtype, d: int, *lengths: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         "(bfloat16 or float32)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported {_HEAD_DIMS}")
    for t in lengths:
        if t <= 0 or t % SEQ_MULTIPLE:
            raise ValueError(f"{name}: sequence length {t} is not a "
                             f"positive multiple of {SEQ_MULTIPLE}")


def _launch(name: str, device: torch.device, *args) -> None:
    build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _funcs[name](*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _int32(name: str, what: str, value) -> int:
    value = int(value)
    if not -2**31 <= value < 2**31:
        raise ValueError(f"{name}: {what} {value} does not fit in int32")
    return value


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: int, k_offset: int, scale: float,
              skip_tq: int = 0, skip_tk: int = 0):
    """Causal flash statistics (pv [BH,TQ,D], m and l [BH,1,TQ], all f32)
    of q [BH,TQ,D] against k, v [BH,TK,D]. ``skip_tq == 0`` is the whole-K
    contract; otherwise (skip_tq, skip_tk) are the K-blocked contract's
    (q tile, k block), whose strictly-future blocks are skipped."""
    name = "flash_fwd"
    bh, tq, d = q.shape
    tk = k.shape[1]
    device = _check(name, {"q": q, "k": k, "v": v},
                    {"q": (bh, tq, d), "k": (bh, tk, d), "v": (bh, tk, d)},
                    {"q": q.dtype, "k": q.dtype, "v": q.dtype})
    _check_dims(name, q.dtype, d, tq, tk)
    if (skip_tq == 0) != (skip_tk == 0):
        raise ValueError(f"{name}: skip_tq and skip_tk are both 0 or both set")
    if skip_tq and (skip_tq % SEQ_MULTIPLE or tq % skip_tq
                    or skip_tk % SEQ_MULTIPLE or tk % skip_tk):
        raise ValueError(f"{name}: skip tiles ({skip_tq}, {skip_tk}) must be "
                         f"multiples of {SEQ_MULTIPLE} dividing ({tq}, {tk})")
    q_offset = _int32(name, "q_offset", q_offset)
    k_offset = _int32(name, "k_offset", k_offset)
    pv = torch.empty((bh, tq, d), dtype=torch.float32, device=device)
    m = torch.empty((bh, 1, tq), dtype=torch.float32, device=device)
    l = torch.empty((bh, 1, tq), dtype=torch.float32, device=device)
    _launch(name, device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pv.data_ptr(), m.data_ptr(), l.data_ptr(), bh, tq, tk, d,
            q_offset, k_offset, float(scale), skip_tq, skip_tk,
            _DTYPE_CODE[q.dtype])
    LAUNCHES["flash_fwd_kblocked" if skip_tq else "flash_fwd_whole_k"] += 1
    return pv, m, l


def _bwd_check(name, q, k, v, do, lse, drow):
    bh, t, d = q.shape
    full, row = (bh, t, d), (bh, 1, t)
    device = _check(
        name, {"q": q, "k": k, "v": v, "do": do, "lse": lse, "drow": drow},
        {"q": full, "k": full, "v": full, "do": full, "lse": row,
         "drow": row},
        {"q": q.dtype, "k": q.dtype, "v": q.dtype, "do": q.dtype,
         "lse": torch.float32, "drow": torch.float32})
    _check_dims(name, q.dtype, d, t)
    return device, bh, t, d


def flash_bwd_dq(q, k, v, do, lse, drow, scale: float) -> torch.Tensor:
    """dq [BH,T,D] f32 of causal attention (offsets 0) from q, k, v, do
    [BH,T,D] and lse, drow [BH,1,T] f32."""
    name = "flash_bwd_dq"
    device, bh, t, d = _bwd_check(name, q, k, v, do, lse, drow)
    dq = torch.empty((bh, t, d), dtype=torch.float32, device=device)
    _launch(name, device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), drow.data_ptr(), dq.data_ptr(),
            bh, t, d, float(scale), _DTYPE_CODE[q.dtype])
    LAUNCHES[name] += 1
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, drow, scale: float):
    """(dk, dv) [BH,T,D] f32 of causal attention (offsets 0), same inputs
    as :func:`flash_bwd_dq`."""
    name = "flash_bwd_dkdv"
    device, bh, t, d = _bwd_check(name, q, k, v, do, lse, drow)
    dk = torch.empty((bh, t, d), dtype=torch.float32, device=device)
    dv = torch.empty((bh, t, d), dtype=torch.float32, device=device)
    _launch(name, device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), drow.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, t, d, float(scale), _DTYPE_CODE[q.dtype])
    LAUNCHES[name] += 1
    return dk, dv
