"""Build, load and launch helpers for the hand-written CUDA kernels.

The sources under ``repro_torch/csrc/`` have a plain C interface.  At
first use they are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc -c``
per source, all started together, then one link — into a single shared
library under ``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``), and loaded with ``ctypes``.  The hash covers the sources
and the flags, so an edited source rebuilds.  Nothing here runs at import:
the CPU tests import every module, on machines without ``nvcc``.

Every pointer and the stream cross as ``c_void_p``; each C entry point
returns ``cudaGetLastError()`` after its launches, and ``check`` raises on
a nonzero code (a refused launch never runs, and no later synchronise
would report it).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("sgmv.cu", "paged_attn.cu", "paged_prefill.cu",
           "flash_attn.cu", "flash_attn_prefix.cu", "decode_attn.cu")
HEADERS = ("common.cuh", "prefill_tile.cuh", "decode_tile.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: argtypes (all return int: cudaError_t, or decode_smem_bytes's
    # byte count, or flash's tile rows and paged prefill's key partitions)
    "sgmv": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    "paged_decode": [_P] * 9 + [_I] * 10 + [_P],
    "paged_prefill": [_P] * 10 + [_I] * 11 + [_P],
    "flash_attn": [_P] * 4 + [_I] * 11 + [_P],
    "flash_tile_rows": [_I] * 6,
    "paged_prefill_partitions": [_I] * 9,
    "ring_decode": [_P] * 9 + [_I] * 9 + [_P],
    "decode_smem_bytes": [_I] * 4,
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float        # wall time of this call's build (0 when cached)
    built: bool           # False when a library with this hash existed
    log: str              # nvcc/ptxas output (registers, shared memory)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a library with the current hash exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        log_file = out_dir / "build.log"
        log = log_file.read_text() if log_file.exists() else ""
        return BuildInfo(lib, 0.0, False, log)
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs: List[str] = []
        failed: List[str] = []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        os.replace(tmp_lib, lib)
    return BuildInfo(lib, time.perf_counter() - t0, True, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def device_kind(*tensors: torch.Tensor) -> str:
    """"cuda" if every tensor is on a CUDA device, "cpu" if every one is
    on the CPU (the plain version's domain), "meta" if every one is on the
    meta device (the dry run: an output of the kernel's shape, nothing
    computed); raises on any mix — a CUDA tensor goes to the kernel or
    nowhere."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) == 1 and kinds <= {"cuda", "cpu", "meta"}:
        return kinds.pop()
    raise ValueError(f"tensors on devices {sorted(kinds)}: the kernels take "
                     f"all-CUDA inputs, the plain versions all-CPU inputs, "
                     f"the dry run all-meta inputs")


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do: the operations it performs on these
    inputs and the bytes it must move (each input read once, each output
    written once), in ``dtype``.  ``chip_smoke.py``'s bounds and the dry
    run's per-device counts both read it."""
    flops: float
    bytes: float
    dtype: torch.dtype


_WORK_SINKS: List[List] = []


@contextlib.contextmanager
def record_work():
    """Collect (kernel name, ``Work``) of every meta call of a kernel
    wrapper made inside the block: the dry run's kernel FLOPs and bytes,
    which no aten op shows (the meta branch computes nothing)."""
    sink: List = []
    _WORK_SINKS.append(sink)
    try:
        yield sink
    finally:
        _WORK_SINKS.remove(sink)


def meta_call(name: str, work: Work, out: torch.Tensor) -> torch.Tensor:
    """A wrapper's meta branch: record the kernel's work, return its
    output shape without computing (the plain version's arithmetic, full
    score matrices under a mask, is not the kernel's work)."""
    for sink in _WORK_SINKS:
        sink.append((name, work))
    return out


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """The kernels write their outputs through raw pointers, so an output
    carries no autograd graph: a gradient would stop there without an
    error.  While grad mode is on, a CUDA input that requires grad raises
    instead (the training forward runs no kernel)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel has no backward, and an "
                         f"input requires grad; run it under "
                         f"torch.no_grad(), or train through "
                         f"transformer.forward_train")


def dtype_code(*tensors: torch.Tensor) -> int:
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"kernel takes float32 or bfloat16 operands of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    return DTYPE_CODES[dt]


def require_int32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"index operand must be int32, got {t.dtype}")


def require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def require_aligned(**tensors: torch.Tensor) -> None:
    """The kernels load 16 bytes at a time from these operands."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
