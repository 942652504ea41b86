"""Builds the package's CUDA sources into one shared library and loads it.

`csrc/*.cu` compile with nvcc for sm_90a into a library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds).
Each source compiles in its own nvcc process, all started together, and one
more links the objects; a source in SPLIT_SOURCES compiles once per define
listed there, each into an object of its own. The library lands in
`build/cuda_kernels/<hash of sources and flags>/` at the root of the
checkout, at first use; later calls and processes reuse it.
Nothing here runs at import time: the CPU tests import every module of the
package on machines without nvcc or a GPU.
"""

from __future__ import annotations

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

import torch

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_ROOT = _PACKAGE.parent / "build" / "cuda_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources built more than once, each time with one more define, so that
# nvcc compiles their instances in parallel: K1's non-default tiles, one
# object per mode (csrc/flash_prefill.cuh: kCausal, kFull, kPositioned),
# and its mode (a) variants, one object per combination of the three flags.
SPLIT_SOURCES = {
    "flash_prefill_tiles.cu": tuple(f"RKV_FLASH_TILE_MODE={m}"
                                    for m in range(3)),
    "flash_prefill_variants.cu": tuple(f"RKV_FLASH_VARIANT={v}"
                                       for v in range(1, 8)),
}
# C entries: each takes a pointer to its params struct and a stream.
ENTRIES = ("flash_prefill_launch", "decode_attention_launch",
           "int4_matmul_launch", "int8_matmul_launch")

# dtype codes shared with csrc/common.cuh.
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library, where it lives, and what building it cost
    (build_seconds is 0.0 when an earlier build was reused)."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    ptxas_log: str


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _objects():
    """(object stem, source, extra nvcc flags) of every object to build."""
    objs = []
    for src in sorted(CSRC.glob("*.cu")):
        defines = SPLIT_SOURCES.get(src.name)
        if defines is None:
            objs.append((src.stem, src, ()))
        else:
            objs += [(f"{src.stem}.{i}", src, ("-D" + d,))
                     for i, d in enumerate(defines)]
    return objs


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: the CUDA kernels need the "
                               "CUDA toolkit")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    return nvcc


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernels; raises if nvcc fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SPLIT_SOURCES.items())).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libkernels.so"
    log_path = out_dir / "ptxas.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # Build in a private directory, then rename the library: concurrent
        # first uses (test workers) never load a half-written one.
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            nvcc, tmp = _nvcc(), Path(tmp)
            plan = _objects()
            objs = [tmp / (stem + ".o") for stem, _, _ in plan]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for obj, (_, src, extra) in zip(objs, plan)]
            logs = [proc.communicate()[0] for proc in procs]
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / "lib.so"),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            failed = [(obj.stem, proc.returncode, log) for obj, proc, log in
                      zip(objs, procs, logs) if proc.returncode != 0]
            if link.returncode != 0:
                failed.append(("link", link.returncode, link.stdout))
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"[{name}] exit {rc}\n{log}" for name, rc, log in failed))
            log_path.write_text("".join(logs))
            os.replace(tmp / "lib.so", lib_path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ptxas = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=lib_path, build_seconds=seconds,
                         ptxas_log=ptxas)


def launch(name: str, params: ctypes.Structure, stream: int) -> None:
    """Call the C entry `name` with a pointer to `params` on `stream`;
    raise with CUDA's message if the launch was refused."""
    kl = load_library()
    err = getattr(kl.lib, name)(ctypes.addressof(params), stream)
    if err != 0:
        msg = kl.lib.kernels_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


# Scratch of the kernels that sum split partials inside one launch (K2,
# and K3's and K4's GEMVs), per (device, stream): float32 partials (K4's
# GEMV writes int32 in the same bytes), grown as needed, and int32 tickets,
# which every launch leaves at zero. Launches on one stream run in order,
# so the kernels share it.
_SCRATCH = {}


def scratch(device, stream: int, floats: int, tickets: int):
    """(partials of at least `floats` float32, zero tickets of at least
    `tickets` int32) for launches on `stream`."""
    key = (device, stream)
    part, tick = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if tick is None or tick.numel() < tickets:
        tick = torch.zeros(tickets, dtype=torch.int32, device=device)
    _SCRATCH[key] = (part, tick)
    return part, tick


def dtype_code(dtype) -> int:
    """Kernel dtype code of a torch dtype; raises for unsupported ones."""
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]
