"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source ``csrc/<name>.cu`` exports plain C functions (declared in
SIGNATURES) and is compiled on first use for Hopper (``sm_90a``) into
``_build/lib<name>-<hash>.so`` beside this file, the hash taken over the
source and the headers of ``csrc/``; a changed source or header gets a new
library name, so a stale build is never loaded.  ``-fmad=false``
keeps every multiply and add separately rounded, as PyTorch's op-by-op plain
twins are, so kernel and twin agree bit for bit.  Nothing here runs at
import: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> {C function: (argtypes, restype)}
SIGNATURES = {
    "cluster_sweep": {
        # nact, clist, bt0, order, rays, prev, tris, out, visits, state,
        # blocks, ray_block, clusters, CTAs per ray block, threads per ray,
        # passes per visit, stream
        "wc_cluster_sweep": ([_P] * 10 + [_I] * 6 + [_P], _I),
        "wc_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "cluster_sweep_mxu": {
        # nact, clist, bt0, order, rays, prev, trisW, mat_tbl, out, visits,
        # state, counts, blocks, ray_block, clusters, CTAs per ray block,
        # threads per ray, passes per visit, stream
        "wc_cluster_sweep_mxu": ([_P] * 12 + [_I] * 6 + [_P], _I),
        "wc_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "bvh_walk": {
        # origin, direction, t_init, node / triangle / draw records, lanes,
        # alive mask, lane counter, t_out, off_out, counts, rays, draws,
        # stack slots, top levels, staged records, flags, stream
        "wc_bvh_walk": ([_P] * 12 + [_I] * 6 + [_P], _I),
        "wc_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for exe in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if exe and os.path.exists(exe):
            return exe
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header in
    csrc/ and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu"]
                   + sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every named source (default: all of SIGNATURES) that has no
    current library, one nvcc process per source, all started together.
    Returns {name: nvcc's output} (ptxas registers/shared memory/spills) for
    the sources it compiled; raises with nvcc's output if any fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
