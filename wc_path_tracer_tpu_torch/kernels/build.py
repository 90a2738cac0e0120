"""Build and load the port's native libraries: compiler -> shared library
-> ctypes.

Each source exports plain C functions (given as {C function: (argtypes,
restype)}) and is compiled on first use into ``_build/lib<name>-<hash>.so``
beside this file, the hash taken over the source, the headers of its
directory and the compiler's flags; a changed source, header or flag gets a
new library name, so a stale build is never loaded.  A build writes a
temporary file and renames it into place, so processes that build at once
never load a half-written library.  The source's suffix picks the compiler:

- ``.cu``, the CUDA kernels ``kernels/csrc/<name>.cu`` (their signatures in
  SIGNATURES): nvcc for Hopper (``sm_90a``); ``-fmad=false`` keeps every
  multiply and add separately rounded, as PyTorch's op-by-op plain twins
  are, so kernel and twin agree bit for bit;
- ``.cpp``, a host library whose module passes its own source and
  signatures (scene/native.py): g++ with HOST_FLAGS;
  ``-ffp-contract=off`` (and no ``-march=native``) keeps its float32
  arithmetic NumPy's on any host.

Nothing here runs at import: the CPU tests import every module and have no
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
HOST_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# CUDA kernel csrc/<name>.cu -> {C function: (argtypes, restype)}
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
    "shade_segment": {
        # o, d, total, trans, seed, alive, the hit record's t, p, normal,
        # hit, front, material, the material table and type ids, the six
        # outputs (o, d, total, trans, seed, alive), lanes, o's row stride,
        # gradient sky, Russian roulette, stream
        "wc_shade_segment": ([_P] * 20 + [_I] * 4 + [_P], _I),
        "wc_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "brute_hit": {
        # origin, direction, sphere positions, radii and live count, the
        # triangle slots' vertex rows a, b, c, their draws and the live draw
        # count, the four outputs (t_s, s_idx, t_tri, t_idx), lanes,
        # origin's row stride, sphere slots, triangle slots, near root
        # only, stream
        "wc_brute_hit": ([_P] * 14 + [_I] * 5 + [_P], _I),
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


def source(name: str, src: Path | None = None) -> Path:
    """``src`` if given, else the CUDA kernel ``csrc/<name>.cu``."""
    return Path(src) if src is not None else CSRC / f"{name}.cu"


def _host(src: Path) -> bool:
    """Whether ``src`` is a host (g++) source rather than a CUDA one."""
    return src.suffix == ".cpp"


def _flags(src: Path) -> list[str]:
    return HOST_FLAGS if _host(src) else NVCC_FLAGS


def compiler(src: Path) -> str:
    """The compiler of ``src``: g++ for a host library, else nvcc."""
    if not _host(src):
        return nvcc_path()
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host libraries are "
                           "built with it")
    return gxx


def library_path(name: str, src: Path | None = None) -> Path:
    """The library's path, named by a hash of its source, every header in
    its directory (``*.cuh``, ``*.h``) and the flags."""
    src = source(name, src)
    headers = sorted(p for pat in ("*.cuh", "*.h")
                     for p in src.parent.glob(pat))
    data = b"".join(p.read_bytes() for p in [src] + headers)
    digest = hashlib.sha256(data + " ".join(_flags(src)).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None, sources=None) -> dict[str, str]:
    """Compile every named CUDA kernel (default: all of SIGNATURES) and
    every library of ``sources`` ({name: source path}) that has no current
    library, one compiler process per source, all started together.
    Returns {name: the compiler's output} (for nvcc, ptxas registers/shared
    memory/spills) for the sources it compiled; raises with the compiler's
    output if any fails."""
    todo = {name: source(name)
            for name in (SIGNATURES if names is None else names)}
    todo.update({name: Path(src) for name, src in (sources or {}).items()})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in todo.items():
        out = library_path(name, src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (subprocess.Popen(
            [compiler(src), *_flags(src), "-o", str(tmp), str(src)],
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
        raise RuntimeError("compiling failed for " + "\n".join(failed))
    return logs


def load(name: str, src: Path | None = None,
         signatures: dict | None = None) -> ctypes.CDLL:
    """The loaded library ``name``, built if needed: the CUDA kernel
    ``csrc/<name>.cu`` with its SIGNATURES entry, or the given source with
    the given ``signatures``."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name, src)
        if not path.exists():
            build_all([], {name: source(name, src)})
        lib = ctypes.CDLL(str(path))
        sigs = SIGNATURES[name] if signatures is None else signatures
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
