"""Build and load the port's native libraries: compiler -> shared library
-> ctypes.

Each source exports plain C functions (given as {C function: (argtypes,
restype)}) and is compiled on first use into ``_build/lib<name>-<hash>.so``
beside this file, the hash taken over the source, the headers of its
directory and the compiler's flags; a changed source, header or flag gets a
new library name, so a stale build is never loaded.  A build writes a
temporary file and renames it into place, so processes that build at once
never load a half-written library.  The source's suffix picks the compiler:

- ``.cu``, the CUDA kernels ``kernels/csrc/<name>.cu`` (their entries and
  signatures in ``launches.KERNELS``; each also exports
  ``wc_cuda_error_string``, bound here): nvcc for Hopper (``sm_90a``);
  ``-fmad=false`` keeps every multiply and add separately rounded, as
  PyTorch's op-by-op plain twins are, so kernel and twin agree bit for
  bit;
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
    """Compile every named CUDA kernel (default: every ``csrc/*.cu``) and
    every library of ``sources`` ({name: source path}) that has no current
    library, one compiler process per source, all started together.
    Returns {name: the compiler's output} (for nvcc, ptxas registers/shared
    memory/spills) for the sources it compiled; raises with the compiler's
    output if any fails."""
    todo = {name: source(name)
            for name in (sorted(p.stem for p in CSRC.glob("*.cu"))
                         if names is None else names)}
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
    ``csrc/<name>.cu`` or the given source, with the given ``signatures``
    ({C function: (argtypes, restype)}; a CUDA kernel's
    ``wc_cuda_error_string`` is bound besides)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name, src)
        if not path.exists():
            build_all([], {name: source(name, src)})
        lib = ctypes.CDLL(str(path))
        sigs = dict(signatures or {})
        if not _host(source(name, src)):
            sigs["wc_cuda_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
