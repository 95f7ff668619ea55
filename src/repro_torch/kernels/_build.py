"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, one library per source:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I kernels/csrc \\
         -o build/repro_torch_kernels/lib<name>_<hash>.so

The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source, every
header under ``kernels/`` (its own ``csrc/*.cuh`` and the shared
``kernels/csrc/*.cuh``, on the include path) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Beside each library, ``<lib>.log`` keeps what nvcc printed: ``ptxas``'s
registers, spills and warnings for every kernel.
Sources that need building are compiled in parallel, one ``nvcc`` each.  A
missing ``nvcc``, a failed build or a failed load raises: there is no
fall-back.  Building and loading are safe across threads (the executor's
workers may reach one kernel first together): one lock serialises them,
so a library is built and loaded once, and each build writes to a
temporary file named by its process and thread.
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

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
SHARED_INCLUDE = KERNELS_DIR / "csrc"   # headers every kernel may include
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCK = threading.Lock()           # held by every build and every load
_LOADED: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH
    or under CUDA_HOME (default ``/usr/local/cuda``); raises if neither."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which(name), os.path.join(cuda_home, "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (neither on PATH nor under "
                       f"CUDA_HOME {cuda_home!r})")


def _lib_path(src: Path) -> Path:
    # every header a source can include: its own csrc/ and the shared one
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(KERNELS_DIR.rglob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".log")


def built(name: str) -> tuple[Path, str]:
    """The library of kernel ``name`` (built first if needed) and the
    output nvcc gave when it built it."""
    build_all([name])
    lib = _lib_path(sources()[name])
    return lib, _log_path(lib).read_text()


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named kernels (default: all) whose library is missing,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds of each build that ran; raises with nvcc's output if any
    failed."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names: list[str] | None) -> dict[str, float]:
    srcs = sources()
    todo = {n: srcs[n] for n in (names or srcs)
            if not _lib_path(srcs[n]).exists()}
    if not todo:
        return {}
    nvcc = tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, src in todo.items():
            lib = _lib_path(src)
            tmp = lib.with_name(
                f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(SHARED_INCLUDE), "-o",
                   str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        seconds, failed = {}, []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                _log_path(lib).write_text(out)
                os.replace(tmp, lib)   # atomic: readers never see a partial
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LOADED:
            src = sources().get(name)
            if src is None:
                raise KeyError(f"no kernel source named {name!r} under "
                               f"{KERNELS_DIR}")
            _build_locked([name])
            _LOADED[name] = ctypes.CDLL(str(_lib_path(src)))
        return _LOADED[name]


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; safe across threads (``+=`` on an
    attribute is not atomic)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
