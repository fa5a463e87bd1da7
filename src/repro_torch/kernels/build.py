"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/<pkg>/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into its own shared library under
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so <src>

The library name carries a hash of the source, of every shared header
(``kernels/*/csrc/*.cuh``) and of the flags, so an edited kernel or header
is rebuilt and an unchanged one is loaded as it is. Only sources in this
package are compiled; nothing is fetched or taken from elsewhere. A failed
build raises with the compiler's output. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them (what a cold run on
the card should do before its first launch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Every kernel source of the port, by library name (the file stem)."""
    found = sorted(KERNELS_DIR.glob("*/csrc/*.cu"))
    return {p.stem: p for p in found}


def headers() -> list[Path]:
    """Every shared header of the port's kernels (``#include``d by relative
    path), in a fixed order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cuh"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes())
    for hdr in headers():
        h.update(str(hdr.relative_to(KERNELS_DIR)).encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _start(src: Path) -> tuple[Path, Path, subprocess.Popen | None]:
    out = _target(src)
    if out.exists():
        return out, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(src: Path, out: Path, tmp: Path,
            proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns ``{name: nvcc log}``
    (the ``-Xptxas -v`` register and shared-memory report; empty for a
    library already built)."""
    started = {name: (src, *_start(src)) for name, src in sources().items()}
    return {name: _finish(*job) for name, job in started.items()}


def registers(log: str) -> dict[str, int]:
    """``{entry: registers a thread}`` from an ``nvcc -Xptxas -v`` log, by
    each kernel's mangled name."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
    return out


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` log kept beside the built library ``<name>``
    (empty when it was not built here)."""
    log = _target(sources()[name]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``<name>.cu``, building it first
    when needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = sources().get(name)
            if src is None:
                raise KeyError(f"no kernel source {name}.cu under "
                               f"{KERNELS_DIR}")
            out, tmp, proc = _start(src)
            _finish(src, out, tmp, proc)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
