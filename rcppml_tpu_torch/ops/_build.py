"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points.  It is compiled at
first use into ``rcppml_tpu_torch/_build/`` as a shared library whose file
name carries a hash of the source, of every header ``csrc/*.cuh`` (a source
may include any of them: ``-I csrc``) and of the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.  The build needs ``nvcc``
(``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or on ``PATH``) and
raises if it is missing or the compile fails: there is no fallback.
:func:`build_all` compiles every kernel at once, one ``nvcc`` process per
source, all with the same flags.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a source."""


def _nvcc() -> str:
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "nvcc"), shutil.which("nvcc")]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  The name
    hashes the source, every header of ``csrc`` (name and bytes, in sorted
    order) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def kernel_names() -> list[str]:
    """Every kernel source of the package, ``csrc/<name>.cu``, by name."""
    return sorted(path.stem for path in CSRC.glob("*.cu"))


def build_all(names=None) -> dict[str, tuple[Path, float]]:
    """Compile ``csrc/<name>.cu`` for every name (default: all of them)
    that is not built yet, all ``nvcc`` processes started together.

    Returns ``{name: (library path, seconds its compile took)}`` (0.0 for a
    library that was already built).  nvcc's output, including ``-Xptxas
    -v``'s register and shared-memory report, is kept beside each library as
    ``<library>.log``.  If any compile fails, the others are still waited
    for, and then KernelBuildError is raised with the failed ones' logs.
    """
    names = kernel_names() if names is None else list(names)
    done, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            done[name] = (out, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (out, tmp, cmd, proc, time.perf_counter())
    failed = []
    for name, (out, tmp, cmd, proc, t0) in running.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{output}"
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
        done[name] = (out, seconds)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return done


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns the library's path and the seconds the compile took."""
    return build_all([name])[name]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
