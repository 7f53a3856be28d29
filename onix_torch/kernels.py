"""Build and load the port's hand-written CUDA kernels.

Each `onix_torch/csrc/<name>.cu` has a plain C interface. At first use
it is compiled with nvcc for sm_90a into a shared library under
`build/onix_torch/` beside the package (listed in .gitignore) and
loaded with ctypes. The library's name carries a hash of the sources
and the flags, so a changed source is rebuilt and a stale build is
never loaded. Every source is compiled by its own nvcc, all started
together (`build_all`).

No file here includes PyTorch's headers: nvcc takes seconds for such a
file, where `torch.utils.cpp_extension.load` takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent / "build"
             / "onix_torch")
# -fmad=false: no product is contracted into an FMA, so a kernel's float
# ops round exactly as the plain PyTorch version's separate ops do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the toolkit's nvcc (CUDA_HOME, as torch resolves it)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    path = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}")
    return str(path)


def library_path(name: str) -> pathlib.Path:
    """Where the build of `csrc/<name>.cu` lives, keyed by the hash of
    that source, every header in csrc/ and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Compile every named source (default: all) that has no current
    build, one nvcc each, all in parallel. Raises with nvcc's output if
    any build fails. Each build's ptxas report (registers, shared
    memory, spills) is kept beside the library as `<lib>.log`."""
    names = sources() if names is None else names
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for csrc/{n}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        todo[n].with_suffix(".log").write_text(log)
        os.replace(tmp, todo[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """nvcc's output (the ptxas report) for the current build of
    `name`, or "" when the build predates the log."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib
