"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``csrc/`` becomes a shared library with a plain C
interface, loaded with :mod:`ctypes`.  Libraries are named by a hash of
their source and flags, so an edited source is rebuilt and an unchanged one
is reused.  They go to ``REPRO_TORCH_BUILD_DIR`` or, by default, the
``_build`` directory beside this file (ignored by git).  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCES", "build_all", "build_dir", "library_path", "load"]

_HERE = Path(__file__).resolve().parent

#: kernel library name -> CUDA source (relative to this package)
SOURCES = {
    "pair_advance": "csrc/pair_advance.cu",
    "bucket_hist": "csrc/bucket_hist.cu",
}

#: Hopper only; no --use_fast_math (the walks are held bit for bit)
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_loaded: dict = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _HERE / "_build"))


def _nvcc() -> str:
    # PyTorch's own lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA 12 toolkit (sm_90a)")
    return str(nvcc)


def library_path(name: str) -> Path:
    src = (_HERE / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one library unless it is built; returns
    ``(process, temp_path, final_path)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_HERE / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=None) -> dict:
    """Build every named library (default: all) in parallel.  Returns
    ``{name: compiler output}`` for the libraries built by this call; raises
    if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    jobs = {n: _start(n) for n in names}
    logs, errors = {}, []
    for n, job in jobs.items():
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        logs[n] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
