"""Build, load and launch the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with `ctypes`. Nothing is
built when a module is imported: the first launch of a kernel builds its
library into `vitadapter_torch/_build/` (named by a hash of its source,
the shared headers `csrc/*.cuh` and the flags, so an edited source builds
anew), and `build()` compiles several sources in parallel, one `nvcc` each.

`launches` counts kernel launches by name. Each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show which kernels its
path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel's entry point (all return a cudaError_t as int)
SIGNATURES = {
    "msda_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    "msda_bwd": [_P] * 8 + [_I] * 7 + [_P, _P, _I, _P],
    # the per-level route: pointers, then B, S, M, D, Lq, L, P, level,
    # start, H, W, is_bf16, stream
    "msda_level_fwd": [_P] * 4 + [_I] * 12 + [_P],
    "msda_level_dv": [_P] * 4 + [_I] * 12 + [_P],
    "msda_level_dgrid": [_P] * 6 + [_I] * 12 + [_P],
    "attention_fwd": [_P] * 6 + [_I, _I, _I, ctypes.c_float, _I, _P],
    "attention_bwd": [_P] * 10 + [_I, _I, _I, ctypes.c_float, _I, _P],
    "point_sample_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "point_sample_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "auction": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
}

launches: Counter = Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built at first use")


def library_path(name: str) -> Path:
    # the source and every shared header in csrc/
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one `nvcc` process each, all started together. Returns the compiler's
    output (register and shared-memory use from `-Xptxas -v`) by name;
    raises if any build fails."""
    names = list(SIGNATURES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(n)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel `name`'s C entry point on `device`'s current stream
    (appended as the last argument), raise on a CUDA error, count it."""
    lib = library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    launches[name] += 1
