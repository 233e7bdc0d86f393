"""The native host runtime (counterpart of `vitadapter/ops/native.py`):
an exact linear-assignment solver (LAPJV, `host/lap.cpp`), the COCO
compressed-RLE codec and a bit-packed mask IoU (`host/rle.cpp`), plain C
bound with ctypes.

These are host code, not kernels: `g++ -O3 -shared -fPIC` builds the two
sources at first use into `vitadapter_torch/_build/`, the library named by a
hash of the sources and the flags (an edited source builds anew) and written
under a temporary name, then renamed, so that processes building at once do
not read a half-written file. Nothing is built when the module is imported.
There is no fallback: if the library cannot be built, the call raises with
the compiler's error.

`calls` counts the calls into the library by function name.
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
from typing import Optional

import numpy as np

HOST_SRC = Path(__file__).resolve().parent / "host"
SOURCES = ("lap.cpp", "rle.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

calls: Counter = Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "lap_solve_batch": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _dp, _ip,
                        _ip],
    "rle_encode_mask": [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                        _ip],
    "rle_decode_mask": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _u8p],
    "mask_iou_batch": [_u8p, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_long,
                       _u8p, _dp],
}


def compiler() -> str:
    """The C++ compiler, `CXX` found on PATH. Raises when there is none."""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"no C++ compiler for the native runtime ({CXX!r} "
                           f"not found): it is built with g++ at first use")
    return cxx


def library_path() -> Path:
    src = b"".join((HOST_SRC / s).read_bytes() for s in SOURCES)
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libvitadapter_native-{digest[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(HOST_SRC / s) for s in SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the native runtime failed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native runtime failed ({cxx} exit "
                           f"{r.returncode}):\n{r.stderr}{r.stdout}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def lap_solve_batch(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Exact batched LAP. cost (B, Q, G) float; n_valid (B,) ints: the first
    n_valid[b] columns of matrix b are real. Returns (B, Q) int32, the column
    of each row or -1."""
    lib = library()
    B, Q, G = cost.shape
    c = np.ascontiguousarray(cost, np.float64)
    c = np.nan_to_num(c, nan=1e8, posinf=1e8, neginf=-1e8)
    nv = np.ascontiguousarray(n_valid, np.int32)
    out = np.empty((B, Q), np.int32)
    lib.lap_solve_batch(B, Q, G, c.ctypes.data_as(_dp),
                        nv.ctypes.data_as(_ip), out.ctypes.data_as(_ip))
    calls["lap_solve_batch"] += 1
    return out


def rle_encode(mask: np.ndarray) -> str:
    """Binary (H, W) mask -> COCO compressed counts string."""
    lib = library()
    m = np.ascontiguousarray(mask, np.uint8)
    h, w = m.shape
    buf = ctypes.create_string_buffer(6 * (h * w + 2))
    n = ctypes.c_int(0)
    lib.rle_encode_mask(m.ctypes.data_as(_u8p), h, w, buf, ctypes.byref(n))
    calls["rle_encode"] += 1
    return ctypes.string_at(buf, n.value).decode("ascii")


def rle_decode(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed counts string -> binary (H, W) uint8 mask."""
    lib = library()
    s = counts.encode("ascii")
    out = np.empty((h, w), np.uint8)
    lib.rle_decode_mask(s, len(s), h, w, out.ctypes.data_as(_u8p))
    calls["rle_decode"] += 1
    return out


def mask_iou_native(dets: np.ndarray, gts: np.ndarray,
                    iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise mask IoU (D, G) float64 of binary masks dets (D, ...) and
    gts (G, ...) by bit-packed popcount; for crowd gts, the intersection
    over the detection's area (the COCO rule)."""
    lib = library()
    d = np.ascontiguousarray(dets.reshape(dets.shape[0], -1), np.uint8)
    g = np.ascontiguousarray(gts.reshape(gts.shape[0], -1), np.uint8)
    D, hw = d.shape
    G = g.shape[0]
    crowd = (np.ascontiguousarray(iscrowd, np.uint8)
             if iscrowd is not None else np.zeros(G, np.uint8))
    out = np.empty((D, G), np.float64)
    lib.mask_iou_batch(d.ctypes.data_as(_u8p), D, g.ctypes.data_as(_u8p), G,
                       hw, crowd.ctypes.data_as(_u8p), out.ctypes.data_as(_dp))
    calls["mask_iou_native"] += 1
    return out
