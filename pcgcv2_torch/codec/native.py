"""ctypes bridge to the native coding library (own copy of
pcgcv2_tpu/codec/native.py, built from pcgcv2_torch/native/coding.cpp).

Builds the library on first use with g++ into pcgcv2_torch/native/build/.
The file name carries a hash of the source, and each build writes a
private temp file then renames it, so parallel test workers (and the JAX
package's own build of its copy) never race on one half-written file.
A failed build or load raises: the codec has no other coding path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_ROOT = Path(__file__).resolve().parents[1]
_SRC = _PKG_ROOT / "native" / "coding.cpp"
_BUILD_DIR = _PKG_ROOT / "native" / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the native library (idempotent)."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libpcgc_coding_{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({r.returncode}) building {_SRC}:\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rans_encode.restype = ctypes.c_long
        lib.rans_encode.argtypes = [
            u32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_long,
            u8p, ctypes.c_long,
        ]
        lib.rans_decode.restype = ctypes.c_long
        lib.rans_decode.argtypes = [
            u32p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_long,
            i32p, ctypes.c_long,
        ]
        lib.abc_enc_new.restype = ctypes.c_void_p
        lib.abc_enc_new.argtypes = [ctypes.c_int]
        lib.abc_enc_new2.restype = ctypes.c_void_p
        lib.abc_enc_new2.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.abc_dec_new2.restype = ctypes.c_void_p
        lib.abc_dec_new2.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.abc_enc_bytes.argtypes = [
            ctypes.c_void_p, u8p, u32p, ctypes.c_long,
        ]
        lib.abc_enc_finish.restype = ctypes.c_long
        lib.abc_enc_finish.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long]
        lib.abc_enc_free.argtypes = [ctypes.c_void_p]
        lib.abc_dec_new.restype = ctypes.c_void_p
        lib.abc_dec_new.argtypes = [u8p, ctypes.c_long, ctypes.c_int]
        lib.abc_dec_bytes.argtypes = [
            ctypes.c_void_p, u32p, ctypes.c_long, u8p,
        ]
        lib.abc_dec_free.argtypes = [ctypes.c_void_p]
        lib.oct_enc_new.restype = ctypes.c_void_p
        lib.oct_enc_new.argtypes = []
        lib.oct_enc_level.argtypes = [
            ctypes.c_void_p, u8p, i32p, u8p, ctypes.c_long,
        ]
        lib.oct_enc_finish.restype = ctypes.c_long
        lib.oct_enc_finish.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long]
        lib.oct_enc_free.argtypes = [ctypes.c_void_p]
        lib.oct_dec_new.restype = ctypes.c_void_p
        lib.oct_dec_new.argtypes = [u8p, ctypes.c_long]
        lib.oct_dec_level.argtypes = [
            ctypes.c_void_p, i32p, u8p, ctypes.c_long, u8p,
        ]
        lib.oct_dec_free.argtypes = [ctypes.c_void_p]
        lib.popcount_bytes.restype = ctypes.c_long
        lib.popcount_bytes.argtypes = [u8p, ctypes.c_long]
        lib.extract_coords.restype = ctypes.c_long
        lib.extract_coords.argtypes = [
            i32p, u8p, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, i32p, ctypes.c_long,
        ]
        _lib = lib
        return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# rANS front-end
# ---------------------------------------------------------------------------

def rans_encode(cdf: np.ndarray, syms: np.ndarray) -> bytes:
    """Encode int symbols with per-channel CDFs.

    cdf: uint32 [C, S+1] quantized CDF (cdf[:,0]=0, cdf[:,S]=65536).
    syms: int32 [N] flattened row-major [points, channels]; symbol i uses
    channel i % C.
    """
    cdf = np.ascontiguousarray(cdf, dtype=np.uint32)
    syms = np.ascontiguousarray(syms, dtype=np.int32)
    c, s1 = cdf.shape
    cap = max(len(syms) * 4 + 64, 1024)
    out = np.empty(cap, dtype=np.uint8)
    n = _load().rans_encode(
        _u32(cdf), c, s1 - 1, _i32(syms), len(syms), _u8(out), cap
    )
    if n < 0:
        raise ValueError(f"rans_encode failed ({n})")
    return out[:n].tobytes()


def rans_decode(cdf: np.ndarray, data: bytes, n: int) -> np.ndarray:
    cdf = np.ascontiguousarray(cdf, dtype=np.uint32)
    c, s1 = cdf.shape
    buf = np.frombuffer(data, dtype=np.uint8)
    syms = np.empty(n, dtype=np.int32)
    r = _load().rans_decode(
        _u32(cdf), c, s1 - 1, _u8(buf), len(buf), _i32(syms), n
    )
    if r < 0:
        raise ValueError(f"rans_decode failed ({r})")
    return syms


def quantize_cdf(pmf: np.ndarray, precision: int = 16) -> np.ndarray:
    """Deterministic float PMF -> integer CDF with every frequency >= 1.

    The same function runs on encode and decode sides (the reference relies
    on torchac's internal float->int conversion the same way,
    entropy_model.py:142-149,174).
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    c, s = pmf.shape
    total = 1 << precision
    norm = pmf / pmf.sum(axis=1, keepdims=True)
    freqs = np.floor(norm * (total - s)).astype(np.int64) + 1
    diff = total - freqs.sum(axis=1)
    top = np.argmax(freqs, axis=1)
    freqs[np.arange(c), top] += diff
    cdf = np.zeros((c, s + 1), dtype=np.uint32)
    cdf[:, 1:] = np.cumsum(freqs, axis=1)
    assert (cdf[:, -1] == total).all()
    return cdf


# ---------------------------------------------------------------------------
# Adaptive binary coder handles (used by the octree coordinate codec)
# ---------------------------------------------------------------------------


class AdaptiveByteEncoder:
    """Streaming context-adaptive byte encoder.

    model 0: exponential probability update (legacy streams);
    model 1: Krichevsky-Trofimov counts — near-optimal adaptation for the
    short per-frame streams the octree codec emits (~20% fewer coordinate
    bits measured at vox10)."""

    def __init__(self, n_ctx: int, model: int = 0):
        lib = self._lib = _load()
        self._h = lib.abc_enc_new2(n_ctx, model)

    def write(self, data: np.ndarray, ctxs: np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8)
        ctxs = np.ascontiguousarray(ctxs, dtype=np.uint32)
        assert len(data) == len(ctxs)
        self._lib.abc_enc_bytes(self._h, _u8(data), _u32(ctxs), len(data))

    def finish(self) -> bytes:
        cap = 16 << 20
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.abc_enc_finish(self._h, _u8(out), cap)
        if n < 0:
            raise ValueError("abc_enc_finish overflow")
        self._lib.abc_enc_free(self._h)
        self._h = None
        return out[:n].tobytes()


class OctreeGeoEncoder:
    """Geometric-context octree occupancy encoder (stream v4).  Per level,
    the caller supplies each node's occupancy byte and the in-level index
    of its -x/-y/-z face-neighbor node (or -1); contexts are built inside
    the C loop from causally-decoded neighbor bytes (native/coding.cpp
    oct_enc_level)."""

    def __init__(self):
        lib = self._lib = _load()
        self._h = lib.oct_enc_new()

    def write_level(self, occ: np.ndarray, nbr: np.ndarray,
                    plus_cnt: np.ndarray):
        occ = np.ascontiguousarray(occ, dtype=np.uint8)
        nbr = np.ascontiguousarray(nbr, dtype=np.int32)
        plus_cnt = np.ascontiguousarray(plus_cnt, dtype=np.uint8)
        assert nbr.shape == (len(occ), 3) and len(plus_cnt) == len(occ)
        self._lib.oct_enc_level(
            self._h, _u8(occ), _i32(nbr), _u8(plus_cnt), len(occ)
        )

    def finish(self) -> bytes:
        cap = 16 << 20
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.oct_enc_finish(self._h, _u8(out), cap)
        if n < 0:
            raise ValueError("oct_enc_finish overflow")
        self._lib.oct_enc_free(self._h)
        self._h = None
        return out[:n].tobytes()


class OctreeGeoDecoder:
    def __init__(self, data: bytes):
        lib = self._lib = _load()
        self._buf = np.frombuffer(data, dtype=np.uint8)
        self._h = lib.oct_dec_new(_u8(self._buf), len(self._buf))

    def read_level(self, nbr: np.ndarray, plus_cnt: np.ndarray) -> np.ndarray:
        nbr = np.ascontiguousarray(nbr, dtype=np.int32)
        plus_cnt = np.ascontiguousarray(plus_cnt, dtype=np.uint8)
        out = np.empty(len(nbr), dtype=np.uint8)
        self._lib.oct_dec_level(
            self._h, _i32(nbr), _u8(plus_cnt), len(nbr), _u8(out)
        )
        return out

    def close(self):
        if self._h is not None:
            self._lib.oct_dec_free(self._h)
            self._h = None


class AdaptiveByteDecoder:
    def __init__(self, data: bytes, n_ctx: int, model: int = 0):
        lib = self._lib = _load()
        self._buf = np.frombuffer(data, dtype=np.uint8)
        self._h = lib.abc_dec_new2(
            _u8(self._buf), len(self._buf), n_ctx, model
        )

    def read(self, ctxs: np.ndarray) -> np.ndarray:
        ctxs = np.ascontiguousarray(ctxs, dtype=np.uint32)
        out = np.empty(len(ctxs), dtype=np.uint8)
        self._lib.abc_dec_bytes(self._h, _u32(ctxs), len(ctxs), _u8(out))
        return out

    def close(self):
        if self._h is not None:
            self._lib.abc_dec_free(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Packed-occupancy coordinate extraction (decode hot host phase)
# ---------------------------------------------------------------------------


def extract_coords(bcoords: np.ndarray, bits: np.ndarray, log_bs: int,
                   stride: int = 1):
    """Native twin of ops.blocks.host_extract: expand MSB-first packed
    occupancy bits to int32 [n, 3] voxel coords in canonical block-scan
    order.  bcoords: int [nb, 3] block coords, bits: uint8 [nb, VOL // 8].

    Raises ValueError on a `bcoords` of another shape (the C side reads
    it as nb rows of 3), and RuntimeError when the C side extracts
    another count than the bits' popcount."""
    lib = _load()
    bc = np.ascontiguousarray(bcoords, dtype=np.int32)
    bb = np.ascontiguousarray(bits, dtype=np.uint8)
    nb, bpb = bb.shape
    if bc.ndim != 2 or bc.shape != (nb, 3):
        raise ValueError(f"bcoords must be [{nb}, 3] (one row per block of "
                         f"bits), got {list(bc.shape)}")
    total = lib.popcount_bytes(_u8(bb), nb * bpb)
    out = np.empty((int(total), 3), dtype=np.int32)
    n = lib.extract_coords(_i32(bc), _u8(bb), nb, bpb, log_bs, stride,
                           _i32(out), int(total))
    if n != total:
        raise RuntimeError(f"extract_coords returned {n} voxels, the "
                           f"popcount of the bits is {total}")
    return out
