"""Point-cloud geometry file I/O: PLY (ASCII + binary) and HDF5.

Covers the reference's readers/writers (data_utils.py:6-48) plus a binary
PLY fast path — the reference parses ASCII line-by-line in Python
(data_utils.py:19-34), a known time sink on million-point frames; here both
formats go through vectorized numpy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def read_h5_geo(path: str) -> np.ndarray:
    pc = h5py.File(path, "r")["data"][:]
    return pc[:, 0:3].astype(np.int32)


def write_h5_geo(path: str, coords: np.ndarray) -> None:
    data = coords.astype("uint8")
    with h5py.File(path, "w") as h:
        h.create_dataset("data", data=data, shape=data.shape)


def read_ply_geo(path: str) -> np.ndarray:
    """Read x,y,z from an ASCII or binary_little_endian PLY as int32."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(
            (ln.split()[1] for ln in header if ln.startswith("format")), "ascii"
        )
        n = next(
            int(ln.split()[-1])
            for ln in header
            if ln.startswith("element vertex")
        )
        props = [
            ln.split()[1:] for ln in header if ln.startswith("property")
        ]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            return np.round(data[:, 0:3]).astype(np.int32)
        if fmt == "binary_little_endian":
            np_types = {
                "float": "<f4", "float32": "<f4", "double": "<f8",
                "float64": "<f8", "int": "<i4", "int32": "<i4",
                "uint": "<u4", "uint32": "<u4", "short": "<i2",
                "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
                "char": "<i1", "int8": "<i1", "uchar": "<u1",
                "uint8": "<u1",
            }
            dtype = np.dtype([(nm, np_types[t]) for t, nm in props])
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
            xyz = np.stack(
                [rec["x"], rec["y"], rec["z"]], axis=1
            ).astype(np.float64)
            return np.round(xyz).astype(np.int32)
        raise ValueError(f"unsupported PLY format {fmt!r}")


# the reference's reader name, kept for API familiarity
read_ply_ascii_geo = read_ply_geo


def write_ply_ascii_geo(path: str, coords: np.ndarray) -> None:
    """ASCII PLY, same header the reference writes (data_utils.py:36-48) —
    required by the tmc3 and pc_error subprocess bridges."""
    coords = coords.astype(np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {coords.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        np.savetxt(f, coords, fmt="%d %d %d")


def write_ply_binary_geo(path: str, coords: np.ndarray) -> None:
    coords = coords.astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {coords.shape[0]}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"end_header\n")
        f.write(np.ascontiguousarray(coords, dtype="<f4").tobytes())


def load_coords(path: str) -> np.ndarray:
    """Dispatch by extension (ref load_sparse_tensor, data_utils.py:103)."""
    if path.endswith(".h5"):
        return read_h5_geo(path)
    if path.endswith(".ply"):
        return read_ply_geo(path)
    raise ValueError(f"unsupported point cloud file: {path}")
