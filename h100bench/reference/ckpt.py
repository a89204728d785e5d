"""Reader of the `.ckpt` weight files: flax `serialization.to_bytes`
output, a msgpack map tree whose array leaves are msgpack ext objects of
type 1 holding a nested msgpack triple (shape, dtype name, raw bytes);
numpy scalars are type 3 with the same triple.

A frozen copy of the subset decoder the port reads its checkpoints with,
kept here so that the reference reads the weights without the port and
no change to the port moves it.  `leaves` flattens the tree to the
parameter names the port's state dict uses (`encoder.conv0.kernel`).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.d = memoryview(data)
        self.i = 0

    def _take(self, n: int) -> memoryview:
        if self.i + n > len(self.d):
            raise ValueError("truncated msgpack data")
        out = self.d[self.i:self.i + n]
        self.i += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, payload: bytes):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(payload).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype))
        if code == _EXT_NPSCALAR:
            return arr[0]
        return arr.reshape(tuple(shape)).copy()

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        fixed = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self._unpack(fixed[b])
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self._take(n), "utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            n = 1 << (b - 0xD4)
            code = self._unpack(">b")
            return self._ext(code, bytes(self._take(n)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self._unpack(">b")
            return self._ext(code, bytes(self._take(n)))
        raise ValueError(f"unsupported msgpack marker 0x{b:02x}")

    def _map(self, n: int) -> Dict:
        return {self.read(): self.read() for _ in range(n)}


def load(path: str) -> Dict[str, np.ndarray]:
    """The weight file as {dotted parameter name: float32 array}."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    tree = r.read()
    if r.i != len(r.d):
        raise ValueError("trailing bytes after the msgpack tree")
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[".".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(tree, ())
    return out


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()
