"""Checkpoint reading without flax, and the crossing of JAX weights.

The `.ckpt` files are flax `serialization.to_bytes` output: a msgpack map
tree whose array leaves are msgpack ext objects of type 1 holding a nested
msgpack triple (shape, dtype name, raw bytes).  `load_params` decodes that
subset of msgpack directly (no msgpack package needed) into nested dicts of
numpy arrays — the same tree `pcgcv2_tpu.train.trainer.load_params` returns.

`params_from_jax` loads such a tree (or `model.init(...)` output converted
with `np.asarray`) into the port's `PCCModel`: parameter names are the flax
module paths, so `params/encoder/conv0/kernel` becomes the state-dict key
`encoder.conv0.kernel` with the same layout.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset flax checkpoints use."""

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
        if code == _EXT_NDARRAY:
            shape, dtype, raw = _Reader(payload).read()
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
                tuple(shape)).copy()
        if code == _EXT_NPSCALAR:
            dtype, raw = _Reader(payload).read()
            return np.frombuffer(raw, dtype=np.dtype(dtype))[0]
        raise ValueError(f"unsupported msgpack ext type {code}")

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
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xCA: lambda: self._unpack(">f"), 0xCB: lambda: self._unpack(">d"),
            0xCC: lambda: self._unpack(">B"), 0xCD: lambda: self._unpack(">H"),
            0xCE: lambda: self._unpack(">I"), 0xCF: lambda: self._unpack(">Q"),
            0xD0: lambda: self._unpack(">b"), 0xD1: lambda: self._unpack(">h"),
            0xD2: lambda: self._unpack(">i"), 0xD3: lambda: self._unpack(">q"),
        }
        if b in simple:
            return simple[b]()
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
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def loads(data: bytes) -> Dict[str, Any]:
    """Decode flax-msgpack bytes into a nested dict of numpy arrays."""
    r = _Reader(data)
    tree = r.read()
    if r.i != len(r.d):
        raise ValueError("trailing bytes after the msgpack tree")
    return tree


def load_params(path: str) -> Dict[str, Any]:
    """Read a `.ckpt` file into the JAX package's host parameter tree."""
    with open(path, "rb") as f:
        return loads(f.read())


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[".".join(prefix + (str(k),))] = v
    return out


def params_from_jax(tree, config=None, device="cuda"):
    """Build the port's PCCModel from a JAX parameter tree of numpy arrays.

    tree: `{"params": {...}}` or the inner `params` dict.  Every model
    parameter must be present with its exact shape (strict load)."""
    import torch

    from pcgcv2_torch.models.pcc import PCCModel
    from pcgcv2_torch.ops.blocks import resolve_device

    if "params" in tree:
        tree = tree["params"]
    model = PCCModel(config) if config is not None else PCCModel()
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in flatten(tree).items()}
    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device)).eval()
