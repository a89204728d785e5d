"""Checkpoints without flax, and the crossing of JAX weights.

The `.ckpt` files are flax `serialization.to_bytes` output: a msgpack map
tree whose array leaves are msgpack ext objects of type 1 holding a nested
msgpack triple (shape, dtype name, raw bytes); numpy scalars are type 3
with the same triple.  `load_params` decodes that subset of msgpack
directly (no msgpack package needed) into nested dicts of numpy arrays —
the same tree `pcgcv2_tpu.train.trainer.load_params` returns — and
`dumps` / `save_params` write parameter trees, so that the JAX package
reads the port's checkpoints.

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
            shape, dtype, raw = _Reader(payload).read()
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


def _length(out: bytearray, n: int, codes) -> None:
    """Append the header of a str, bin or ext object of n bytes: the
    smallest of its 8-, 16- and 32-bit length codes."""
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"a msgpack object of {n} bytes is too long")


def _count(out: bytearray, n: int, fix: int, code16: int) -> None:
    """Append the header of a map or array of n entries."""
    if n <= 15:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out += bytes([code16]) + struct.pack(">H", n)
    else:
        out += bytes([code16 + 1]) + struct.pack(">I", n)


def _pack(obj, out: bytearray) -> None:
    """msgpack of the subset parameter trees use, with the encodings a
    msgpack packer picks (so the bytes are flax's): maps of str keys,
    arrays as ext type 1 holding [shape, dtype name, raw bytes]."""
    if isinstance(obj, dict):
        _count(out, len(obj), 0x80, 0xDE)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, list):
        _count(out, len(obj), 0x90, 0xDC)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        if len(b) <= 31:
            out.append(0xA0 | len(b))
        else:
            _length(out, len(b), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, bytes):
        _length(out, len(obj), (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, int) and obj >= 0:  # array dimensions
        if obj <= 0x7F:
            out.append(obj)  # positive fixint
        else:
            code, fmt = next((c, f) for c, f, bits in (
                (0xCC, ">B", 8), (0xCD, ">H", 16), (0xCE, ">I", 32),
                (0xCF, ">Q", 64)) if obj < 1 << bits)
            out += bytes([code]) + struct.pack(fmt, obj)
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack([list(obj.shape), obj.dtype.name, obj.tobytes("C")], payload)
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + n.bit_length() - 1)  # fixext n
        else:
            _length(out, n, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY) + payload
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a checkpoint")


def dumps(tree) -> bytes:
    """Nested dicts of numpy arrays -> flax-msgpack bytes: the inverse of
    `loads`, byte for byte what flax's `to_bytes` writes."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def save_params(path: str, tree) -> None:
    """Write a parameter tree as a `.ckpt` file (flax `to_bytes` layout)."""
    with open(path, "wb") as f:
        f.write(dumps(tree))


def params_to_jax(model) -> Dict[str, Any]:
    """The port's PCCModel -> the JAX package's `{"params": {...}}` tree of
    float32 numpy arrays (the inverse of `params_from_jax`)."""
    import torch

    tree: Dict[str, Any] = {}
    for name, t in model.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return {"params": tree}


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[".".join(prefix + (str(k),))] = v
    return out


def load_into(model, tree):
    """Copy a JAX parameter tree (`{"params": {...}}` or the inner dict, of
    numpy arrays) into `model`'s parameters, in place, on their device.
    Every model parameter must be present with its exact shape."""
    import torch

    if "params" in tree:
        tree = tree["params"]
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in flatten(tree).items()}
    model.load_state_dict(state, strict=True)
    return model


def params_from_jax(tree, config=None, device="cuda"):
    """Build the port's PCCModel from a JAX parameter tree of numpy arrays.

    tree: `{"params": {...}}` or the inner `params` dict.  Every model
    parameter must be present with its exact shape (strict load)."""
    from pcgcv2_torch.models.pcc import PCCModel
    from pcgcv2_torch.ops.blocks import resolve_device

    model = PCCModel(config) if config is not None else PCCModel()
    load_into(model, tree)
    return model.to(resolve_device(device)).eval()
