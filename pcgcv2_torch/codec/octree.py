"""Lossless octree coordinate codec — the built-in base layer.

The reference codes bottleneck coordinates with the external MPEG G-PCC
`tmc3` binary (reference gpcc.py, coder.py:89,96).  That binary is an
optional external dependency here (see codec/gpcc.py for the subprocess
bridge with identical flags); this module is the self-contained default:
a breadth-first octree over Morton (z-order) keys whose occupancy bytes are
coded by the native context-adaptive binary range coder, each node's byte
conditioned on its parent's occupancy byte.

Morton keys make the whole codec a handful of vectorized numpy passes:
sorted Morton order groups children of a parent contiguously, so level
construction is `unique` + `reduceat`, and decoding is bit-expansion that
emits children already sorted.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from pcgcv2_torch.codec import native

_N_CTX = 257  # v1/v2: 1 root context + 256 parent-byte contexts
MAGIC = b"PCOC"   # v1: exponential-update probability model
MAGIC2 = b"PCO2"  # v2: Krichevsky-Trofimov count model (~20% fewer bits
#                   on per-frame streams; decode-supported)
MAGIC3 = b"PCO3"  # v3 (encode default): geometric contexts — each child bit
#                   conditioned on its three -axis face-adjacent CELLS
#                   (sibling bits of the same byte, or the causally-decoded
#                   byte of the -axis face-neighbor node: -axis neighbors
#                   always have smaller Morton keys), plus inferred last-bit
#                   (a node byte is never zero).  G-PCC tmc3's core context
#                   scheme; the bit loop lives in native/coding.cpp
#                   (oct_enc_level/oct_dec_level).


def _part1by2(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact1by2(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v ^ (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v ^ (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v ^ (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v ^ (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v ^ (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_encode(coords: np.ndarray) -> np.ndarray:
    """[N, 3] non-negative ints -> [N] uint64 Morton keys (x highest)."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    return (
        (_part1by2(x) << np.uint64(2))
        | (_part1by2(y) << np.uint64(1))
        | _part1by2(z)
    )


def morton_decode(keys: np.ndarray) -> np.ndarray:
    x = _compact1by2(keys >> np.uint64(2))
    y = _compact1by2(keys >> np.uint64(1))
    z = _compact1by2(keys)
    return np.stack([x, y, z], axis=1).astype(np.int32)


def _build_levels(leaf_keys: np.ndarray, depth: int):
    """Bottom-up occupancy pyramid: [(nodes, bytes)] root-first."""
    levels: List[Tuple[np.ndarray, np.ndarray]] = []
    ks = leaf_keys
    for _ in range(depth):
        parents = ks >> np.uint64(3)
        slots = (ks & np.uint64(7)).astype(np.uint8)
        first = np.concatenate([[True], parents[1:] != parents[:-1]])
        starts = np.flatnonzero(first)
        occ = np.bitwise_or.reduceat(
            (np.uint8(1) << slots).astype(np.uint8), starts
        )
        nodes = parents[starts]
        levels.append((nodes, occ))
        ks = nodes
    assert len(ks) == 1 and int(ks[0]) == 0, "octree did not reduce to root"
    levels.reverse()
    return levels


def _face_nbr_ctx(nodes: np.ndarray):
    """(nbr [n,3] int32, plus_cnt [n] uint8): index (within `nodes`, sorted
    Morton keys) of each node's -x/-y/-z face neighbor or -1, and the count
    of existing +axis face neighbors.  The Morton key is monotone per
    coordinate, so every -axis hit has a smaller index than the node itself
    — the causality the v3 bit contexts rely on; +axis neighbors are
    non-causal so only their (known) existence is used."""
    c = morton_decode(nodes).astype(np.int64)
    nbr = np.full((len(nodes), 3), -1, dtype=np.int32)
    plus = np.zeros(len(nodes), dtype=np.uint8)
    for axis in range(3):
        for step in (-1, 1):
            nc = c.copy()
            nc[:, axis] += step
            ok = nc[:, axis] >= 0
            nk = morton_encode(np.maximum(nc, 0))
            idx = np.searchsorted(nodes, nk)
            idx = np.minimum(idx, len(nodes) - 1)
            hit = ok & (nodes[idx] == nk)
            if step < 0:
                nbr[:, axis] = np.where(hit, idx, -1)
            else:
                plus += hit.astype(np.uint8)
    return nbr, plus


def encode(coords: np.ndarray, model: int = 2) -> bytes:
    """Losslessly encode unique non-negative int coordinates [N, 3].

    model: 0 = v1 (exp-update probs), 1 = v2 (KT counts, parent-byte
    context), 2 = v3 (geometric bit contexts — default).
    """
    assert coords.ndim == 2 and coords.shape[1] == 3
    assert (coords >= 0).all(), "octree codec needs non-negative coords"
    keys = np.unique(morton_encode(coords))
    n = len(keys)
    max_c = int(coords.max()) if n else 0
    depth = max(1, max_c.bit_length())

    levels = _build_levels(keys, depth)
    if model == 2:
        genc = native.OctreeGeoEncoder()
        for nodes, occ in levels:
            genc.write_level(occ, *_face_nbr_ctx(nodes))
        payload = genc.finish()
    else:
        enc = native.AdaptiveByteEncoder(_N_CTX, model=model)
        for d, (nodes, occ) in enumerate(levels):
            if d == 0:
                ctx = np.zeros(len(occ), dtype=np.uint32)
            else:
                pnodes, pocc = levels[d - 1]
                pidx = np.searchsorted(pnodes, nodes >> np.uint64(3))
                ctx = 1 + pocc[pidx].astype(np.uint32)
            enc.write(occ, ctx)
        payload = enc.finish()
    magic = {0: MAGIC, 1: MAGIC2, 2: MAGIC3}[model]
    return magic + struct.pack("<BI", depth, n) + payload


def decode(data: bytes) -> np.ndarray:
    """Inverse of `encode`: returns sorted unique [N, 3] int32 coords."""
    magic = data[:4]
    assert magic in (MAGIC, MAGIC2, MAGIC3), "bad octree stream"
    model = {MAGIC: 0, MAGIC2: 1, MAGIC3: 2}[magic]
    depth, n = struct.unpack("<BI", data[4:9])
    if model == 2:
        dec = native.OctreeGeoDecoder(data[9:])

        def read_level(nodes):
            return dec.read_level(*_face_nbr_ctx(nodes))
    else:
        bdec = native.AdaptiveByteDecoder(data[9:], _N_CTX, model=model)
        parent_occ_holder = {}

        def read_level(nodes):
            po = parent_occ_holder.get("po")
            if po is None:
                ctx = np.zeros(len(nodes), dtype=np.uint32)
            else:
                ctx = 1 + po.astype(np.uint32)
            return bdec.read(ctx)

        dec = bdec
    nodes = np.zeros(1, dtype=np.uint64)
    occ = read_level(nodes)
    for _ in range(depth - 1):
        bits = ((occ[:, None] >> np.arange(8, dtype=np.uint8)) & 1).astype(bool)
        child = (nodes[:, None] * np.uint64(8) + np.arange(8, dtype=np.uint64))[
            bits
        ]
        if model != 2:
            parent_occ_holder["po"] = np.repeat(occ, bits.sum(axis=1))
        occ = read_level(child)
        nodes = child
    # final level: expand leaves
    bits = ((occ[:, None] >> np.arange(8, dtype=np.uint8)) & 1).astype(bool)
    leaves = (nodes[:, None] * np.uint64(8) + np.arange(8, dtype=np.uint64))[bits]
    dec.close()
    assert len(leaves) == n, f"decoded {len(leaves)} leaves, expected {n}"
    return morton_decode(leaves)
