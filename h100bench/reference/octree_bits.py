"""Ideal size of the coordinate stream: the octree of the latent voxels
coded bit by bit with adaptive Krichevsky-Trofimov counts per context.

The stream codes, level by level from the root and node by node in
Morton order, each node's 8 child-occupancy bits in slot order
s = dx*4 + dy*2 + dz.  A bit's context is its slot, the state (empty,
occupied, no node) of each of its three -axis face-adjacent cells (the
sibling s - w already coded on the + side of the node, else child s + w of
the -axis face-neighbour node), whether no earlier bit of the byte is set,
and how many of the node's +axis face-neighbour nodes exist; the last bit
of a byte whose other seven are 0 is implied and not coded.  With KT
counts the code length of a context's bits depends only on how many 0s and
1s it saw, log2(pi Gamma(n + 1) / (Gamma(n0 + 1/2) Gamma(n1 + 1/2))), so
the whole is a sum over contexts, written here in numpy.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln

_W = (4, 2, 1)


def _spread(v: np.ndarray) -> np.ndarray:
    """Bits of v (< 2^21) moved to every third position."""
    out = np.zeros(v.shape, dtype=np.uint64)
    v = v.astype(np.uint64)
    for i in range(21):
        out |= ((v >> np.uint64(i)) & np.uint64(1)) << np.uint64(3 * i)
    return out


def morton(coords: np.ndarray) -> np.ndarray:
    c = np.asarray(coords, dtype=np.int64)
    return ((_spread(c[:, 0]) << np.uint64(2)) | (_spread(c[:, 1])
            << np.uint64(1)) | _spread(c[:, 2]))


def _levels(keys: np.ndarray, depth: int):
    """[(node keys, occupancy bytes)] from the root down."""
    levels = []
    ks = keys
    for _ in range(depth):
        parents = ks >> np.uint64(3)
        bit = (np.uint8(1) << (ks & np.uint64(7)).astype(np.uint8))
        first = np.concatenate([[True], parents[1:] != parents[:-1]])
        starts = np.flatnonzero(first)
        levels.append((parents[starts],
                       np.bitwise_or.reduceat(bit.astype(np.uint8), starts)))
        ks = parents[starts]
    return levels[::-1]


def _unmorton(keys: np.ndarray) -> np.ndarray:
    out = np.zeros((len(keys), 3), dtype=np.int64)
    for i in range(21):
        for a, sh in enumerate((2, 1, 0)):
            b = (keys >> np.uint64(3 * i + sh)) & np.uint64(1)
            out[:, a] |= b.astype(np.int64) << i
    return out


def _contexts(nodes: np.ndarray, occ: np.ndarray):
    """(context id, bit) of every coded bit of one level."""
    c = _unmorton(nodes)
    nb = np.zeros((len(nodes), 3), dtype=np.int64)
    has = np.zeros((len(nodes), 3), dtype=bool)
    plus = np.zeros(len(nodes), dtype=np.int64)
    for a in range(3):
        for step in (-1, 1):
            nc = c.copy()
            nc[:, a] += step
            ok = nc[:, a] >= 0
            nk = morton(np.maximum(nc, 0))
            idx = np.minimum(np.searchsorted(nodes, nk), len(nodes) - 1)
            hit = ok & (nodes[idx] == nk)
            if step < 0:
                has[:, a] = hit
                nb[:, a] = np.where(hit, occ[idx], 0)
            else:
                plus += hit
    byte = occ.astype(np.int64)
    ctxs, bits = [], []
    for s in range(8):
        done = byte & ((1 << s) - 1)
        none_yet = (done == 0).astype(np.int64)
        coded = ~((s == 7) & (none_yet == 1))
        st = []
        for a in range(3):
            w = _W[a]
            if s & w:
                st.append((byte >> (s - w)) & 1)
            else:
                st.append(np.where(has[:, a], (nb[:, a] >> (s + w)) & 1, 2))
        ctx = ((((s * 27) + st[0] * 9 + st[1] * 3 + st[2]) * 2 + none_yet)
               * 4 + plus)
        ctxs.append(ctx[coded])
        bits.append(((byte >> s) & 1)[coded])
    return np.concatenate(ctxs), np.concatenate(bits)


def coordinate_bits(coords: np.ndarray) -> float:
    """Ideal bits of the octree payload of unique [N, 3] coordinates."""
    keys = np.unique(morton(coords))
    depth = max(1, int(np.asarray(coords).max()).bit_length())
    ctxs, bits = [], []
    for nodes, occ in _levels(keys, depth):
        c, b = _contexts(nodes, occ)
        ctxs.append(c)
        bits.append(b)
    ctx = np.concatenate(ctxs)
    bit = np.concatenate(bits)
    n = np.bincount(ctx)
    n1 = np.bincount(ctx, weights=bit, minlength=len(n))
    n0 = n - n1
    used = n > 0
    nats = (math.log(math.pi) + gammaln(n[used] + 1.0)
            - gammaln(n0[used] + 0.5) - gammaln(n1[used] + 0.5))
    return float(nats.sum() / math.log(2.0))
