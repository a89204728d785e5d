"""Plain PyTorch sparse voxel operations of the reference, on per-voxel
lists (no blocks, no kernels of the port).

A voxel set is a sorted int64 key per voxel: batch, then x, y, z, each
coordinate stored plus one in 13 bits, so that a neighbour one step below
0 stays in range and sorting the keys sorts by (batch, x, y, z).
Features are [N, C] float32 rows in key order.

Every product goes through `mm`, which rounds its operands to the
precision under test first and multiplies exactly in float32 (TF32 off):
"f32" leaves them as they are, "tf32" and "bf16" round them to those
formats (round to nearest even), "fp8" scales each operand by its largest
magnitude and rounds it to float8 e4m3.  So a control in a lower precision
is the same code with another setting, on the CPU as on the card.
"""

from __future__ import annotations

import contextlib

import torch

AXIS_BITS = 13
_MASK = (1 << AXIS_BITS) - 1
PRECISIONS = ("f32", "tf32", "bf16", "fp8")
_FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls without TF32 for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (float32) rounded to `precision` and returned as float32."""
    if precision == "f32":
        return x
    if precision == "tf32":
        return _tf32(x)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundSTE(torch.autograd.Function):
    """Operand rounding with the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x, precision):
        return round_to(x, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a @ b
    return _RoundSTE.apply(a, precision) @ _RoundSTE.apply(b, precision)


# ---------------------------------------------------------------------------
# Voxel sets
# ---------------------------------------------------------------------------


def pack(coords: torch.Tensor) -> torch.Tensor:
    """int [N, 4] (batch, x, y, z), coordinates in [-1, 2^13 - 2] -> keys."""
    c = coords.long()
    k = c[:, 0]
    for a in (1, 2, 3):
        k = (k << AXIS_BITS) | (c[:, a] + 1)
    return k


def unpack(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack`: int64 [N, 4]."""
    z = (keys & _MASK) - 1
    y = ((keys >> AXIS_BITS) & _MASK) - 1
    x = ((keys >> (2 * AXIS_BITS)) & _MASK) - 1
    b = keys >> (3 * AXIS_BITS)
    return torch.stack([b, x, y, z], dim=1)


def make_set(coords: torch.Tensor) -> torch.Tensor:
    """Sorted unique keys of int [N, 4] voxel rows."""
    return torch.unique(pack(coords))


def lookup(keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted `keys`, len(keys) where absent."""
    n = keys.shape[0]
    pos = torch.searchsorted(keys, query).clamp_max(max(n - 1, 0))
    hit = (keys[pos] == query) if n else torch.zeros_like(query, dtype=bool)
    return torch.where(hit, pos, n)


def isin(keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    return lookup(keys, query) < keys.shape[0]


def coarser(keys: torch.Tensor) -> torch.Tensor:
    """The set one scale coarser: (b, x >> 1, y >> 1, z >> 1), unique."""
    c = unpack(keys)
    c[:, 1:] = c[:, 1:] >> 1
    return torch.unique(pack(c))


def children(keys: torch.Tensor) -> torch.Tensor:
    """The 8 children 2p + o of every voxel p, unique and sorted: the
    candidates of a decoder stage."""
    return torch.unique(_children_unsorted(keys))


def _children_unsorted(keys: torch.Tensor) -> torch.Tensor:
    c = unpack(keys)
    o = octant_offsets(keys.device)
    cc = c[:, None, :].repeat(1, 8, 1)
    cc[:, :, 1:] = cc[:, :, 1:] * 2 + o[None]
    return pack(cc.reshape(-1, 4))


def octant_offsets(device) -> torch.Tensor:
    """[8, 3] child offsets (dx, dy, dz), index dx*4 + dy*2 + dz."""
    d = torch.arange(8, device=device)
    return torch.stack([d >> 2, (d >> 1) & 1, d & 1], dim=1)


def neighbors(keys: torch.Tensor) -> torch.Tensor:
    """[27, N] row of the neighbour p + (dx-1, dy-1, dz-1), tap index
    dx*9 + dy*3 + dz; N (the zero row) where it is not in the set."""
    c = unpack(keys)
    out = []
    for t in range(27):
        d = torch.tensor([0, t // 9 - 1, (t // 3) % 3 - 1, t % 3 - 1],
                         device=keys.device)
        out.append(lookup(keys, pack(c + d)))
    return torch.stack(out)


def batch_of(keys: torch.Tensor) -> torch.Tensor:
    return keys >> (3 * AXIS_BITS)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


class _Conv3(torch.autograd.Function):
    """out = b + sum over taps of x[neighbour] @ W[tap]; the backward
    gathers again instead of keeping 27 gathered copies."""

    @staticmethod
    def forward(ctx, x, w, b, nbr, precision):
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        out = b.expand(x.shape[0], -1).clone()
        for t in range(27):
            out += mm(xp[nbr[t]], w[t], precision)
        ctx.save_for_backward(x, w, nbr)
        ctx.precision = precision
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, nbr = ctx.saved_tensors
        p = ctx.precision
        n = x.shape[0]
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        dx = x.new_zeros(n + 1, x.shape[1])
        dw = torch.empty_like(w)
        for t in range(27):
            dx.index_add_(0, nbr[t], mm(dy, w[t].T, p))
            dw[t] = mm(xp[nbr[t]].T, dy, p)
        return dx[:n], dw, dy.sum(0), None, None


def conv3(x, nbr, kernel, bias, precision):
    """3^3 stride-1 sparse conv; kernel [3, 3, 3, ci, co]."""
    ci, co = kernel.shape[3], kernel.shape[4]
    return _Conv3.apply(x, kernel.reshape(27, ci, co), bias, nbr, precision)


def conv1(x, kernel, bias, precision):
    """1^3 conv; kernel [1, ci, co]."""
    return mm(x, kernel[0], precision) + bias


def _octant(keys: torch.Tensor) -> torch.Tensor:
    c = unpack(keys)
    return (c[:, 1] & 1) * 4 + (c[:, 2] & 1) * 2 + (c[:, 3] & 1)


def down(x, fine, coarse, kernel, bias, precision):
    """Kernel-2 stride-2 conv: out[q] = b + sum over the occupied children
    2q + o of x[child] @ W[o]; kernel [8, ci, co]."""
    c = unpack(fine)
    c[:, 1:] = c[:, 1:] >> 1
    parent = lookup(coarse, pack(c))
    o = _octant(fine)
    out = bias.expand(coarse.shape[0], -1)
    for k in range(8):
        sel = torch.nonzero(o == k).reshape(-1)
        out = out.index_add(0, parent[sel],
                            mm(x[sel], kernel[k], precision))
    return out


def up(x, coarse, kernel, bias, precision):
    """Generative kernel-2 stride-2 transposed conv: every voxel p emits
    its 8 children 2p + o with x[p] @ W[o] + b.  Returns (children keys,
    sorted, and their features)."""
    n, co = x.shape[0], kernel.shape[-1]
    raw = _children_unsorted(coarse)
    feats = torch.stack([mm(x, kernel[k], precision) for k in range(8)],
                        dim=1).reshape(n * 8, co) + bias
    order = torch.argsort(raw)
    return raw[order], feats[order]


def topk_keep(logits: torch.Tensor, keys: torch.Tensor,
              k_per_batch) -> torch.Tensor:
    """bool [N]: per batch item the k highest logits."""
    keep = torch.zeros_like(logits, dtype=torch.bool)
    b = batch_of(keys)
    for i, k in enumerate(k_per_batch):
        rows = torch.nonzero(b == i).reshape(-1)
        k = min(int(k), rows.numel())
        if k > 0:
            keep[rows[torch.topk(logits[rows], k).indices]] = True
    return keep
