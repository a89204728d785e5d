"""The yardstick of work: FLOP and bytes of every conv of the published
architecture, counted from a cell's own coordinates with the reference's
key arithmetic, and the chip's peaks (`peaks.json`).

A conv's pairs are the (occupied output, occupied input) voxel pairs its
kernel joins: a 3^3 conv on a set X joins each voxel with the voxels of X
in its 3^3 neighbourhood, a 1^3 conv each voxel with itself, a stride-2
down-conv each fine voxel with its parent, a generative up-conv each
parent with its 8 children.  FLOP = 2 ci co pairs; bytes = (inputs ci +
outputs co) times the element size, plus the weights and bias, each read
or written once; occupied voxels only, never a block's empty slots.

The sets: S0 the input voxels, Sk = S0 >> k, and the decoder's candidates
Ck = children of the set it prunes from, counted on the ground truth one
scale coarser (C0 = children(S3), C1 = children(S2), C2 = children(S1)),
in the codec as in training, where the kept set holds the ground truth
and more.  Training counts the forward, the input gradient of every conv
whose input carries one (all but the first), and the weight gradient.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import torch

from h100bench.reference import sparse as S

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
ELT = {"bfloat16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    return float(PEAKS["flops"][dtype])


def hbm_bytes_per_s() -> float:
    return float(PEAKS["hbm_bytes_per_s"])


def sets_of(s0: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The sets a conv list names, from the input keys."""
    sets = {"S0": s0}
    for k in (1, 2, 3):
        sets[f"S{k}"] = S.coarser(sets[f"S{k - 1}"])
    for k, src in enumerate(("S3", "S2", "S1")):
        sets[f"C{k}"] = S.children(sets[src])
    return sets


def neighbour_pairs(keys: torch.Tensor) -> int:
    """Sum over the voxels of X of |3^3 neighbourhood within X|."""
    return int((S.neighbors(keys) < keys.shape[0]).sum())


def conv_work(convs: List[Dict], sets: Dict[str, torch.Tensor],
              dtype: str, training: bool) -> List[Dict]:
    """One entry per conv and pass: name, kind, pass ('fwd', 'dx', 'dw'),
    flop, bytes."""
    elt = ELT[dtype]
    size = {k: int(v.shape[0]) for k, v in sets.items()}
    pairs3 = {}
    out = []
    for c in convs:
        ci, co, kind = int(c["ci"]), int(c["co"]), c["kind"]
        src, dst = c["in"], c["out"]
        if kind == "conv3":
            if src not in pairs3:
                pairs3[src] = neighbour_pairs(sets[src])
            pairs, taps = pairs3[src], 27
        elif kind == "conv1":
            pairs, taps = size[src], 1
        elif kind == "down":
            pairs, taps = size[src], 8
        elif kind == "up":
            pairs, taps = size[dst], 8
        else:
            raise ValueError(f"unknown conv kind {kind!r}")
        flop = 2.0 * ci * co * pairs
        w_bytes = (taps * ci * co + co) * elt
        x_bytes, y_bytes = size[src] * ci * elt, size[dst] * co * elt
        out.append(dict(name=c["name"], kind=kind, pass_="fwd", flop=flop,
                        bytes=x_bytes + y_bytes + w_bytes))
        if training:
            if c.get("input_grad", True):
                out.append(dict(name=c["name"], kind=kind, pass_="dx",
                                flop=flop, bytes=x_bytes + y_bytes + w_bytes))
            out.append(dict(name=c["name"], kind=kind, pass_="dw", flop=flop,
                            bytes=x_bytes + y_bytes + taps * ci * co * 4
                            + co * 4))
    return out


def bound_s(entries: List[Dict], dtype: str) -> float:
    """Least time of the entries on the chip: per entry the larger of FLOP
    over the peak of `dtype` and bytes over HBM bandwidth, summed."""
    pf, bw = peak_flops(dtype), hbm_bytes_per_s()
    return sum(max(e["flop"] / pf, e["bytes"] / bw) for e in entries)


def batch_keys(clouds, device) -> torch.Tensor:
    """Sorted keys of a batch of [N_i, 3] clouds (batch ids 0..)."""
    rows = []
    for b, c in enumerate(clouds):
        t = torch.as_tensor(c, device=device).long()
        rows.append(torch.cat([torch.full((len(t), 1), b, device=device,
                                          dtype=torch.long), t], dim=1))
    return S.make_set(torch.cat(rows))
