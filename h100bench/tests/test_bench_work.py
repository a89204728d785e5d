"""The work counter against a brute-force count of pairs and bytes."""

import itertools
import json

import numpy as np
import torch

from h100bench import work as W
from h100bench.generate import torus_cloud
from h100bench.reference import sparse as S


def _brute_pairs(pts):
    s = {tuple(p) for p in pts}
    n = 0
    for p in s:
        for d in itertools.product((-1, 0, 1), repeat=3):
            n += (p[0] + d[0], p[1] + d[1], p[2] + d[2]) in s
    return n


def test_counts_match_brute_force(root):
    pts = torus_cloud(24, density=2.0, seed=3)
    keys = W.batch_keys([pts], "cpu")
    sets = W.sets_of(keys)
    coarse = {k: np.unique(np.asarray(pts) >> k, axis=0) for k in range(4)}
    for k in range(4):
        assert sets[f"S{k}"].shape[0] == len(coarse[k])
        assert W.neighbour_pairs(sets[f"S{k}"]) == _brute_pairs(coarse[k])
    for k, src in enumerate((3, 2, 1)):
        assert sets[f"C{k}"].shape[0] == 8 * len(coarse[src])
    cfg = json.loads((root / "h100bench/configs/pcgcv2-r4-bf16.json")
                     .read_text())
    entries = W.conv_work(cfg["convs"], sets, "bfloat16", training=False)
    by_name = {e["name"]: e for e in entries}
    c0 = by_name["encoder.conv0"]
    n0 = len(coarse[0])
    assert c0["flop"] == 2 * 1 * 16 * _brute_pairs(coarse[0])
    assert c0["bytes"] == (n0 * 1 + n0 * 16) * 2 + (27 * 16 + 16) * 2
    d0 = by_name["encoder.down0"]
    assert d0["flop"] == 2 * 16 * 32 * n0
    assert d0["bytes"] == (n0 * 16 + len(coarse[1]) * 32) * 2 \
        + (8 * 16 * 32 + 32) * 2
    up = by_name["decoder.up0"]
    assert up["flop"] == 2 * 8 * 64 * 8 * len(coarse[3])
    train = W.conv_work(cfg["convs"], sets, "bfloat16", training=True)
    passes = [e["pass_"] for e in train if e["name"] == "encoder.conv0"]
    assert passes == ["fwd", "dw"]  # the input carries no gradient
    assert len(train) == 3 * len(entries) - 1


def test_batch_sets_do_not_mix_items():
    a = torus_cloud(16, density=2.0, seed=1)
    keys = W.batch_keys([a, a], "cpu")
    assert keys.shape[0] == 2 * len(a)
    assert W.neighbour_pairs(keys) == 2 * _brute_pairs(a)
    assert S.batch_of(keys).tolist().count(1) == len(a)


def test_bound_takes_the_larger_side():
    e = [{"flop": 989e12, "bytes": 0.0}, {"flop": 0.0, "bytes": 3.35e12}]
    assert abs(W.bound_s(e, "bfloat16") - 2.0) < 1e-9
    assert abs(W.bound_s([{"flop": 165e12, "bytes": 1.0}], "float32")
               - 1.0) < 1e-9
    torch.manual_seed(0)
