"""The port's stage spans (pcgcv2_torch/obs.py) on the CPU, at the tiny
model: off, a span is one shared no-op and no `record_function` is
entered; under `torch.profiler` every stage of `Coder.encode`,
`Coder.decode` (monolithic and streamed), `Trainer.train_scanned` and a
conv3 plan search appears, as often as the stage runs, inside its parent
span, with the stage spans of one parent in sequence.
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pcgcv2_torch import config as TCFG
from pcgcv2_torch import obs
from pcgcv2_torch.checkpoint import params_to_jax
from pcgcv2_torch.codec.coder import Coder
from pcgcv2_torch.data.synthetic import sphere_cloud
from pcgcv2_torch.models.pcc import PCCModel
from pcgcv2_torch.ops import conv3 as TK
from pcgcv2_torch.train import trainer as TT
from tests._tiny import TINY_MODEL

TINY = TCFG.ModelConfig(**dataclasses.asdict(TINY_MODEL))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coders(tmp_path_factory):
    """A monolithic and a 2-slab streamed coder on one file set, with one
    frame encoded into it."""
    model = PCCModel(TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    params = params_to_jax(model)
    name = str(tmp_path_factory.mktemp("obs") / "frame")
    kw = dict(res=64, model_config=TINY, input_granularity=4096,
              device="cpu")
    mono = Coder(params, name, **kw)
    streamed = Coder(params, name, streamed_slabs=2, **kw)
    cloud = sphere_cloud(48, density=1.5, seed=3)
    mono.encode(cloud)
    return dict(mono=mono, streamed=streamed, cloud=cloud)


def _spans(fn, tmp):
    """fn() under a CPU profiler: {index: (name, start, end, parent
    index)} of its `pcgc.*` spans, read from the exported trace, the
    parent being the shortest other span that holds it (None for none)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name", "").startswith("pcgc.")]
    out = {}
    for i, (name, a, b) in enumerate(spans):
        holders = [(b1 - a1, j) for j, (_, a1, b1) in enumerate(spans)
                   if j != i and a1 <= a and b <= b1]
        out[i] = (name, a, b, min(holders)[1] if holders else None)
    return out


def _check_tree(spans, expected):
    """The spans as `expected` (a Counter of (name, parent name)), and
    the children of one parent in sequence."""
    pairs = collections.Counter()
    children = collections.defaultdict(list)
    for name, a, b, pid in spans.values():
        parent = spans.get(pid)
        pairs[name, parent and parent[0]] += 1
        children[pid].append((a, b, name))
    assert pairs == expected
    for kids in children.values():
        kids.sort()
        for (_, b0, n0), (a1, _, n1) in zip(kids, kids[1:]):
            assert b0 <= a1, f"{n0} overlaps {n1}"


def _tree(parent, *names, n=1):
    return collections.Counter({(name, parent): n for name in names})


ENC = _tree(None, "pcgc.encode") + _tree(
    "pcgc.encode", "pcgc.encode.unique_rows", "pcgc.encode.block_counts",
    "pcgc.encode.upload", "pcgc.encode.network", "pcgc.encode.fetch",
    "pcgc.encode.order", "pcgc.rans.encode", "pcgc.octree.encode")
DEC = _tree(None, "pcgc.decode") + _tree(
    "pcgc.decode", "pcgc.octree.decode", "pcgc.rans.decode",
    "pcgc.decode.unpack", "pcgc.decode.network", "pcgc.decode.fetch",
    "pcgc.decode.host_extract")
# the streamed stage's spans lie inside .network, the slab bounds' fetch
# among them
STREAMED = DEC + _tree(
    "pcgc.decode.network", "pcgc.decode.coarse", "pcgc.decode.fetch",
    "pcgc.decode.topk") + _tree("pcgc.decode.network", "pcgc.decode.slab",
                                n=2)


# a frame that is not sorted-unique: the intake's dedup runs, once
UNSORTED = ENC + _tree("pcgc.encode.unique_rows", "pcgc.encode.dedup")


@pytest.mark.parametrize("call", ["encode", "decode", "streamed",
                                  "encode_unsorted"])
def test_codec_spans(coders, call, tmp_path):
    cloud = coders["cloud"]
    unsorted = np.concatenate([cloud[::-1], cloud[:5]])
    fn, expected = {
        "encode": (lambda: coders["mono"].encode(cloud), ENC),
        "encode_unsorted": (lambda: coders["mono"].encode(unsorted),
                            UNSORTED),
        "decode": (coders["mono"].decode, DEC),
        "streamed": (coders["streamed"].decode, STREAMED)}[call]
    _check_tree(_spans(fn, tmp_path), expected)


def test_off_enters_no_record_function(coders, monkeypatch, tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert obs.span("pcgc.a") is obs.span("pcgc.b")
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    coders["mono"].encode(coders["cloud"])
    coders["mono"].decode()
    assert entered == []
    # the same patch sees every span of a profiled call
    spans = _spans(coders["mono"].decode, tmp_path)
    assert sorted(entered) == sorted(n for n, *_ in spans.values())


@pytest.mark.parametrize("mode", ["loop", "scan"])
def test_train_scanned_spans(tmp_path, mode):
    c = TCFG.TrainConfig(batch_size=1, check_time=60.0, lr=1e-3)
    plan = TCFG.BlockPlan.for_training(1024, 16, 1)
    tr = TT.Trainer(c, plan, 1024, TINY, logdir=str(tmp_path / "l"),
                    ckptdir=str(tmp_path / "c"), device="cpu")
    batches = [[sphere_cloud(12, 1.0, i)] for i in range(2)]
    spans = _spans(lambda: tr.train_scanned(batches, mode=mode), tmp_path)
    _check_tree(spans, _tree(None, "pcgc.train.call") + _tree(
        "pcgc.train.call", "pcgc.train.collate", "pcgc.train.upload",
        "pcgc.train.fetch", "pcgc.train.record", "pcgc.train.save_model")
        + _tree("pcgc.train.call", "pcgc.train.step", n=2))


@pytest.mark.parametrize("plan, args", [
    (TK._tc_plan, (16, 32, torch.bfloat16, 16)),
    (TK.wgrad_plan, (16, 32, torch.bfloat16, torch.bfloat16, 16))])
def test_plan_search_spanned_on_a_miss_only(plan, args, tmp_path):
    plan.cache_clear()
    first = _spans(lambda: plan(*args), tmp_path)
    again = _spans(lambda: plan(*args), tmp_path)
    assert [v[0] for v in first.values()] == ["pcgc.conv3.plan"]
    assert again == {}
