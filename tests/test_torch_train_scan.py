"""Trainer.train_scanned / test_scanned with mode="scan" against
mode="loop", on the CPU at the tiny model.

On the card mode="scan" replays one captured CUDA graph per step
(chip_smoke.py, phase 7d, holds it against the loop there).  On the CPU
it runs the same steps eagerly over the graph's input buffers, so here
the two modes must agree exactly: parameters, records, lr, checkpoints
and the generator's state.  With tests/test_torch_train.py's step against
the JAX package and the JAX package's own scan-against-loop test, this
closes the chain JAX scan = JAX loop = port loop = port scan.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pcgcv2_torch import config as TCFG
from pcgcv2_torch.data.synthetic import sphere_cloud
from pcgcv2_torch.models import layers as TLY
from pcgcv2_torch.ops import blocks as TB
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


def _trainer(tmp, name, **cfg):
    c = TCFG.TrainConfig(**{"batch_size": 2, "check_time": 60.0, "lr": 1e-3,
                            **cfg})
    plan = TCFG.BlockPlan.for_training(2048, 32, 2)
    return TT.Trainer(c, plan, 2048, TINY, logdir=str(tmp / f"l{name}"),
                      ckptdir=str(tmp / f"c{name}"), device="cpu")


def _batches(n, seed=0):
    return [[sphere_cloud(24, 1.0, seed + 2 * i),
             sphere_cloud(24, 1.0, seed + 2 * i + 1)] for i in range(n)]


def _oversized():
    return [sphere_cloud(30, 4.0, 0), sphere_cloud(30, 4.0, 1)]


def _records(tr):
    """Every record() call of `tr`: (tag, step, copy of the record set)."""
    seen, real = [], tr.record

    def record(tag, step):
        seen.append((tag, step, {k: [np.array(v) for v in vs]
                                 for k, vs in tr.record_set.items()}))
        real(tag, step)

    tr.record = record
    return seen


def _same_records(a, b):
    assert [r[:2] for r in a] == [r[:2] for r in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert len(x[k]) == len(y[k]) > 0, k
            for u, v in zip(x[k], y[k]):
                np.testing.assert_array_equal(v, u, err_msg=k)


@pytest.mark.parametrize("cfg", [
    {"reset_optimizer_each_epoch": False, "lr_halve_every": 10},
    {"reset_optimizer_each_epoch": True, "lr_halve_every": 1},
], ids=["no_reset_same_lr", "reset_and_halving"])
def test_train_scanned_scan_matches_the_loop(tmp_path, cfg):
    """Two epochs of 2 batches and an oversized one (skipped) from one
    seed, mode="loop" and mode="scan": the same parameters, optimizer
    state, records, lr, checkpoints and generator state, bit for bit."""
    batches = _batches(2)
    batches = batches[:1] + [_oversized()] + batches[1:]
    loop, scan = (_trainer(tmp_path, f"{m}{cfg['lr_halve_every']}", **cfg)
                  for m in ("l", "s"))
    seen = [_records(tr) for tr in (loop, scan)]
    for _ in range(2):
        loop.train_scanned(batches, mode="loop")
        scan.train_scanned(batches, mode="scan")
    lr = 1e-3 / 2 if cfg["lr_halve_every"] == 1 else 1e-3
    assert (scan.epoch, scan.lr) == (loop.epoch, loop.lr) == (2, lr)
    assert float(scan.optimizer.param_groups[0]["lr"]) == np.float32(lr)
    for k, v in loop.model.state_dict().items():
        assert torch.equal(scan.model.state_dict()[k], v), k
    for p, q in zip(loop.model.parameters(), scan.model.parameters()):
        for k, v in loop.optimizer.state[p].items():
            assert torch.equal(scan.optimizer.state[q][k], v), k
    steps = {int(s["step"]) for s in scan.optimizer.state.values()}
    assert steps == ({2} if cfg["reset_optimizer_each_epoch"] else {4})
    assert torch.equal(loop.generator.get_state(),
                       scan.generator.get_state())
    assert [r[:2] for r in seen[1]] == [("Train", 2), ("Train", 10002)]
    _same_records(*seen)
    names = sorted(os.listdir(loop.ckptdir))
    assert names == sorted(os.listdir(scan.ckptdir)) == ["epoch_0.ckpt",
                                                          "epoch_1.ckpt"]
    for name in names:
        a = TT.load_params(os.path.join(loop.ckptdir, name))
        b = TT.load_params(os.path.join(scan.ckptdir, name))
        np.testing.assert_equal(b, a)
    assert scan.graph_replays == 0  # no graph on the CPU


def test_test_scanned_scan_matches_the_loop(tmp_path):
    tr = _trainer(tmp_path, "t")
    seen = _records(tr)
    batches = _batches(2, seed=10) + [_oversized()]
    tr.test_scanned(batches, mode="loop")
    tr.test_scanned(batches, mode="scan")
    assert [r[:2] for r in seen] == [("Test", 0), ("Test", 0)]
    _same_records(seen[:1], seen[1:])


def test_scan_calls_the_step_on_one_pair_of_buffers(tmp_path):
    """mode="scan" copies each batch into one pair of input buffers and
    runs the step on them (what a graph captures); mode="loop" hands the
    step each batch's own slice."""
    tr = _trainer(tmp_path, "b")
    coords_all, valid_all = tr._stacked(_batches(3, seed=20))
    for mode in ("loop", "scan"):
        calls = []

        def fn(c, v):
            calls.append((c, v, c.clone(), v.clone()))
            return torch.stack([c.float().sum(), v.float().sum()])

        rows = tr._run(fn, coords_all, valid_all, mode)
        assert len(calls) == 3
        ptrs = {(c.data_ptr(), v.data_ptr()) for c, v, _, _ in calls}
        assert len(ptrs) == (1 if mode == "scan" else 3)
        for i, (_, _, c, v) in enumerate(calls):
            assert torch.equal(c, coords_all[i])
            assert torch.equal(v, valid_all[i])
        np.testing.assert_array_equal(
            rows, [[float(coords_all[i].sum()), float(valid_all[i].sum())]
                   for i in range(3)])


@pytest.mark.parametrize("fn", ["train_scanned", "test_scanned"])
def test_unknown_mode_raises(tmp_path, fn):
    """An unknown mode raises before any step or record."""
    tr = _trainer(tmp_path, f"m{fn}")
    seen = _records(tr)
    with pytest.raises(ValueError, match="unknown mode"):
        getattr(tr, fn)(_batches(1), mode="lax")
    assert tr.epoch == 0 and not seen and not os.listdir(tr.ckptdir)


@pytest.fixture
def _bf16():
    old = TB.COMPUTE_DTYPE
    TB.set_compute_dtype("bfloat16")
    yield torch.bfloat16
    TB.set_compute_dtype(old)


def test_forget_casts_recomputes_from_the_current_parameters(_bf16):
    """A replayed graph writes the parameters without Python, so the
    layers' cache key (data_ptr, version) does not move: without
    forget_casts the next weights() / packed() / packed_flip() would read
    the old cast (bf16, the card's compute dtype, where the cast is a
    copy).  After it they are made anew from the parameters."""
    torch.manual_seed(0)
    model = torch.nn.ModuleDict({"a": TLY.BConv3(4, 8),
                                 "b": TLY.BConv1(4, 8)})
    for m in model.values():
        with torch.no_grad():
            m.kernel.normal_()
            m.bias.normal_()
    conv, proj = model["a"], model["b"]
    old = (conv.weights()[0].clone(), conv.packed().clone(),
           conv.packed_flip().clone(), proj.weights()[1].clone())
    # an in-place write the version counter does not see, as a replay's
    for m in model.values():
        m.kernel.data.add_(1.0)
        m.bias.data.add_(1.0)

    def now():
        return (conv.weights()[0], conv.packed(), conv.packed_flip(),
                proj.weights()[1])

    for a, b in zip(now(), old):  # stale: the key did not move
        assert torch.equal(a, b)
    TLY.forget_casts(model)
    k = conv.kernel.detach().to(_bf16)
    want = (k, TK.pack_weight(k), TK.pack_weight(TK.flip_weight(k)),
            proj.bias.detach().to(_bf16))
    for a, b, w in zip(now(), old, want):
        assert torch.equal(a, w) and not torch.equal(a, b)


@pytest.mark.parametrize("device,steps,want", [
    ("cpu", 10 ** 6, "loop"),
    ("cuda", TT.SCAN_MIN_STEPS - 1, "loop"),
    ("cuda", TT.SCAN_MIN_STEPS, "scan"),
], ids=["cpu", "card_below", "card_from"])
def test_pick_mode(tmp_path, device, steps, want):
    """With no mode, the card takes the graph from SCAN_MIN_STEPS steps a
    call on and the CPU never does; a mode asked for is kept."""
    tr = _trainer(tmp_path, f"p{device}{steps}")
    tr.device = torch.device(device)
    assert tr._pick_mode(None, steps) == want
    for mode in ("loop", "scan"):
        assert tr._pick_mode(mode, steps) == mode


def test_no_mode_on_the_cpu_runs_the_loop(tmp_path):
    tr = _trainer(tmp_path, "n")
    modes, real = [], tr._run

    def run(fn, coords_all, valid_all, mode):
        modes.append(mode)
        return real(fn, coords_all, valid_all, mode)

    tr._run = run
    tr.train_scanned(_batches(1))
    tr.test_scanned(_batches(1, seed=10))
    assert modes == ["loop", "loop"] and tr.epoch == 1


@pytest.mark.parametrize("edit", ["capturable", "float_lr"])
def test_restore_state_keeps_this_trainers_optimizer(tmp_path, edit):
    """A train state whose optimizer groups differ from this trainer's
    resumes as one that does not: groups that say capturable=True (a
    state written on the card) or hold the lr as a float (the layout from
    before the lr was a tensor).  The restored optimizer keeps this
    trainer's settings, its own lr tensor at the restored lr, and takes
    the same next epoch, bit for bit (no reset: the epoch reads the
    restored moments)."""
    cfg = {"reset_optimizer_each_epoch": False}
    a = _trainer(tmp_path, f"ra{edit}", **cfg)
    a.train_scanned(_batches(1))
    path = a.save_state()
    state = torch.load(path, map_location="cpu", weights_only=True)
    for group in state["optimizer"]["param_groups"]:
        if edit == "capturable":
            group["capturable"] = True
        else:
            group["lr"] = float(group["lr"])
    other = os.path.join(a.ckptdir, "edited.ckpt")
    torch.save(state, other)
    trs = {}
    for name, p in (("same", path), ("edited", other)):
        tr = _trainer(tmp_path, f"r{name}{edit}", **cfg)
        lr_t = tr.optimizer.param_groups[0]["lr"]
        tr.restore_state(p)
        group = tr.optimizer.param_groups[0]
        assert group["capturable"] is False
        assert torch.is_tensor(group["lr"]) and group["lr"] is not lr_t
        assert float(group["lr"]) == np.float32(a.lr)
        assert all(s["step"].device.type == "cpu"
                   for s in tr.optimizer.state.values())
        tr.train_scanned(_batches(1, seed=30))
        trs[name] = tr
    for k, v in trs["same"].model.state_dict().items():
        assert torch.equal(trs["edited"].model.state_dict()[k], v), k
    assert int(next(iter(trs["edited"].optimizer.state.values()))["step"]) \
        == 2
