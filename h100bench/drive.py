"""The two drivers of the system under test, `pcgcv2_torch`: a closed-loop
codec client (`Coder.encode` then `Coder.decode`, frame after frame) and
the training loop (`Trainer.train_scanned` calls).  Each records what the
window did (host-clock spans around its calls into the port) and keeps
what the check needs; nothing here judges.

Spans are the benchmark's own: around `Coder.encode` / `Coder.decode`,
around the coder's `feature_coder` and `coordinate_coder` calls (host
coding), and around each `train_scanned` call, each also a
`record_function` (`bench.*`) in a traced stretch.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from h100bench import generate


class _Span:
    """Adds the wall seconds of each call of obj.name to acc[key]."""

    def __init__(self, obj, name: str, acc: Dict[str, float], key: str):
        import torch

        self._fn = getattr(obj, name)
        self._acc, self._key = acc, key
        self._rf = torch.profiler.record_function
        setattr(obj, name, self)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        with self._rf(f"bench.{self._key}"):
            out = self._fn(*args, **kwargs)
        self._acc[self._key] = (self._acc.get(self._key, 0.0)
                                + time.perf_counter() - t0)
        return out


class CodecDriver:
    """One closed-loop client coding the mix's frames."""

    kind = "codec"

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, workdir: str,
                 root: str):
        import torch

        from pcgcv2_torch.checkpoint import load_params
        from pcgcv2_torch.codec.coder import Coder
        from pcgcv2_torch.ops import blocks as B

        self.torch = torch
        B.set_compute_dtype(cfg["compute_dtype"])
        self.rho = float(mix.get("rho", 1.0))
        self.load = generate.CodecLoad(mix, seed, device)
        self.coder = Coder(load_params(os.path.join(root, cfg["weights"])),
                           os.path.join(workdir, "frame"),
                           res=int(mix["res"]),
                           streamed_slabs=int(mix.get("streamed_slabs", 0)),
                           device=device)
        self._spans: Dict[str, float] = {}
        c = self.coder
        for obj, key in ((c.feature_coder, "feature_coder"),
                         (c.coordinate_coder, "coordinate_coder")):
            _Span(obj, "encode", self._spans, key)
            _Span(obj, "decode", self._spans, key)
        self.records: List[Dict] = []
        self.outputs: Dict[int, Dict] = {}

    def warm(self) -> None:
        """One encode + decode of each pool frame, unshifted."""
        for frame in self.load.pool:
            self.coder.encode(frame, "_warm")
            self.coder.decode(self.rho, "_warm")

    def step(self, i: int, profiled: bool = False,
             stretch: bool = False) -> int:
        """Code frame i; returns its voxels.  `profiled`: under the
        profiler; `stretch`: inside the traced stretch."""
        rf = self.torch.profiler.record_function
        frame = self.load.frame(i)
        self._spans.clear()
        t0 = time.perf_counter()
        with rf("bench.encode"):
            xyz, q = self.coder.encode(frame)
        t1 = time.perf_counter()
        with rf("bench.decode"):
            dec = self.coder.decode(self.rho)
        t2 = time.perf_counter()
        self.records.append(dict(
            index=i, voxels=len(frame), encode_s=t1 - t0, decode_s=t2 - t1,
            coding_s=sum(self._spans.values()), profiled=profiled,
            stretch=stretch, bytes=self.coder.bitstream_bytes(), decoded=len(dec)))
        self.outputs[i] = dict(latent_xyz=xyz, latents_q=q, decoded=dec)
        return len(frame)

    def release(self) -> None:
        del self.coder


class TrainDriver:
    """The trainer of the mix, fine-tuning from the configuration's
    weights, driven by whole `train_scanned` calls."""

    kind = "train"

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, workdir: str,
                 root: str):
        import torch

        from pcgcv2_torch.config import BlockPlan, TrainConfig
        from pcgcv2_torch.ops import blocks as B
        from pcgcv2_torch.train.trainer import Trainer

        self.torch = torch
        B.set_compute_dtype(cfg["compute_dtype"])
        self.load = generate.TrainLoad(mix, seed)
        tc = TrainConfig(
            alpha=float(mix["alpha"]), beta=float(mix["beta"]),
            lr=float(mix["lr"]), weight_decay=float(mix["weight_decay"]),
            batch_size=int(mix["batch_size"]), lr_halve_every=10 ** 9,
            reset_optimizer_each_epoch=False)
        self.plan = BlockPlan.for_training(int(mix["capacity"]),
                                           int(mix["res"]),
                                           int(mix["batch_size"]))
        self.trainer = Trainer(
            tc, self.plan, int(mix["capacity"]),
            logdir=os.path.join(workdir, "logs"),
            ckptdir=os.path.join(workdir, "ckpts"),
            init_ckpt=os.path.join(root, cfg["weights"]), seed=seed,
            device=device)
        self.rows: List[np.ndarray] = []
        record_rows = self.trainer._record_rows

        def keep_rows(rows, first):
            self.rows.extend(np.array(r) for r in rows)
            return record_rows(rows, first)

        self.trainer._record_rows = keep_rows
        self.records: List[Dict] = []
        self.check_batches = None
        self.snap: Dict = {}

    def warm(self) -> None:
        """The window's first call, driven as every window call is (the
        mix's batches, no mode given, so that on the card the trainer
        takes its captured graph: an eager first step, then replays).  It
        warms every shape and gives the check its three steps: the first
        gradient, read from Adam's first moment after the call's first
        step, and the parameters after its third (the second replay), both
        kept by hooks that come off before the window."""
        torch = self.torch
        first = self.load.call()
        self.check_batches = first[:3]
        tr = self.trainer
        opt = tr.optimizer
        params = list(tr.model.named_parameters())
        done = {"steps": 0, "capturing": False}
        kept: Dict[str, Dict] = {}

        def executed() -> None:
            done["steps"] += 1
            if done["steps"] == 1:
                kept["exp_avg"] = {
                    n: opt.state.get(p, {}).get("exp_avg",
                                                torch.zeros_like(p))
                    .detach().float().clone() for n, p in params}
            elif done["steps"] == 3:
                kept["params"] = {n: p.detach().float().clone()
                                  for n, p in params}

        train_row, capture = tr._train_row, tr._capture

        def row_hook(*args):
            out = train_row(*args)
            if not done["capturing"]:
                executed()
            return out

        class Replays:
            def __init__(self, graph):
                self.graph = graph

            def replay(self):
                self.graph.replay()
                executed()

        def capture_hook(fn, static, stream):
            done["capturing"] = True
            try:
                graph, row = capture(fn, static, stream)
            finally:
                done["capturing"] = False
            return Replays(graph), row

        tr._train_row, tr._capture = row_hook, capture_hook
        try:
            tr.train_scanned(first)
        finally:
            del tr._train_row, tr._capture
        if done["steps"] != len(first) or len(kept) != 2:
            raise RuntimeError(f"the check call ran {done['steps']} of "
                               f"{len(first)} steps")
        self.snap = {k: {n: t.cpu().numpy() for n, t in v.items()}
                     for k, v in kept.items()}
        self.snap["rows"] = list(self.rows[:3])
        self.snap["noise_rows"] = int(self.plan.nb[3])

    def step(self, i: int, profiled: bool = False,
             stretch: bool = False) -> int:
        batches = self.load.call()
        n = generate.voxels(batches)
        t0 = time.perf_counter()
        with self.torch.profiler.record_function("bench.train_scanned"):
            self.trainer.train_scanned(batches)
        self.records.append(dict(index=i, wall_s=time.perf_counter() - t0,
                                 steps=len(batches), voxels=n,
                                 profiled=profiled, stretch=stretch,
                                 batches=batches))
        return n

    def release(self) -> None:
        del self.trainer
