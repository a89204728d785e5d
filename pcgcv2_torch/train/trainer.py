"""Training loop (twin of pcgcv2_tpu/train/trainer.py).

The recipe of the JAX package:
  * loss = alpha * sum of the per-scale BCE + beta * bpp;
  * Adam(0.9, 0.999) with weight decay 1e-4 added to the gradient before
    the moments (torch.optim.Adam's weight_decay: the optax chain
    add_decayed_weights -> scale_by_adam -> scale(-lr), not AdamW);
  * the optimizer state reset at the first step of every epoch, and the
    lr halved every `lr_halve_every` epochs, floored at lr_min;
  * weights-only checkpoints in the flax msgpack layout (`save_params`,
    `load_params`: the two packages read each other's), and the full train
    state (`save_state` / `restore_state`, a package-local torch.save file)
    for an exact resume.

`Trainer.train` / `test` collate and copy each batch as they reach it;
`train_scanned` / `test_scanned` (what scripts/train_rd.py calls) take an
epoch's batches at once: one host-to-device copy of the stacked batches,
the steps with nothing fetched between them, one packed fetch at the end.
Their `mode="loop"` runs the steps one by one.  `mode="scan"` is the
counterpart of the JAX package's one lax.scan dispatch per epoch:
on the card the epoch's first step runs eagerly, the second is captured as
one CUDA graph (forward with the noise, loss and metrics, backward through
the conv3 kernels, Adam update), and it and every later step replay it,
one graph launch per step after the copy of that step's batch into the
graph's input buffers.  The same steps on the same random numbers as the
loop: the trainer's generator is registered with the graph, so each replay
draws the next noise.  On the CPU, where the caller asks for it, the scan
runs the same steps over those buffers eagerly.  With no mode given, the
card takes the graph from SCAN_MIN_STEPS steps a call on and the loop
below that; the CPU takes the loop.

One step (`Trainer.step`) runs the forward with noise quantization, the
top-k union ground-truth prune, the loss and metrics, the backward (conv3's
through its CUDA kernels on the card) and the Adam update.  The training
noise comes from one torch.Generator on the trainer's device, seeded from
`seed`: its numbers are not the JAX PRNG's.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from pcgcv2_torch import checkpoint
from pcgcv2_torch.config import BlockPlan, ModelConfig, TrainConfig
from pcgcv2_torch.data.voxelize import collate
from pcgcv2_torch.models.layers import forget_casts
from pcgcv2_torch.models.pcc import PCCModel
from pcgcv2_torch.obs import span
from pcgcv2_torch.ops.blocks import resolve_device
from pcgcv2_torch.train.loss import cls_metrics, rd_loss

# The steps of one train_scanned / test_scanned call from which the card
# takes mode="scan" when no mode is given: there a call's replays have
# saved more against the loop than its eager first step and capture cost
# (chip_smoke.py phase 7d on an H100 at full width: the graph paid from
# 7.7-8.7 steps in train_scanned and 8.9-11.2 in test_scanned; PERF.md).
SCAN_MIN_STEPS = 12


def get_logger(logdir: str) -> logging.Logger:
    """File (logdir/log.txt) + console logger."""
    os.makedirs(logdir, exist_ok=True)
    logger = logging.getLogger(f"pcgcv2_torch.{logdir}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s: %(message)s",
                                datefmt="%m/%d %H:%M:%S")
        fh = logging.FileHandler(os.path.join(logdir, "log.txt"))
        fh.setFormatter(fmt)
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(ch)
    return logger


def make_optimizer(params, lr: float, weight_decay: float):
    """Adam with L2 weight decay added to the gradients (the JAX package's
    add_decayed_weights -> scale_by_adam -> scale(-lr)).

    The lr is a 0-d tensor on the parameters' device, as optax's
    inject_hyperparams holds it, written in place by `set_lr`.  On the
    card the optimizer is capturable (its step counts live on the device),
    so that a CUDA graph can hold its update."""
    params = list(params)
    dev = params[0].device
    return torch.optim.Adam(params, lr=torch.tensor(float(lr), device=dev),
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay,
                            capturable=dev.type == "cuda")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write `lr` into the optimizer's lr tensors, in place: a captured
    update reads them at every replay."""
    for group in optimizer.param_groups:
        group["lr"].fill_(lr)


def reset_optimizer(optimizer: torch.optim.Optimizer) -> None:
    """Zero the moments and step counts in place: the state a new
    optimizer starts from (the JAX package's tx.init), in the tensors a
    captured update holds."""
    for state in optimizer.state.values():
        for v in state.values():
            v.zero_()


def save_params(path: str, model: torch.nn.Module) -> None:
    """Weights-only checkpoint of `model` in the flax msgpack layout."""
    checkpoint.save_params(path, checkpoint.params_to_jax(model))


def load_params(path: str, model: Optional[torch.nn.Module] = None):
    """A weights-only checkpoint (either package's): the nested tree of
    numpy arrays, or, given `model`, loaded into it (strict)."""
    tree = checkpoint.load_params(path)
    return tree if model is None else checkpoint.load_into(model, tree)


class Trainer:
    """Single-device trainer.

    plan: BlockPlan sized for the training batch; capacity: padded voxel
    rows of one collated batch.  Runs on the card unless `device` asks for
    the CPU, and raises when no card is present.  `graph_replays` counts
    the steps that mode="scan" ran as replays of a captured CUDA graph."""

    def __init__(
        self,
        config: TrainConfig,
        plan: BlockPlan,
        capacity: int,
        model_config: ModelConfig = ModelConfig(),
        logdir: str = "./logs/tp",
        ckptdir: str = "./ckpts/tp",
        init_ckpt: str = "",
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.plan = plan
        self.capacity = capacity
        self.logdir = logdir
        self.ckptdir = ckptdir
        os.makedirs(ckptdir, exist_ok=True)
        self.logger = get_logger(logdir)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.model = PCCModel(model_config, num_batches=config.batch_size)
        self.model.to(self.device)
        if init_ckpt:
            load_params(init_ckpt, self.model)
            self.logger.info(f"Load checkpoint from {init_ckpt}")
        else:
            self.model.init_weights(self.generator)
            self.logger.info("Random initialization.")
        self.epoch = 0
        self.lr = config.lr
        self.optimizer = self._new_optimizer()
        self.record_set: Dict[str, List] = {
            "bce": [], "bces": [], "bpp": [], "sum_loss": [], "metrics": []
        }
        self.graph_replays = 0

    def _new_optimizer(self):
        return make_optimizer(self.model.parameters(), self.lr,
                              self.config.weight_decay)

    def _collate(self, coords_list: Sequence[np.ndarray]):
        coords, valid = collate(coords_list, capacity=self.capacity)
        return (torch.from_numpy(coords).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def _metrics(self, out) -> torch.Tensor:
        with torch.no_grad():
            return torch.stack([
                cls_metrics(c, g) for c, g in
                zip(out["out_cls_list"], out["ground_truth_list"])])

    def step(self, coords: torch.Tensor, valid: torch.Tensor):
        """One training step on a collated batch at the current lr: (the
        rd_loss terms, [3 scales, precision / recall / IoU], dropped)."""
        set_lr(self.optimizer, self.lr)
        return self._step(coords, valid)

    def _step(self, coords: torch.Tensor, valid: torch.Tensor):
        """`step` at the lr the optimizer holds."""
        out = self.model(coords, valid, self.plan, training=True,
                         generator=self.generator)
        d = rd_loss(out, self.config.alpha, self.config.beta, "train")
        mets = self._metrics(out)
        self.optimizer.zero_grad(set_to_none=True)
        d["loss"].backward()
        self.optimizer.step()
        return ({k: v.detach() for k, v in d.items()}, mets,
                out["out"].dropped)

    def _train_row(self, coords: torch.Tensor, valid: torch.Tensor):
        """`_step`, packed into one row [bce, bpp, n_drop, bces...,
        metrics...]."""
        d, mets, n_drop = self._step(coords, valid)
        return torch.cat([torch.stack([d["bce"], d["bpp"], n_drop.float()]),
                          d["bces"], mets.reshape(-1)])

    def _test_row(self, coords: torch.Tensor, valid: torch.Tensor):
        """The evaluation of one batch, packed into one row [bce, bpp,
        bces..., metrics...]."""
        out = self.model(coords, valid, self.plan, training=False)
        d = rd_loss(out, self.config.alpha, self.config.beta, "test")
        return torch.cat([torch.stack([d["bce"], d["bpp"]]), d["bces"],
                          self._metrics(out).reshape(-1)])

    # --- bookkeeping --------------------------------------------------------

    def _record_step(self, d, mets) -> None:
        bce, bpp = float(d["bce"]), float(d["bpp"])
        self.record_set["bce"].append(bce)
        self.record_set["bces"].append(d["bces"].cpu().numpy())
        self.record_set["bpp"].append(bpp)
        self.record_set["sum_loss"].append(bce + bpp)
        self.record_set["metrics"].append(mets.cpu().numpy())

    def record(self, tag: str, step: int):
        self.logger.info("=" * 10 + f"{tag} Epoch {self.epoch} Step {step}")
        for k, v in self.record_set.items():
            if v:
                mean = np.mean(np.array(v), axis=0)
                self.logger.info(f"{k}: {np.round(mean, 4).tolist()}")
        for k in self.record_set:
            self.record_set[k] = []

    def save_model(self, name: Optional[str] = None) -> str:
        """Weights-only release checkpoint (flax msgpack layout)."""
        path = os.path.join(self.ckptdir, name or f"epoch_{self.epoch}.ckpt")
        save_params(path, self.model)
        return path

    def save_state(self, name: str = "train_state.ckpt") -> str:
        """The full train state for an exact resume: parameters, optimizer
        moments, epoch, lr and the noise generator's state."""
        path = os.path.join(self.ckptdir, name)
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "lr": self.lr,
            "rng": self.generator.get_state(),
        }, path)
        return path

    def restore_state(self, path: str) -> None:
        """Inverse of save_state."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer = self._new_optimizer()
        own = [{k: v for k, v in group.items() if k != "params"}
               for group in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["optimizer"])
        # load_state_dict takes the file's group settings; keep this
        # trainer's (capturable on the card only, the lr its own tensor),
        # so that a state written on either device resumes on the other,
        # and keep each step count where that Adam keeps it
        for group, settings in zip(self.optimizer.param_groups, own):
            group.update(settings)
            for p in group["params"]:
                s = self.optimizer.state.get(p, {})
                if "step" in s:
                    s["step"] = s["step"].to(
                        p.device if group["capturable"] else "cpu")
        self.epoch = int(state["epoch"])
        self.lr = float(state["lr"])
        set_lr(self.optimizer, self.lr)
        self.generator.set_state(state["rng"])

    # --- loops --------------------------------------------------------------

    def train(self, batches: Iterable[Sequence[np.ndarray]]):
        """One epoch over an iterable of batches (lists of [N, 3] coords)."""
        self.logger.info("=" * 40 + f"\nTraining Epoch: {self.epoch}")
        if self.epoch > 0 and self.epoch % self.config.lr_halve_every == 0:
            self.lr = max(self.lr / 2, self.config.lr_min)
        start_time = time.time()
        n_steps = 0
        for batch_step, coords_list in enumerate(batches):
            total = sum(len(c) for c in coords_list)
            if total > self.capacity:
                self.logger.info(
                    f"skip oversized batch ({total} > {self.capacity})")
                continue
            coords, valid = self._collate(coords_list)
            if batch_step == 0 and self.config.reset_optimizer_each_epoch:
                reset_optimizer(self.optimizer)
            d, mets, n_drop = self.step(coords, valid)
            n_steps += 1
            if int(n_drop):
                # nonzero: the step ran on geometry cut by a block cap; the
                # parameters already took the update, so say so loudly
                self.logger.warning(
                    f"step dropped {int(n_drop)} occupied blocks "
                    f"(plan {self.plan} too small for this batch) — "
                    f"this step trained on corrupted geometry; raise the "
                    f"BlockPlan capacities")
            self._record_step(d, mets)
            if time.time() - start_time > self.config.check_time * 60:
                self.record("Train", self.epoch * 10000 + batch_step)
                self.save_model()
                start_time = time.time()
        if n_steps:
            self.record("Train", self.epoch * 10000 + n_steps)
            self.save_model()
        self.epoch += 1

    # --- epochs in one upload and one fetch ---------------------------------

    def _stacked(self, batches: Sequence[Sequence[np.ndarray]]):
        """The batches that fit the capacity (the rest skipped, with a log
        line), each collated to the one plan, stacked and copied to the
        device at once: (coords [n, capacity, 4], valid [n, capacity]), or
        None if none fits."""
        with span("pcgc.train.collate"):
            kept = []
            for coords_list in batches:
                total = sum(len(c) for c in coords_list)
                if total > self.capacity:
                    self.logger.info(
                        f"skip oversized batch ({total} > {self.capacity})")
                    continue
                kept.append(collate(coords_list, capacity=self.capacity))
            if not kept:
                return None
            coords = np.stack([c for c, _ in kept])
            valid = np.stack([v for _, v in kept])
        with span("pcgc.train.upload"):
            return (torch.from_numpy(coords).to(self.device),
                    torch.from_numpy(valid).to(self.device))

    def _record_rows(self, rows: np.ndarray, first: int) -> None:
        """Record the packed per-step rows [bce, bpp, (n_drop,) bces...,
        metrics...] fetched at the end of an epoch; the three per-scale
        bces start at column `first`."""
        for row in rows:
            bce, bpp = float(row[0]), float(row[1])
            self.record_set["bce"].append(bce)
            self.record_set["bces"].append(row[first:first + 3])
            self.record_set["bpp"].append(bpp)
            self.record_set["sum_loss"].append(bce + bpp)
            self.record_set["metrics"].append(
                row[first + 3:].reshape(3, -1))

    @staticmethod
    def _check_mode(mode: Optional[str]) -> None:
        if mode not in (None, "loop", "scan"):
            raise ValueError(f"unknown mode {mode!r} (loop or scan)")

    def _pick_mode(self, mode: Optional[str], n_steps: int) -> str:
        """The mode asked for; with none, the graph on the card from
        SCAN_MIN_STEPS steps on, where its replays have saved more than
        its eager first step and capture cost, else the loop."""
        if mode is not None:
            return mode
        return ("scan" if self.device.type == "cuda"
                and n_steps >= SCAN_MIN_STEPS else "loop")

    def _run(self, fn, coords_all: torch.Tensor, valid_all: torch.Tensor,
             mode: str) -> np.ndarray:
        """fn(coords, valid) -> one row, over the stacked batches; the rows
        fetched in one copy at the end.

        mode="loop" calls fn on each batch.  mode="scan" copies each batch
        into one pair of input buffers and calls fn on those: on the card
        the first call runs eagerly on a side stream (the warm-up that a
        capture needs, and the epoch's first step), the second is captured
        (`_capture`) and every later batch replays the graph, its row
        copied out on the device; on the CPU every call runs eagerly."""
        if mode == "loop":
            rows = []
            for c, v in zip(coords_all, valid_all):
                with span("pcgc.train.step"):
                    rows.append(fn(c, v))
            with span("pcgc.train.fetch"):
                return torch.stack(rows).cpu().numpy()
        n = len(coords_all)
        static = (torch.empty_like(coords_all[0]),
                  torch.empty_like(valid_all[0]))

        def load(i):
            static[0].copy_(coords_all[i])
            static[1].copy_(valid_all[i])

        if self.device.type != "cuda":
            rows = []
            for i in range(n):
                with span("pcgc.train.step"):
                    load(i)
                    rows.append(fn(*static))
            with span("pcgc.train.fetch"):
                return torch.stack(rows).cpu().numpy()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with span("pcgc.train.first_step"), torch.cuda.stream(side):
            load(0)
            first = fn(*static)
            rows = first.new_empty((n, first.numel()))
            rows[0] = first
        main.wait_stream(side)
        if n == 1:
            with span("pcgc.train.fetch"):
                return rows.cpu().numpy()
        graph = row = None
        try:
            with span("pcgc.train.capture"):
                graph, row = self._capture(fn, static, side)
            for i in range(1, n):
                with span("pcgc.train.replay"):
                    load(i)
                    graph.replay()
                    self.graph_replays += 1
                    rows[i] = row
            with span("pcgc.train.fetch"):
                return rows.cpu().numpy()
        finally:
            # the casts cached at capture live in the graph's memory,
            # which goes with the graph here, at the end of every call
            with span("pcgc.train.release"):
                forget_casts(self.model)
                del graph, row

    def _capture(self, fn, static, stream):
        """fn(*static) captured as one CUDA graph on `stream`: (the graph,
        its output row, which every replay overwrites).  Every layer's
        cast is forgotten first, so that the graph records the casts and
        packs and redoes them from the parameters at each replay; the
        trainer's generator is registered, so that each replay draws the
        next numbers and advances it as an eager step would.  A capture
        that fails raises."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        forget_casts(self.model)
        with torch.cuda.graph(graph, stream=stream):
            row = fn(*static)
        return graph, row

    def train_scanned(self, batches: Sequence[Sequence[np.ndarray]],
                      mode: Optional[str] = None):
        """One epoch over `batches` (lists of [N, 3] coords) with one
        host-to-device copy and one packed fetch: oversized batches are
        skipped on the host, every kept one is collated to the one plan,
        the stack is copied to the device at once, the steps run with
        nothing fetched between them, and [bce, bpp, n_drop, bces...] and
        the metrics of every step come back in one copy at the end.  The
        lr schedule, optimizer reset, records and checkpoint are
        `train`'s.  mode="loop" runs the steps one by one; mode="scan"
        replays one captured CUDA graph per step on the card (`_run`);
        with no mode, `_pick_mode` chooses from the kept batches."""
        self._check_mode(mode)
        with span("pcgc.train.call"):
            self.logger.info("=" * 40 + f"\nTraining Epoch: {self.epoch}")
            if self.epoch > 0 and self.epoch % self.config.lr_halve_every == 0:
                self.lr = max(self.lr / 2, self.config.lr_min)
            stacked = self._stacked(batches)
            if stacked is None:
                self.epoch += 1
                return
            if self.config.reset_optimizer_each_epoch:
                reset_optimizer(self.optimizer)
            set_lr(self.optimizer, self.lr)
            rows = self._run(self._train_row, *stacked,
                             self._pick_mode(mode, len(stacked[0])))
            with span("pcgc.train.record"):
                for n_drop in rows[:, 2]:
                    if n_drop:
                        self.logger.warning(
                            f"step dropped {int(n_drop)} occupied blocks "
                            f"(plan {self.plan} too small for this batch) — "
                            f"this step trained on corrupted geometry; raise "
                            f"the BlockPlan capacities")
                self._record_rows(rows, first=3)
                self.record("Train", self.epoch * 10000 + len(rows))
            with span("pcgc.train.save_model"):
                self.save_model()
            self.epoch += 1

    def test_scanned(self, batches: Sequence[Sequence[np.ndarray]],
                     tag: str = "Test", mode: Optional[str] = None):
        """`test` over the batches that fit, with one host-to-device copy
        and one packed fetch; mode="scan" captures the evaluation forward
        and replays it per batch, as in `train_scanned`."""
        self._check_mode(mode)
        stacked = self._stacked(batches)
        if stacked is None:
            return
        with torch.no_grad():
            rows = self._run(self._test_row, *stacked,
                             self._pick_mode(mode, len(stacked[0])))
        self._record_rows(rows, first=2)
        self.record(tag, self.epoch)

    def test(self, batches: Iterable[Sequence[np.ndarray]],
             tag: str = "Test"):
        """Evaluation (rounding, top-k prune, 'test' normalization)."""
        with torch.no_grad():
            for coords_list in batches:
                if sum(len(c) for c in coords_list) > self.capacity:
                    continue
                coords, valid = self._collate(coords_list)
                out = self.model(coords, valid, self.plan, training=False)
                d = rd_loss(out, self.config.alpha, self.config.beta, "test")
                self._record_step(d, self._metrics(out))
        self.record(tag, self.epoch)
