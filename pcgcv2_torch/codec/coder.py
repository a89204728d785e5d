"""End-to-end codec: 4-file bitstream, encode/decode entry points (twin of
pcgcv2_tpu/codec/coder.py, byte-compatible with its streams).

  <name><postfix>_C.bin           lossless bottleneck coordinates (octree
                                  codec, or tmc3 when available)
  <name><postfix>_F.bin           rANS-coded bottleneck features
  <name><postfix>_H.bin           header: shape int32x2, len int8,
                                  min/max float32
  <name><postfix>_num_points.bin  3x int32 per-scale ground-truth counts
                                  + 4x int32 occupied-block counts

Bottleneck rows are sorted by (x, y, z) on both sides before features are
attached.  Every stage reports the BlockGrid `dropped` counter, and the
codec refuses to write or accept a stream that lost voxels to a capacity
plan that was too small (decode retries once on the density-prior plan).

The network runs on `device` (the card unless the caller asks for the
CPU); the host does file I/O, CDF quantization and the byte-level coding.
The JAX package's packed host<->device transfers existed for a
high-latency TPU link and are not carried over.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pcgcv2_torch.checkpoint import params_from_jax
from pcgcv2_torch.codec import gpcc, native, octree
from pcgcv2_torch.config import BlockPlan, ModelConfig
from pcgcv2_torch.data import io as pcio
from pcgcv2_torch.models.entropy import pmf_host
from pcgcv2_torch.obs import span
from pcgcv2_torch.ops import blocks as B


def _bucket(n: int, granularity: int) -> int:
    return max(granularity, -(-n // granularity) * granularity)


def canonical_order(coords: np.ndarray) -> np.ndarray:
    """Row permutation sorting [N, 3] coords ascending by (x, y, z)."""
    return np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))


def block_counts(coords: np.ndarray) -> Tuple[int, int, int, int]:
    """Occupied-block counts at strides (1, 2, 4, 8) — the measured frame
    footprint BlockPlan.for_frame turns into exact-fit capacities.  A
    dense occupancy pyramid when the block grid is small (<= 256^3), else
    one key dedup per scale."""
    shift = int(B.BS).bit_length() - 1  # log2(block side)
    c = np.asarray(coords, dtype=np.int64) >> shift
    if len(c) == 0:
        return (0, 0, 0, 0)
    g = int(c.max()) + 1
    g8 = -(-g // 8) * 8
    if g8 <= 256:
        occ = np.zeros((g8, g8, g8), dtype=bool)
        occ[c[:, 0], c[:, 1], c[:, 2]] = True
        counts = [int(np.count_nonzero(occ))]
        for _ in range(3):
            h = occ.shape[0] // 2
            occ = occ.reshape(h, 2, h, 2, h, 2).any(axis=(1, 3, 5))
            counts.append(int(np.count_nonzero(occ)))
        return tuple(counts)
    key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
    fine = np.unique(key)
    counts = [len(fine)]
    x, y, z = fine >> 42, (fine >> 21) & 0x1FFFFF, fine & 0x1FFFFF
    for s in range(1, 4):
        ks = ((x >> s) << 42) | ((y >> s) << 21) | (z >> s)
        counts.append(len(np.unique(ks)))
    return tuple(counts)


def _row_key(xyz: torch.Tensor) -> torch.Tensor:
    """[N, 3] int rows -> int64 (x << 42) | (y << 21) | z (coordinates
    non-negative and < 2^21): ascending keys are rows sorted by (x, y, z)."""
    c = xyz.long()
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def device_block_counts(xyz: torch.Tensor, res: int) -> torch.Tensor:
    """int64 [4] occupied-block counts at strides (1, 2, 4, 8) of [N, 3]
    unique rows inside [0, res)^3, on their device and without a fetch:
    `block_counts` of the same rows, with the block grid sized from `res`
    (which holds every row) instead of a fetched max.  A dense occupancy
    pyramid when the grid is small (<= 256^3), else a sort per scale."""
    c = xyz.long() >> (int(B.BS).bit_length() - 1)
    g8 = -(-B.grid_dim(res) // 8) * 8
    if g8 <= 256:
        key = (c[:, 0] * g8 + c[:, 1]) * g8 + c[:, 2]
        occ = B._occupancy(g8 ** 3, key, ((c >= 0) & (c < g8)).all(dim=1))
        counts, h = [occ.sum()], g8
        for _ in range(3):
            h //= 2
            occ = occ.view(h, 2, h, 2, h, 2).amax(dim=(1, 3, 5))
            counts.append(occ.sum())
        return torch.stack(counts)
    counts = []
    for s in range(4):
        k = torch.sort(_row_key(c >> s)).values
        counts.append((k[1:] != k[:-1]).sum() + min(len(k), 1))
    return torch.stack(counts)


class FeatureCoder:
    """Learned-prior rANS coding of bottleneck features."""

    def __init__(self, filename: str, pmf_fn):
        self.filename = filename
        self._pmf_fn = pmf_fn  # (min_v, num_symbols) -> [C, S]

    def encode(self, feats: np.ndarray, postfix: str = "") -> None:
        with span("pcgc.rans.encode"):
            vals = np.round(np.asarray(feats, dtype=np.float64)).astype(
                np.int32)
            min_v = int(vals.min())
            max_v = int(vals.max())
            s = max_v - min_v + 1
            cdf = native.quantize_cdf(np.asarray(self._pmf_fn(min_v, s)))
            blob = native.rans_encode(cdf, (vals - min_v).reshape(-1))
            with open(self.filename + postfix + "_F.bin", "wb") as f:
                f.write(blob)
            with open(self.filename + postfix + "_H.bin", "wb") as f:
                f.write(np.array(vals.shape, dtype=np.int32).tobytes())
                f.write(np.array(1, dtype=np.int8).tobytes())
                f.write(np.array([min_v], dtype=np.float32).tobytes())
                f.write(np.array([max_v], dtype=np.float32).tobytes())

    def decode(self, postfix: str = "") -> np.ndarray:
        with span("pcgc.rans.decode"):
            with open(self.filename + postfix + "_H.bin", "rb") as f:
                shape = np.frombuffer(f.read(8), dtype=np.int32)
                n_minv = int(np.frombuffer(f.read(1), dtype=np.int8)[0])
                min_v = int(np.frombuffer(f.read(4 * n_minv),
                                          dtype=np.float32)[0])
                max_v = int(np.frombuffer(f.read(4 * n_minv),
                                          dtype=np.float32)[0])
            with open(self.filename + postfix + "_F.bin", "rb") as f:
                blob = f.read()
            s = max_v - min_v + 1
            cdf = native.quantize_cdf(np.asarray(self._pmf_fn(min_v, s)))
            syms = native.rans_decode(cdf, blob,
                                      int(shape[0]) * int(shape[1]))
            vals = syms.reshape(int(shape[0]), int(shape[1])) + min_v
            return vals.astype(np.float32)


class CoordinateCoder:
    """Lossless coding of stride-normalized bottleneck coordinates: tmc3
    when present and preferred, else the built-in octree codec; streams
    are tagged so decode dispatches on the file's magic."""

    def __init__(self, filename: str, prefer_gpcc: bool = False):
        self.filename = filename
        self.use_gpcc = prefer_gpcc and gpcc.find_tmc3() is not None

    def encode(self, coords: np.ndarray, postfix: str = "") -> None:
        path = self.filename + postfix + "_C.bin"
        with span("pcgc.octree.encode"):
            if self.use_gpcc:
                ply = path + ".tmp.ply"
                pcio.write_ply_ascii_geo(ply, coords)
                gpcc.gpcc_encode(ply, path)
                os.remove(ply)
            else:
                with open(path, "wb") as f:
                    f.write(octree.encode(coords))

    def decode(self, postfix: str = "") -> np.ndarray:
        path = self.filename + postfix + "_C.bin"
        with span("pcgc.octree.decode"):
            with open(path, "rb") as f:
                data = f.read()
            if data[:4] in (octree.MAGIC, octree.MAGIC2, octree.MAGIC3):
                return octree.decode(data)
            ply = path + ".tmp.ply"
            gpcc.gpcc_decode(path, ply)
            coords = pcio.read_ply_geo(ply)
            os.remove(ply)
            return coords


class Coder:
    """Single-frame encode/decode orchestrator.

    params: the JAX parameter tree as numpy arrays (checkpoint.load_params
    or a JAX model's init output); res: coordinate bound of the frames.
    device: where the network runs — "cuda" (default) raises when no card
    is present; pass "cpu" explicitly to run on the CPU.
    """

    def __init__(
        self,
        params,
        filename: str,
        res: int = 1024,
        model_config: ModelConfig = ModelConfig(),
        input_granularity: int = 65536,
        prefer_gpcc: bool = False,
        streamed_slabs: int = 0,
        device="cuda",
    ):
        """input_granularity buckets the point count of the density-prior
        plan.  (The JAX Coder's prune_granularity sized static extraction
        buffers; eager PyTorch needs none.)  streamed_slabs > 0 decodes
        the final stage in that many x-slabs (`_decode_streamed`); 0 picks
        8 slabs for plans at res >= 2048 and the monolithic decode below
        that."""
        self.device = B.resolve_device(device)
        self.filename = filename
        self.res = res
        self.model_config = model_config
        self.input_granularity = input_granularity
        self.streamed_slabs = streamed_slabs
        self.coordinate_coder = CoordinateCoder(filename, prefer_gpcc)
        self.feature_coder = FeatureCoder(filename, self._pmf)
        self.params = params
        self._staging = None  # int32 host buffer of the encode's upload
        self.intake_dedups = 0  # frames the encode had to sort-unique

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, p):
        """Weights move to the device once, here; the entropy-bottleneck
        leaves keep a host copy for pmf_host (float64 numpy per frame)."""
        tree = p["params"] if "params" in p else p
        self._params = p
        self._eb_host = {k: np.asarray(v) for k, v in
                         tree["entropy_bottleneck"].items()}
        self.model = params_from_jax(tree, self.model_config, self.device)

    def _pmf(self, min_v, num_symbols: int):
        return pmf_host(self._eb_host, float(min_v), num_symbols)

    def _plan_for(self, n_points: int) -> BlockPlan:
        """Density-prior plan (the decode retry tier)."""
        cap = _bucket(n_points, self.input_granularity)
        return BlockPlan.for_cloud(cap, self.res)

    def _plan_from_counts(self, counts) -> BlockPlan:
        """Exact-fit plan from measured per-scale block counts."""
        return BlockPlan.for_frame(self.res, tuple(int(c) for c in counts))

    def _rows(self, xyz: np.ndarray) -> torch.Tensor:
        """[N, 3] host coords -> int32 [N, 4] (batch 0, x, y, z) on device."""
        rows = np.zeros((len(xyz), 4), np.int32)
        rows[:, 1:] = xyz
        return torch.from_numpy(rows).to(self.device)

    def _upload(self, coords) -> torch.Tensor:
        """[N, 3] host coords -> int32 [N, 3] on the device, as given: one
        copy through a staging buffer (pinned for a card) that grows
        geometrically with the frames.  Input of another int dtype or
        layout is converted in the same pass that fills the buffer."""
        c = np.asarray(coords)
        if self._staging is None or self._staging.numel() < c.size:
            old = 0 if self._staging is None else self._staging.numel()
            self._staging = torch.empty(
                max(c.size, 2 * old), dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        host = self._staging[:c.size].view(-1, 3)
        host.numpy()[:] = c
        # the caller fetches from this stream before the next frame
        # writes the buffer again
        return host.to(self.device, non_blocking=True)

    def _intake(self, coords):
        """One frame's [N, 3] host coords -> (int32 [n, 4] rows (batch 0,
        x, y, z) sorted-unique on the device, valid [n], the four block
        counts): `_rows(unique_rows(coords))` and `block_counts` of the
        same rows, from one upload and two small fetches."""
        with span("pcgc.encode.upload"):
            xyz = self._upload(coords)
        with span("pcgc.encode.unique_rows"):
            key = _row_key(xyz)
            if not bool((key[1:] > key[:-1]).all()):
                with span("pcgc.encode.dedup"):
                    self.intake_dedups += 1
                    ku = torch.unique(key)
                    xyz = torch.stack([ku >> 42, (ku >> 21) & 0x1FFFFF,
                                       ku & 0x1FFFFF], dim=1).int()
            rows = F.pad(xyz, (1, 0))
            valid = torch.ones(len(rows), dtype=torch.bool,
                               device=self.device)
        with span("pcgc.encode.block_counts"):
            counts = tuple(device_block_counts(xyz, self.res).tolist())
        return rows, valid, counts

    # --- public API ---------------------------------------------------------

    @torch.inference_mode()
    def encode(self, coords: np.ndarray, postfix: str = ""):
        """coords: [N, 3] int voxel coordinates of one frame, in any order
        and with repeats.

        Returns (bottleneck coords [ny, 3] stride-normalized, rounded
        features [ny, C]) in canonical order."""
        with span("pcgc.encode"):
            rows, valid, counts = self._intake(coords)
            n = len(rows)
            plan = self._plan_from_counts(counts)
            with span("pcgc.encode.network"):
                y, nums, n_in = self.model.encode_fn(rows, valid, plan)
            with span("pcgc.encode.fetch"):
                ny = int(y.voxel_count())
                yc, yf, _ = B.extract(y, max(ny, 1))
                meta = torch.stack([y.dropped, n_in.to(torch.int32),
                                    nums[0][0], nums[1][0],
                                    nums[2][0]]).cpu()
                n_drop, n_unique = int(meta[0]), int(meta[1])
                if n_drop or n_unique != n:
                    raise RuntimeError(
                        f"capacity plan too small for frame ({n} pts, res "
                        f"{self.res}): dropped={n_drop} n_in={n_unique}; "
                        f"raise BlockPlan.for_cloud sizing")
                ds = (yc[:ny, 1:] // 8).cpu().numpy().astype(np.int32)
                feats = yf[:ny].to(torch.float32).cpu().numpy()
            with span("pcgc.encode.order"):
                num_points = [int(v) for v in meta[2:5]]
                with open(self.filename + postfix + "_num_points.bin",
                          "wb") as f:
                    f.write(np.array(num_points, dtype=np.int32).tobytes())
                    f.write(np.array(counts, dtype=np.int32).tobytes())
                order = canonical_order(ds)
                ds_coords, feats = ds[order], feats[order]
            self.feature_coder.encode(feats, postfix)
            self.coordinate_coder.encode(ds_coords, postfix)
            return ds_coords, np.round(feats)

    @torch.inference_mode()
    def decode(self, rho: float = 1.0, postfix: str = "") -> np.ndarray:
        with span("pcgc.decode"):
            coords = self.coordinate_coder.decode(postfix)
            feats = self.feature_coder.decode(postfix)
            with span("pcgc.decode.unpack"):
                coords = coords[canonical_order(coords)]
                m = len(coords)
                assert feats.shape[0] == m, \
                    "feature/coordinate count mismatch"

                with open(self.filename + postfix + "_num_points.bin",
                          "rb") as f:
                    head = np.frombuffer(f.read(28), dtype=np.int32)
                num_points = head[:3].tolist()
                n_frame = num_points[-1]
                num_points[-1] = int(rho * num_points[-1])

                # Plan ladder: exact-fit caps from the header's block
                # counts when present, then the density-prior plan as the
                # overflow retry tier.
                plans = []
                if head.size == 7:
                    p = self._plan_from_counts(head[3:7])
                    if rho > 1.0:
                        # rho densifies only the final top-k: let the
                        # final post-prune cap reach the candidate cap
                        p = dataclasses.replace(
                            p, dec_nb=(p.dec_nb[0], p.dec_nb[1],
                                       p.up_cap(2)))
                    plans.append(p)
                plans.append(self._plan_for(max(n_frame, num_points[-1])))

                res_y = max(1, self.res // 8)
                rows = self._rows(coords * 8)
                valid = torch.ones(m, dtype=torch.bool, device=self.device)
                y_feats = torch.from_numpy(feats).to(self.device,
                                                     B.COMPUTE_DTYPE)
                nums = torch.tensor(num_points, dtype=torch.int32,
                                    device=self.device)
                nums_list = [nums[0:1], nums[1:2], nums[2:3]]
            for tier, plan in enumerate(plans):
                n_slabs = self.streamed_slabs or (8 if plan.res >= 2048
                                                  else 0)
                # the first tier is the network; each later one a retry
                with span("pcgc.decode.retry" if tier
                          else "pcgc.decode.network"):
                    y = B.blockify(rows, y_feats, valid, plan.nb[3],
                                   stride=8, res=res_y, num_batches=1)
                    if n_slabs:
                        out, dropped = self._decode_streamed(
                            y, nums_list, plan, n_slabs)
                    else:
                        out = self.model.decode_fn(y, nums_list, plan)
                        dropped = out.dropped
                with span("pcgc.decode.fetch"):
                    dropped = int(dropped)
                    if not dropped:
                        bc, bits = B.pack_occupancy(out)
                        n_out = int(out.voxel_count())
                        bc, bits = bc.cpu().numpy(), bits.cpu().numpy()
                        break
                if tier + 1 == len(plans):
                    raise RuntimeError(
                        f"decode overflowed the capacity plan (dropped="
                        f"{dropped}); raise BlockPlan.for_cloud sizing")
                logging.getLogger(__name__).warning(
                    "exact-fit decode caps overflowed (dropped=%d); "
                    "retrying on the density-prior plan", dropped)
            with span("pcgc.decode.host_extract"):
                result = B.host_extract(bc, bits)
            assert len(result) == n_out, "host extraction count mismatch"
            return result

    def _decode_streamed(self, y: B.BlockGrid, nums_list, plan: BlockPlan,
                         n_slabs: int):
        """Memory-bounded decode: stages 0-1 whole, the final stage over
        x-slabs of the stride-2 blocks, each with a 1-block halo (the
        stage's receptive field is 8 voxels, within one block at either
        block side: exactly one at 8^3).  Candidate features exist
        only per slab; the whole frame holds only the candidate structure
        and its 1-channel f32 logits.  Returns (pruned candidate grid,
        dropped blocks).

        Slab bounds are equal-count quantiles of the sorted block x-coords
        (rows are sorted by (b, bx, by, bz), so the valid prefix's bx is
        nondecreasing and a rank indexes it directly); slab i owns bx in
        [bounds[i], bounds[i+1]).  Balanced counts let the per-slab caps
        sit at 2x the mean (halo planes + candidate drift); an overflow is
        counted and retried on the next plan tier.
        """
        model = self.model
        with span("pcgc.decode.coarse"):
            out = model.decode_coarse_fn(y, nums_list[:2], plan)
            cand_cap = plan.up_cap(2)
            cand = B.conv_up_structure(out, cand_cap)
            # a slab's blocks are a subset of the whole grid's, so its
            # caps never need to exceed the whole grid's
            sub_in_cap = min(out.nb_cap,
                             max(32, plan.dec_nb[1] * 2 // n_slabs))
            sub_cand_cap = min(cand_cap, max(256, cand_cap * 2 // n_slabs))
            logits = torch.zeros(cand_cap, B.VOL, dtype=torch.float32,
                                 device=self.device)
            bx = out.coords[:, 1]
            ranks = (torch.arange(1, n_slabs, device=self.device)
                     * out.count // n_slabs).clamp(0, out.nb_cap - 1)
        with span("pcgc.decode.fetch"):
            bounds = [0] + bx[ranks].tolist() + [B.grid_dim(out.res)]
        dropped = cand.dropped
        for ia, ib in zip(bounds[:-1], bounds[1:]):
            with span("pcgc.decode.slab"):
                sub = B.compact_where(out, (bx >= ia - 1) & (bx < ib + 1),
                                      sub_in_cap)
                cls = model.decode_stage2_fn(sub, sub_cand_cap)
                del sub
                # every sub-grid inherits out.dropped; count only the
                # slab's own
                dropped = dropped + (cls.dropped - out.dropped)
                cx = cls.coords[:, 1]
                rows = cand.table.long()[B._flat_block_key(cls.coords,
                                                           cand.G)]
                # interior candidate blocks only; the sentinel row stays
                # zero
                inner = ((cx >= 2 * ia) & (cx < 2 * ib) & cls.valid
                         & (rows < cand_cap - 1))
                logits[rows[inner]] = cls.feats[inner, :, 0].float()
                del cls
        with span("pcgc.decode.topk"):
            keep = B.topk_mask(cand, logits, nums_list[2])
            return B.prune(cand, keep), dropped

    def bitstream_bytes(self, postfix: str = "") -> dict:
        """Sizes of the 4 bitstream files."""
        return {
            ext: os.path.getsize(self.filename + postfix + ext)
            for ext in ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin")
        }
