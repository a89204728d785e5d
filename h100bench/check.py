"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference (`reference/`), number by number, each
against its limit (`limits/<cell>.json`).

Codec cells: a sample of the window's frames, drawn from the seed once
the window has closed.  The reference encodes each frame, rounds, decodes
with the ground-truth counts and sizes the stream; compared:

* `latent_mismatch`: the share of the reference's latent entries (voxel x
  channel) that the program's rounded latents do not reproduce, a latent
  voxel missing on either side counting all its channels;
* `decoded_mismatch`: |program's decoded set xor reference's| / |reference's|.

The bitstream's size is printed beside them, as `bits_gap`: |program's
bits - reference's| / reference's, the reference's being the ideal
feature and coordinate code lengths plus the streams' fixed bytes.

Training cells: the first three steps of a call like the window's, which
set-up drives (an eager step, then two graph replays on the card), from
the same weights, batches and noise (the noise drawn again from the
trainer's seed into the same layout), the reference following with its
own Adam.  A leaf's gap is the gap between the norms of the program's and
the reference's, over the larger of that leaf's reference norm and the
median leaf's; the `_dir` numbers are signed, the relative L2 of the
difference over all leaves.  Of the first gradient as Adam gets it (its
first moment after one step over 1 - beta1): `grad_gap` (the
75th-percentile leaf), `grad_worst`, `grad_dir`; of the parameters'
change over the three steps, leaves whose reference gradient is under a
thousandth of the median leaf's left out (they move by round-off alone):
`update_gap` (the median leaf), `update_worst`, `update_dir`; of the
losses, `loss1_gap` (the first step) and `loss_gap` (the worst step).
The cell's limits file says which are compared; the rest are printed
(PERF.md gives the readings behind each choice).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from h100bench.reference import bits as BITS
from h100bench.reference import ckpt as CK
from h100bench.reference import codec as RC
from h100bench.reference import sparse as S
from h100bench.reference.d1 import d1_psnr
from h100bench.reference.model import PCGCv2, weights_on
from h100bench.reference.octree_bits import coordinate_bits

# Fixed bytes of a frame's four files besides the coded payloads: the
# rANS state (4), the octree stream's magic, depth and count (9) and its
# range coder's flush (4), the header file (17), the counts file (28).
STREAM_FIXED_BYTES = 4 + 9 + 4 + 17 + 28


def _keyed(xyz: np.ndarray) -> np.ndarray:
    c = np.asarray(xyz, dtype=np.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def latent_mismatch(xyz_p, q_p, xyz_r, y_r) -> float:
    kp, kr = _keyed(xyz_p), _keyed(xyz_r)
    q_r = np.round(np.asarray(y_r, np.float64))
    ch = q_r.shape[1]
    common, ip, ir = np.intersect1d(kp, kr, return_indices=True)
    wrong = int((np.asarray(q_p)[ip] != q_r[ir]).sum())
    wrong += ch * (len(kp) - len(common) + len(kr) - len(common))
    return wrong / max(1, len(kr) * ch)


def set_mismatch(p: np.ndarray, r: np.ndarray) -> float:
    kp, kr = np.unique(_keyed(p)), np.unique(_keyed(r))
    return len(np.setxor1d(kp, kr, assume_unique=True)) / max(1, len(kr))


def reference_bits(ref: Dict) -> float:
    return (ref["feature_bits"] + coordinate_bits(ref["latent_xyz"])
            + 8 * STREAM_FIXED_BYTES)


def codec_numbers(out: Dict, ref: Dict) -> Dict[str, float]:
    return {
        "latent_mismatch": latent_mismatch(out["latent_xyz"],
                                           out["latents_q"],
                                           ref["latent_xyz"], ref["latents"]),
        "decoded_mismatch": set_mismatch(out["decoded"], ref["decoded"]),
    }


def bits_gap(nbytes: Dict, ref: Dict) -> float:
    """|bitstream bits - the reference's| / the reference's (printed, not
    compared: its control does not separate from it, PERF.md)."""
    rb = reference_bits(ref)
    return abs(8.0 * sum(nbytes.values()) - rb) / rb


def reference_net(cfg: Dict, root: str, device, precision: str):
    import os

    arrays = CK.load(os.path.join(root, cfg["weights"]))
    return (PCGCv2(weights_on(arrays, device), cfg["model"], precision),
            BITS.entropy_params(arrays))


def check_codec(driver, cfg: Dict, root: str, seed: int, n_frames: int,
                device, log: Callable[[str], None],
                precision: str = "f32") -> Dict[str, float]:
    """The worst of each number over a seeded sample of the window's
    frames."""
    done = sorted(driver.outputs)
    rng = np.random.default_rng([seed, 1])
    pick = sorted(rng.choice(done, size=min(n_frames, len(done)),
                             replace=False).tolist())
    net, eb = reference_net(cfg, root, device, precision)
    res = driver.load.res
    worst: Dict[str, float] = {}
    for i in pick:
        frame = driver.load.frame(i)
        ref = RC.run_frame(net, eb, frame, driver.rho)
        rec = next(r for r in driver.records if r["index"] == i)
        nums = codec_numbers(driver.outputs[i], ref)
        bpp = 8.0 * sum(rec["bytes"].values()) / len(frame)
        log(f"check frame {i}: {len(frame)} voxels, bpp {bpp:.6f} "
            f"(reference {reference_bits(ref) / len(frame):.6f}, bits_gap "
            f"{bits_gap(rec['bytes'], ref):.6g}), D1 "
            f"{d1_psnr(frame, driver.outputs[i]['decoded'], res):.4f} dB "
            f"(reference {d1_psnr(frame, ref['decoded'], res):.4f}), "
            + ", ".join(f"{k} {v:.6g}" for k, v in nums.items()))
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def noise_layout(keys: torch.Tensor, bs: int, res: int) -> torch.Tensor:
    """Row of each latent voxel in the trainer's noise draw: the
    bottleneck's blocks of bs^3 slots ranked by (batch, block x, y, z)
    among the occupied ones, slots x-major within a block."""
    c = S.unpack(keys)
    g = max(1, -(-(res // 8) // bs))
    blk = c[:, 0] * g ** 3 + ((c[:, 1] // bs) * g + c[:, 2] // bs) * g \
        + c[:, 3] // bs
    rank = torch.searchsorted(torch.unique(blk), blk)
    slot = ((c[:, 1] % bs) * bs + c[:, 2] % bs) * bs + c[:, 3] % bs
    return rank * bs ** 3 + slot


def reference_steps(cfg: Dict, mix: Dict, root: str, seed: int, batches,
                    noise_rows: int, device, precision: str = "f32",
                    fault: Optional[str] = None) -> Dict:
    """The reference's three steps: per-step losses, the first gradient
    as Adam gets it (with the L2 decay), and the parameters after three.
    `fault` plants one of the faults a training step can have:
    'half_batch' (the loss over the first half of each batch only)."""
    import os

    from h100bench import work

    arrays = CK.load(os.path.join(root, cfg["weights"]))
    w = weights_on(arrays, device, requires_grad=True)
    net = PCGCv2(w, cfg["model"], precision)
    bs = int(cfg["block_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lr, wd = float(mix["lr"]), float(mix["weight_decay"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad1 = [], None
    with S.exact_f32():
        for t, clouds in enumerate(batches, start=1):
            noise = torch.rand(noise_rows * bs ** 3,
                               int(cfg["model"]["enc_channels"][-1]),
                               generator=gen, device=device) - 0.5
            if fault == "half_batch":
                clouds = clouds[:max(1, len(clouds) // 2)]
            s0 = work.batch_keys(clouds, device)

            def noise_fn(keys):
                return noise[noise_layout(keys, bs, int(mix["res"]))]

            loss = net.train_loss(s0, noise_fn, float(mix["alpha"]),
                                  float(mix["beta"]))
            grads = torch.autograd.grad(loss, list(w.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for (k, p), g in zip(w.items(), grads):
                    g = g + wd * p
                    if t == 1:
                        grad1 = grad1 or {}
                        grad1[k] = g.cpu().numpy().copy()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[k] / (1 - b1 ** t)
                    vh = v2[k] / (1 - b2 ** t)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach().cpu().numpy() for k, p in w.items()},
            "params0": arrays}


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def leaf_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
              ) -> Dict[str, float]:
    """Per leaf of `prog`: |norm of prog - norm of ref| over the larger of
    the reference's norm and the median leaf's."""
    rn = {k: _norm(ref[k]) for k in prog}
    med = float(np.median(list(rn.values())))
    return {k: abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30)
            for k in prog}


def rel_l2(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
           ) -> float:
    """||prog - ref|| / ||ref|| over all leaves of `prog` as one vector: a
    signed comparison, which an update gone the wrong way reads as 2 and
    one left out as 1."""
    num = sum(_norm(np.asarray(prog[k], np.float64)
                    - np.asarray(ref[k], np.float64)) ** 2 for k in prog)
    den = sum(_norm(ref[k]) ** 2 for k in prog)
    return float(np.sqrt(num / max(den, 1e-300)))


def train_numbers(prog: Dict, ref: Dict, alpha: float, beta: float
                  ) -> Dict[str, float]:
    """prog: the program's rows of steps 1-3, Adam's first moment after
    step 1, its parameters after step 3; ref: `reference_steps`.  The
    numbers of the module's docstring, and `_info`: the steps' losses and
    which leaves read worst."""
    losses = [alpha * float(r[0]) + beta * float(r[1]) for r in prog["rows"]]
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    g_prog = {k: v / (1 - 0.9) for k, v in prog["exp_avg"].items()}
    gn = {k: _norm(v) for k, v in ref["grad1"].items()}
    med = float(np.median(list(gn.values())))
    moving = [k for k in gn if gn[k] >= 1e-3 * med]
    d_prog = {k: prog["params"][k] - ref["params0"][k] for k in moving}
    d_ref = {k: ref["params"][k] - ref["params0"][k] for k in moving}
    gg = leaf_gaps(g_prog, ref["grad1"])
    ug = leaf_gaps(d_prog, d_ref)
    gk, uk = max(gg, key=gg.get), max(ug, key=ug.get)
    return {
        "loss1_gap": step_gaps[0],
        "loss_gap": max(step_gaps),
        "grad_gap": float(np.percentile(list(gg.values()), 75)),
        "grad_worst": gg[gk],
        "grad_dir": rel_l2(g_prog, ref["grad1"]),
        "update_gap": float(np.median(list(ug.values()))),
        "update_worst": ug[uk],
        "update_dir": rel_l2(d_prog, d_ref),
        "_info": (f"losses {losses} reference {ref['losses']} (program - "
                  f"reference: {[a - b for a, b in zip(losses, ref['losses'])]}"
                  f"); worst leaf: grad {gk}, update {uk}; left out of the "
                  f"update: {sorted(set(gn) - set(moving))}"),
    }
