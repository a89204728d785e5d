"""The control, the reference computed in the precision below the
configuration's and put in the program's place, comes out not correct
against the cell's limits (here at a small size on the CPU; on the card
at the cell's size with `python3 -m h100bench.calibrate`)."""


import numpy as np
import pytest

from h100bench import check, generate, run
from h100bench.calibrate import CONTROL
from h100bench.reference import codec as RC


@pytest.mark.parametrize("cell", ["codec-vox10-bf16", "codec-vox10-f32"])
def test_codec_control_fails(root, cell):
    c = run.Cell(root, cell)
    control = CONTROL[c.cfg["compute_dtype"]]
    frame = generate.torus_cloud(96, density=4.0, seed=5)
    net, eb = check.reference_net(c.cfg, str(root), "cpu", "f32")
    low_net, _ = check.reference_net(c.cfg, str(root), "cpu", control)
    ref = RC.run_frame(net, eb, frame)
    low = RC.run_frame(low_net, eb, frame)
    out = dict(latent_xyz=low["latent_xyz"],
               latents_q=np.round(low["latents"]), decoded=low["decoded"])
    nums = check.codec_numbers(out, ref)
    assert any(v > c.limits[k] for k, v in nums.items()), nums
    same = check.codec_numbers(
        dict(latent_xyz=ref["latent_xyz"], latents_q=np.round(
            ref["latents"]), decoded=ref["decoded"]), ref)
    assert all(v == 0 for v in same.values())


def test_train_control_fails(root):
    c = run.Cell(root, "train-bf16")
    mix = dict(c.mix, res=32)
    pool = [generate.random_surface_cloud(31, seed=s, density=2.0)
            for s in range(6)]
    batches = [pool[0:2], pool[2:4], pool[4:6]]
    args = (c.cfg, mix, str(root), 7, batches, 3, "cpu")
    ref = check.reference_steps(*args)
    low = check.reference_steps(*args, precision=CONTROL[
        c.cfg["compute_dtype"]])
    prog = dict(rows=[[v / mix["alpha"], 0.0] for v in low["losses"]],
                exp_avg={k: v * 0.1 for k, v in low["grad1"].items()},
                params=low["params"])
    nums = check.train_numbers(prog, ref, mix["alpha"], mix["beta"])
    assert any(nums[k] > v for k, v in c.limits.items()), nums
