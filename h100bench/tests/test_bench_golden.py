"""The reference alone reproduces the golden triple of
`tests/golden/` within `test_golden`'s tolerances."""

import json

from h100bench.check import reference_bits
from h100bench.generate import torus_cloud
from h100bench.reference import bits, ckpt, model
from h100bench.reference.codec import run_frame
from h100bench.reference.d1 import d1_psnr


def test_golden_triple(root):
    exp = json.loads((root / "tests/golden/expected.json").read_text())
    cloud = torus_cloud(170, density=2.0, seed=42)
    assert len(cloud) == exp["n_points"]
    w = ckpt.load(str(root / "tests/golden/golden.ckpt"))
    cfg = json.loads((root / "h100bench/configs/pcgcv2-r4-f32.json")
                     .read_text())["model"]
    net = model.PCGCv2(model.weights_on(w, "cpu"), cfg)
    ref = run_frame(net, bits.entropy_params(w), cloud)
    bpp = reference_bits(ref) / len(cloud)
    assert abs(bpp - exp["bpp"]) <= 0.005 * exp["bpp"]
    assert abs(d1_psnr(cloud, ref["decoded"], 256) - exp["d1_psnr"]) <= 0.05
    assert len(ref["decoded"]) == exp["n_points"]
