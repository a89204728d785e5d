"""The streamed decode's structure ops and the rate-sweep CLI of the port
on the CPU.

`conv_up_structure` and `compact_where` must equal pcgcv2_tpu.ops.blocks
exactly (coords, mask, table, count, dropped), including capacity
overflow.  `run_sweep` runs the golden checkpoint on a small frame with
device="cpu" and writes the CSV of the results/ tables.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgcv2_torch.ops import blocks as TB
from pcgcv2_tpu.data.synthetic import sphere_cloud
from pcgcv2_tpu.ops import blocks as B
from tests.test_torch_blocks import _frame, _t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _production_dtypes():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", old)


_jit_blockify = jax.jit(B.blockify, static_argnums=(3, 4, 5, 6))


def _both(coords, feats, valid, nb_cap, stride, res):
    """blockify in both packages from the same numpy rows (JAX jitted:
    one compile instead of an eager dispatch per op)."""
    j = _jit_blockify(jnp.asarray(coords), jnp.asarray(feats),
                      jnp.asarray(valid), nb_cap, stride, res, 1)
    t = TB.blockify(_t(coords), _t(feats), _t(valid), nb_cap, stride, res, 1)
    return j, t


def _coarse():
    """The res-64 sphere frame at stride 2 (res 32), 8 random channels."""
    coords, _, valid = _frame()
    cloud = np.unique(coords[valid][:, 1:] // 2, axis=0)
    rows = np.zeros((4096, 4), np.int32)
    rows[:len(cloud), 1:] = cloud * 2
    valid = np.arange(4096) < len(cloud)
    feats = np.random.RandomState(2).randn(4096, 8)
    feats = (feats * valid[:, None]).astype(np.float32)
    return _both(rows, feats, valid, nb_cap=16, stride=2, res=32)


def assert_same_structure(j, t):
    assert (t.stride, t.res, t.num_batches) == (j.stride, j.res,
                                                j.num_batches)
    for name in ("coords", "table", "count", "dropped", "mask"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t, name)), np.asarray(getattr(j, name)),
            err_msg=name)


# the coarse frame's 8 blocks light 27 child blocks: 5 overflows
@pytest.mark.parametrize("nb_cap_out", [64, 5])
def test_conv_up_structure(nb_cap_out):
    j, t = _coarse()
    jo = jax.jit(B.conv_up_structure, static_argnums=1)(j, nb_cap_out)
    to = TB.conv_up_structure(t, nb_cap_out)
    assert_same_structure(jo, to)
    assert to.feats.shape == (nb_cap_out, TB.VOL, 1)
    assert to.feats.dtype == torch.float32 and not to.feats.any()
    assert (int(to.dropped) > 0) == (nb_cap_out == 5)
    assert not to.mask[-1].any()
    # the structure of the port's own generative up-conv on the same grid
    w = torch.zeros(8, t.channels, 4)
    assert_same_structure(to, TB.conv_up_generative(t, w, None, nb_cap_out))


# keep all blocks, none, or bx in [1, 3), whose 18 blocks overflow cap 6
@pytest.mark.parametrize("keep,nb_cap_out", [
    ("all", 64), ("none", 64), ("x-range", 6)])
def test_compact_where(keep, nb_cap_out):
    j, t = _both(*_frame(), nb_cap=64, stride=1, res=64)
    bx = np.asarray(j.coords[:, 1])
    block_keep = {"all": np.ones_like(bx, bool),
                  "none": np.zeros_like(bx, bool),
                  "x-range": (bx >= 1) & (bx < 3)}[keep]
    jo = jax.jit(B.compact_where, static_argnums=2)(
        j, jnp.asarray(block_keep), nb_cap_out)
    to = TB.compact_where(t, _t(block_keep), nb_cap_out)
    assert_same_structure(jo, to)
    np.testing.assert_array_equal(to.feats.numpy(), np.asarray(jo.feats))
    assert (int(to.dropped) > 0) == (keep == "x-range")
    assert int(to.count) == {"all": int(t.count), "none": 0,
                             "x-range": nb_cap_out - 1}[keep]


CSV_HEADER = os.path.join(ROOT, "results", "torus_vox10.csv")


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """run_sweep with the golden checkpoint on a 2,137-point sphere frame
    at res 32: scaling factor 1 with the warm-up rep, 0.5 without."""
    from pcgcv2_torch.cli.test import run_sweep
    from pcgcv2_torch.data.io import write_ply_ascii_geo

    d = tmp_path_factory.mktemp("sweep")
    cloud = sphere_cloud(32, density=1.5, seed=4)
    ply = str(d / "sphere32.ply")
    write_ply_ascii_geo(ply, cloud)
    ckpt = os.path.join(ROOT, "tests", "golden", "golden.ckpt")
    out = {}
    for sf in (1.0, 0.5):
        rd = str(d / f"results_{sf}")
        rows = run_sweep(ply, [ckpt], str(d / f"out_{sf}"), rd,
                         scaling_factor=sf, res=32, warmup=sf == 1.0,
                         device="cpu")
        out[sf] = dict(rows=rows, csv=os.path.join(rd, "sphere32.csv"),
                       outdir=str(d / f"out_{sf}"))
    return cloud, out


def test_sweep_csv_header_matches_results_tables(sweep):
    _, out = sweep
    with open(CSV_HEADER) as f:
        want = f.readline()
    with open(out[1.0]["csv"]) as f:
        got = list(f)
    assert got[0] == want
    assert len(got) == 2
    row = next(csv.DictReader(got))
    assert float(row["bpp"]) == out[1.0]["rows"][0]["bpp"]


def test_sweep_row(sweep):
    cloud, out = sweep
    (row,) = out[1.0]["rows"]
    assert row["num_points(input)"] == len(cloud)
    assert row["num_points(output)"] == len(cloud)  # rho 1
    files = ("_C.bin", "_F.bin", "_H.bin", "_num_points.bin")
    bits = sum(8 * os.path.getsize(os.path.join(out[1.0]["outdir"],
                                                "sphere32_r1" + e))
               for e in files)
    assert row["bits"] == bits
    # the CSV sums the four files' bpp, each rounded to 3 digits
    assert abs(row["bpp"] - bits / len(cloud)) <= 4 * 5e-4 + 5e-4
    assert np.isfinite(row["mseF,PSNR (p2point)"])
    assert np.isfinite(row["mseF,PSNR (p2plane)"])


def test_sweep_scaling_factor_rescales(sweep):
    from pcgcv2_torch.data.io import read_ply_geo
    from pcgcv2_torch.data.voxelize import scale_coords

    cloud, out = sweep
    (row,) = out[0.5]["rows"]
    assert row["num_points(input)"] == len(cloud)
    assert row["num_points(output)"] == len(scale_coords(cloud, 0.5))
    dec = read_ply_geo(os.path.join(out[0.5]["outdir"], "sphere32_r1_dec.ply"))
    assert len(dec) == row["num_points(output)"]
    assert (dec % 2 == 0).all() and dec.max() < 34


def test_sweep_main_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pcgcv2_torch.cli.test import main
    from pcgcv2_torch.data.io import write_ply_ascii_geo

    ply = str(tmp_path / "frame.ply")
    write_ply_ascii_geo(ply, sphere_cloud(16, density=1.0, seed=1))
    dtype = TB.COMPUTE_DTYPE
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--ckpts", os.path.join(ROOT, "tests/golden/golden.ckpt"),
                  "--filedir", ply, "--res", "16", "--device", "cuda",
                  "--outdir", str(tmp_path), "--resultdir", str(tmp_path)])
    finally:
        TB.set_compute_dtype(dtype)


@pytest.mark.parametrize("name,args", [
    ("sphere_cloud", (48, 1.5, 3)), ("torus_cloud", (170, 2.0, 42)),
    ("random_surface_cloud", (64, 5))])
def test_synthetic_frames_equal_jax(name, args):
    """The port's generators (deduplicated by int64 row keys) give the JAX
    package's frames, row for row."""
    from pcgcv2_torch.data import synthetic as TS
    from pcgcv2_tpu.data import synthetic as JS

    got = getattr(TS, name)(*args)
    want = getattr(JS, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
