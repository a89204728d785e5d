"""The port's dataset generator (pcgcv2_torch/data/generate.py and
cli/generate_dataset.py) against the JAX package's on tiny meshes written
into tmp_path: the OFF/OBJ readers, the surface sampler, the rotation, the
mesh -> voxels chain and the writers give the same arrays and files from
the same seeds."""

import filecmp
import os

import numpy as np
import pytest

from pcgcv2_torch.cli import generate_dataset as TCLI
from pcgcv2_torch.data import generate as TG
from pcgcv2_torch.data import io as TIO
from pcgcv2_tpu.cli import generate_dataset as JCLI
from pcgcv2_tpu.data import generate as JG

# a unit cube of quads (fan-triangulated by the readers); the OBJ's top
# face is a fan of 4 triangles around its centre instead (an OFF file read
# with np.loadtxt needs one vertex count on every face line)
CUBE_V = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
          (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1), (0.5, 0.5, 1.0)]
CUBE_F = [(0, 3, 2, 1), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
          (3, 0, 4, 7), (4, 5, 6, 7)]
FAN_F = CUBE_F[:5] + [(4, 5, 8), (5, 6, 8), (6, 7, 8), (7, 4, 8)]


def _write_off(path, glued=False, verts=CUBE_V, faces=CUBE_F):
    head = (f"OFF{len(verts)} {len(faces)} 0\n" if glued
            else f"OFF\n{len(verts)} {len(faces)} 0\n")
    with open(path, "w") as f:
        f.write(head)
        for v in verts:
            f.write(" ".join(map(str, v)) + "\n")
        for face in faces:
            f.write(f"{len(face)} " + " ".join(map(str, face)) + "\n")


def _write_obj(path, verts=CUBE_V, faces=FAN_F):
    with open(path, "w") as f:
        f.write("# cube\n")
        for v in verts:
            f.write("v " + " ".join(map(str, v)) + "\n")
        for face in faces:  # 1-based, with texture/normal indices
            f.write("f " + " ".join(f"{i + 1}/{i + 1}/1" for i in face)
                    + "\n")


@pytest.fixture
def meshes(tmp_path):
    root = tmp_path / "meshes"
    (root / "sub").mkdir(parents=True)
    _write_off(root / "a.off")
    _write_off(root / "sub" / "b.off", glued=True)
    _write_obj(root / "sub" / "c.obj")
    _write_off(root / "flat.off", verts=[(0, 0, 0), (1, 0, 0), (2, 0, 0)],
               faces=[(0, 1, 2)])  # zero area: generate_dataset skips it
    (root / "notes.txt").write_text("not a mesh")
    return root


@pytest.mark.parametrize("name", ["a.off", "sub/b.off", "sub/c.obj"])
def test_readers_match_jax(meshes, name):
    path = str(meshes / name)
    read = "read_obj" if name.endswith(".obj") else "read_off"
    v, f = getattr(TG, read)(path)
    jv, jf = getattr(JG, read)(path)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.dtype == jv.dtype and f.dtype == jf.dtype
    assert f.shape == (12 if read == "read_off" else 14, 3)


def test_read_off_rejects_other_files(meshes):
    with pytest.raises(ValueError, match="not an OFF file"):
        TG.read_off(str(meshes / "notes.txt"))


def test_sampler_and_rotation_match_jax(meshes):
    v, f = TG.read_off(str(meshes / "a.off"))
    for seed in (0, 7):
        pts = TG.sample_mesh_uniform(v, f, 5000, np.random.RandomState(seed))
        ref = JG.sample_mesh_uniform(v, f, 5000, np.random.RandomState(seed))
        np.testing.assert_array_equal(pts, ref)
        np.testing.assert_array_equal(
            TG.random_rotation(np.random.RandomState(seed)),
            JG.random_rotation(np.random.RandomState(seed)))
    with pytest.raises(ValueError, match="degenerate"):
        TG.sample_mesh_uniform(np.zeros((3, 3)), np.array([[0, 1, 2]]), 10)


@pytest.mark.parametrize("name", ["a.off", "sub/c.obj"])
def test_mesh_to_points_matches_jax(meshes, name):
    path = str(meshes / name)
    pts = TG.mesh_to_points(path, 20000, 63, np.random.RandomState(3))
    ref = JG.mesh_to_points(path, 20000, 63, np.random.RandomState(3))
    np.testing.assert_array_equal(pts, ref)
    assert len(pts) > 1000 and pts.min() >= 0 and pts.max() <= 63


def test_generate_dataset_matches_jax(meshes, tmp_path):
    files = TG.traverse_meshes(str(meshes))
    assert files == JG.traverse_meshes(str(meshes))
    assert [os.path.basename(p) for p in files] == [
        "a.off", "flat.off", "b.off", "c.obj"]
    kw = dict(out_filetype="ply", n_points=8000, resolution=31, seed=4)
    n = TG.generate_dataset(files, str(tmp_path / "t"), **kw)
    jn = JG.generate_dataset(files, str(tmp_path / "j"), **kw)
    assert n == jn == 3  # the flat mesh is skipped
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False), name


@pytest.mark.parametrize("filetype", ["ply", "h5"])
def test_cli_synthetic_matches_jax(tmp_path, filetype):
    if filetype == "h5":
        pytest.importorskip("h5py")
    args = ["--synthetic", "3", "--resolution", "31", "--seed", "2",
            "--out_filetype", filetype]
    assert TCLI.main(args + ["--pc_rootdir", str(tmp_path / "t")]) == 3
    JCLI.main(args + ["--pc_rootdir", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 3
    for name in names:
        pts = TIO.load_coords(str(tmp_path / "t" / name))
        np.testing.assert_array_equal(
            pts, TIO.load_coords(str(tmp_path / "j" / name)))
        assert len(pts) > 100


def test_cli_meshes_match_jax(meshes, tmp_path):
    args = ["--mesh_rootdir", str(meshes), "--num_mesh", "2", "--n_points",
            "6000", "--resolution", "31", "--seed", "1", "--out_filetype",
            "ply"]
    TCLI.main(args + ["--pc_rootdir", str(tmp_path / "t")])
    JCLI.main(args + ["--pc_rootdir", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and names
    for name in names:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False), name
