"""Dataset generation CLI (twin of pcgcv2_tpu/cli/generate_dataset.py, the
same flags and the same clouds).

    python -m pcgcv2_torch.cli.generate_dataset --mesh_rootdir DIR \\
        --pc_rootdir OUT [--out_filetype ply]
    python -m pcgcv2_torch.cli.generate_dataset --synthetic 20 \\
        --pc_rootdir OUT --out_filetype ply

Samples `--num_mesh` meshes (.off / .obj) under `--mesh_rootdir` into
voxelized clouds, or with `--synthetic N` writes N procedural surface
clouds (data/synthetic.py::random_surface_cloud) and needs no mesh
dataset.  `h5` output needs h5py; `ply` needs nothing beyond numpy.
Pure host code: no device.
"""

from __future__ import annotations

import argparse
import os
import random


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--mesh_rootdir", default="./ModelNet40/")
    p.add_argument("--pc_rootdir", default="./dataset/")
    p.add_argument("--out_filetype", choices=["h5", "ply"], default="h5")
    p.add_argument("--num_mesh", type=int, default=100)
    p.add_argument("--n_points", type=int, default=int(4e5))
    p.add_argument("--resolution", type=int, default=127)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N procedural surface clouds instead of "
                        "sampling meshes (no mesh dataset required)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the CLI; returns the number of clouds written."""
    args = parse_args(argv)
    if args.synthetic:
        from pcgcv2_torch.data.io import write_h5_geo, write_ply_ascii_geo
        from pcgcv2_torch.data.synthetic import random_surface_cloud

        os.makedirs(args.pc_rootdir, exist_ok=True)
        write = (write_ply_ascii_geo if args.out_filetype == "ply"
                 else write_h5_geo)
        for i in range(args.synthetic):
            pts = random_surface_cloud(args.resolution + 1,
                                       seed=args.seed * 1_000_003 + i)
            write(os.path.join(args.pc_rootdir,
                               f"synth_{i:05d}.{args.out_filetype}"), pts)
        print("written:", args.synthetic)
        return args.synthetic

    from pcgcv2_torch.data.generate import generate_dataset, traverse_meshes

    meshes = traverse_meshes(args.mesh_rootdir)
    print("mesh files found:", len(meshes))
    rng = random.Random(args.seed)
    picked = rng.sample(meshes, min(args.num_mesh, len(meshes)))
    written = generate_dataset(
        picked, args.pc_rootdir, args.out_filetype,
        n_points=args.n_points, resolution=args.resolution, seed=args.seed)
    print("written:", written)
    return written


if __name__ == "__main__":
    main()
