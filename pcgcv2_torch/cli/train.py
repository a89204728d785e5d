"""Training CLI (twin of pcgcv2_tpu/cli/train.py): the JAX package's flags
plus --device.

    python -m pcgcv2_torch.cli.train --dataset DIR [--epoch N] ...

The first tenth of the sorted file list (.h5, else .ply) is the test set.
Checkpoints go to ./ckpts/<prefix>, logs to ./logs/<prefix>.  Runs on the
card (--device cuda, the default) and raises without one.
"""

from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dataset", default="./dataset/")
    p.add_argument("--dataset_num", type=int, default=int(2e4))
    p.add_argument("--alpha", type=float, default=1.0,
                   help="weight for distortion")
    p.add_argument("--beta", type=float, default=1.0, help="weight for rate")
    p.add_argument("--init_ckpt", default="")
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--check_time", type=float, default=10.0,
                   help="frequency for recording state (min)")
    p.add_argument("--prefix", type=str, default="tp",
                   help="prefix of checkpoints/logger")
    p.add_argument("--batch_capacity", type=int, default=524288,
                   help="max total voxels per collated batch")
    p.add_argument("--train_res", type=int, default=128,
                   help="coordinate bound of training crops (power of two "
                        ">= the dataset generator's res, default 127+1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain versions")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from pcgcv2_torch.config import BlockPlan, TrainConfig
    from pcgcv2_torch.data.dataset import PCDataset, iterate_batches
    from pcgcv2_torch.train.trainer import Trainer

    cfg = TrainConfig(
        alpha=args.alpha, beta=args.beta, lr=args.lr,
        batch_size=args.batch_size, epochs=args.epoch,
        check_time=args.check_time,
    )
    plan = BlockPlan.for_training(
        args.batch_capacity, args.train_res, args.batch_size)
    trainer = Trainer(
        cfg, plan, args.batch_capacity,
        logdir=os.path.join("./logs", args.prefix),
        ckptdir=os.path.join("./ckpts", args.prefix),
        init_ckpt=args.init_ckpt,
        seed=args.seed,
        device=args.device,
    )

    filedirs = sorted(glob.glob(os.path.join(args.dataset, "*.h5")))
    if not filedirs:
        filedirs = sorted(glob.glob(os.path.join(args.dataset, "*.ply")))
    filedirs = filedirs[:args.dataset_num]
    split = round(len(filedirs) / 10)
    train_ds = PCDataset(filedirs[split:])
    test_ds = PCDataset(filedirs[:split])
    trainer.logger.info(
        f"train files: {len(train_ds)}, test files: {len(test_ds)}")

    for epoch in range(args.epoch):
        trainer.train(iterate_batches(train_ds, args.batch_size, shuffle=True,
                                      seed=args.seed + epoch))
        trainer.test(iterate_batches(test_ds, args.batch_size, shuffle=False),
                     "Test")
    return trainer


if __name__ == "__main__":
    main()
