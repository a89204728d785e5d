"""Datasets and batch iteration (own copy of pcgcv2_tpu/data/dataset.py).

Batches are plain lists of [N, 3] int32 numpy arrays; `data.voxelize.
collate` pads them into the rows the model takes.  The whole dataset is
cached in RAM, and the same numpy RandomState seed gives the same batch
order as the JAX package."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from pcgcv2_torch.data.io import load_coords


class PCDataset:
    """Point-cloud files (.h5 / .ply) with in-RAM caching."""

    def __init__(self, files: Sequence[str], cache: bool = True):
        self.files = list(files)
        self._cache = {} if cache else None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        coords = load_coords(self.files[idx]).astype(np.int32)
        if self._cache is not None:
            self._cache[idx] = coords
        return coords


def iterate_batches(
    dataset: PCDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    repeat: bool = False,
    drop_last: bool = False,
) -> Iterator[List[np.ndarray]]:
    """Yield lists of coord arrays (one list = one collated batch)."""
    rng = np.random.RandomState(seed)
    while True:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i:i + batch_size]
            if drop_last and len(idxs) < batch_size:
                continue
            yield [dataset[int(j)] for j in idxs]
        if not repeat:
            return
