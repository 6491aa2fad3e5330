"""Dataset base classes (a port of ``paddle_tpu/io/dataset.py``):
``Dataset``, ``IterableDataset``, ``TensorDataset``, ``Subset``,
``ConcatDataset``, ``ChainDataset``, ``ComposeDataset`` and
``random_split``. Samples are host-side numpy; ``random_split`` draws its
permutation from numpy's global generator, as the reference does, so a
``np.random.seed`` gives both packages the same split (its
``generator`` is taken and not read)."""
import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        from ..core.tensor import Tensor
        self.tensors = tensors
        lens = {t.shape[0] if isinstance(t, Tensor) else len(t)
                for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must have equal first dim")

    def __getitem__(self, idx):
        from ..core.tensor import Tensor
        return tuple(np.asarray(t.numpy()[idx]) if isinstance(t, Tensor)
                     else np.asarray(t[idx]) for t in self.tensors)

    def __len__(self):
        from ..core.tensor import Tensor
        t = self.tensors[0]
        return t.shape[0] if isinstance(t, Tensor) else len(t)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative[-1]

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative, idx)
        prev = self.cumulative[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, tuple):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"lengths sum to {total}, the dataset has "
                         f"{len(dataset)} samples")
    perm = np.random.permutation(total)
    out = []
    start = 0
    for ln in lengths:
        out.append(Subset(dataset, perm[start:start + ln].tolist()))
        start += ln
    return out
