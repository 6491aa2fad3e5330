"""``paddle.io`` of the port: the dataset base classes
(``paddle_tpu/io/dataset.py``). The DataLoader, samplers and workers are
not ported yet."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
