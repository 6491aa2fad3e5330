"""``paddle.io`` of the port (reference ``paddle_tpu/io``): the dataset
base classes, the samplers, ``DataLoader`` with ``default_collate_fn``
(in-process, or over worker processes with shared-memory transport and
the buffered reader) and ``get_worker_info``."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, WeightedRandomSampler,
)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .worker import WorkerInfo, get_worker_info  # noqa: F401
