"""``paddle.io`` of the port — port of ``paddle_tpu/io``: datasets,
samplers, collation, the ``DataLoader`` (in-process, threads, or worker
processes with shared-memory transport) and ``DeviceLoader`` (host→device
staging on a side stream)."""
from .collate import default_collate_fn, default_convert_fn  # noqa: F401
from .dataloader import DataLoader, get_worker_info  # noqa: F401
from .dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .device_loader import DeviceLoader  # noqa: F401
from .sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)
