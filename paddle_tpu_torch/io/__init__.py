"""Input pipeline of the port (counterpart of ``paddle_tpu/io``):
datasets, samplers, the DataLoader with its worker threads and device
prefetcher, host-to-device staging, and shape bucketing."""

from .bucketing import shape_bucket
from .dataloader import DataLoader, default_collate_fn
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, WorkerInfo,
                      get_worker_info, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["shape_bucket", "Dataset", "IterableDataset", "TensorDataset",
           "ComposeDataset", "ChainDataset", "ConcatDataset", "Subset",
           "random_split", "WorkerInfo", "get_worker_info", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "SubsetRandomSampler",
           "DataLoader", "default_collate_fn"]
