"""Input pipeline of the port (counterpart of ``paddle_tpu/io``):
datasets, the DataLoader, and shape bucketing."""

from .bucketing import shape_bucket
from .dataloader import DataLoader, default_collate_fn
from .dataset import Dataset, TensorDataset

__all__ = ["shape_bucket", "Dataset", "TensorDataset", "DataLoader",
           "default_collate_fn"]
