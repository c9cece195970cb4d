"""Data substrate: synthetic datasets and Dirichlet non-IID partitioning."""
from repro_torch.data.dirichlet import dirichlet_label_proportions, partition_by_dirichlet
from repro_torch.data.synthetic import SyntheticImageDataset, make_dataset

__all__ = [
    "dirichlet_label_proportions", "partition_by_dirichlet",
    "SyntheticImageDataset", "make_dataset",
]
