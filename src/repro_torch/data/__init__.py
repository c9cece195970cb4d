"""Data substrate: synthetic datasets, Dirichlet non-IID partitioning, and
the fleet-scale virtual rosters."""
from repro_torch.data.dirichlet import dirichlet_label_proportions, partition_by_dirichlet
from repro_torch.data.synthetic import SyntheticImageDataset, make_dataset
from repro_torch.data.fleet import FleetDataset, FleetRoster, make_fleet

__all__ = [
    "dirichlet_label_proportions", "partition_by_dirichlet",
    "SyntheticImageDataset", "make_dataset",
    "FleetDataset", "FleetRoster", "make_fleet",
]
