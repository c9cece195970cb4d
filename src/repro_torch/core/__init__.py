"""Core library: the generalization-aware schedule (numpy/scipy copies of
the JAX package's solvers) and the pruned-FedSGD round in torch."""
from repro_torch.core.generalization import phis
from repro_torch.core.convergence import BoundConstants
from repro_torch.core.optimizer_ao import AOConfig, Schedule, solve_p1
from repro_torch.core.pruning import PruneSpec
from repro_torch.core.packing import ParamPack
from repro_torch.core.round_engine import RoundEngine, kth_smallest_threshold
from repro_torch.core.federated import ClientData, FederatedTrainer, RoundMetrics

__all__ = [
    "phis", "BoundConstants", "AOConfig", "Schedule", "solve_p1",
    "PruneSpec", "ParamPack", "RoundEngine", "kth_smallest_threshold",
    "ClientData", "FederatedTrainer", "RoundMetrics",
]
