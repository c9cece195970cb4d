"""Core library: the generalization-aware schedule (numpy/scipy copies of
the JAX package's solvers), the pruned-FedSGD round in torch, its client
stores (replicated and streamed) and its scenario axes (fault models,
robust aggregators)."""
from repro_torch.core.generalization import phis
from repro_torch.core.convergence import BoundConstants
from repro_torch.core.optimizer_ao import (AOConfig, Schedule, solve_p1,
                                          solve_random)
from repro_torch.core.pruning import PruneSpec
from repro_torch.core.packing import ParamPack
from repro_torch.core.round_engine import RoundEngine, kth_smallest_threshold
from repro_torch.core.client_store import (ClientStore, StoreBudgetError,
                                           estimated_store_nbytes)
from repro_torch.core.cohort_store import CohortStore, fleet_counters_zero
from repro_torch.core.federated import ClientData, FederatedTrainer, RoundMetrics
from repro_torch.core.faults import (
    ClientDropout, CorruptUpload, FaultDraw, FaultModel, GaussianPoison,
    MixedFaults, ScaledMalicious, SignFlip, StragglerTimeout,
)
from repro_torch.core.aggregators import (
    AGGREGATORS, Aggregator, aggregator_names, make_aggregator,
    register_aggregator,
)

__all__ = [
    "phis", "BoundConstants", "AOConfig", "Schedule", "solve_p1",
    "solve_random",
    "PruneSpec", "ParamPack", "RoundEngine", "kth_smallest_threshold",
    "ClientStore", "StoreBudgetError", "estimated_store_nbytes",
    "CohortStore", "fleet_counters_zero",
    "ClientData", "FederatedTrainer", "RoundMetrics",
    "ClientDropout", "CorruptUpload", "FaultDraw", "FaultModel",
    "GaussianPoison", "MixedFaults", "ScaledMalicious", "SignFlip",
    "StragglerTimeout",
    "AGGREGATORS", "Aggregator", "aggregator_names", "make_aggregator",
    "register_aggregator",
]
