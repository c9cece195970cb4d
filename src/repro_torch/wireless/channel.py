"""Channel model: IID Rayleigh fading with average path loss (Sec. V setup).

The paper: "Channel coefficients are modeled as IID Rayleigh fading with an
average path loss of 1e-5, and remain constant during all rounds."

Beyond the paper's noiseless-aggregation assumption, `GaussianAggregateNoise`
models a noisy uplink aggregation channel (Wu et al., "Information-Theoretic
Generalization Analysis for Topology-aware Heterogeneous FEEL over Noisy
Channels"): the server observes the averaged gradient plus AWGN,
``y^(s) = (1/C) sum_n g_n^(s) + n^(s)``, and both broadcasts and updates
with the noisy aggregate. The noise is drawn per round on host, keyed ONLY
by ``(seed, round)`` — so the draw is identical whether the round executes
through the per-round path, a multi-round block, or a checkpoint resume —
and generated directly in the packed ``[R, 128]`` buffer layout so the
device-resident engines consume it without restructuring (the reference
backend unpacks the same buffer; see core/federated.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def rayleigh_gains(
    n: int, *, path_loss: float = 1e-5, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Draw n channel power gains h = path_loss * |CN(0,1)|^2.

    |CN(0,1)|^2 is exponential(1), so E[h] = path_loss.
    """
    rng = rng or np.random.default_rng(0)
    return path_loss * rng.exponential(scale=1.0, size=n)


@dataclasses.dataclass
class ChannelModel:
    """Holds uplink/downlink gains for N clients, constant across rounds."""

    n_clients: int
    path_loss: float = 1e-5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.uplink = rayleigh_gains(self.n_clients, path_loss=self.path_loss, rng=rng)
        self.downlink = rayleigh_gains(self.n_clients, path_loss=self.path_loss, rng=rng)

    def gains(self) -> tuple[np.ndarray, np.ndarray]:
        return self.uplink, self.downlink


@dataclasses.dataclass(frozen=True)
class GaussianAggregateNoise:
    """AWGN on the aggregated gradient: v^(s) <- mean(g) + std * N(0, I).

    The per-round draw is a pure function of ``(seed, round)`` — NOT of a
    shared stream position — which is what makes the trajectory invariant
    to dispatch grouping (rounds_per_dispatch=1 vs K) and to checkpoint
    resume. ``sample_packed`` emits the noise in the packed ``[rows, 128]``
    fp32 layout; ``valid`` (ParamPack.valid_mask) zeroes the padding lanes
    so noise can never leak into the buffer tail that real coordinates
    don't occupy. The default std is a mild perturbation relative to the
    engines' O(1) gradient scales — spec files set their own via
    ``WirelessSpec.noise_kwargs={"std": ...}``.
    """

    std: float = 1e-3
    seed: int = 0

    def sample_packed(self, round_index: int, shape: tuple[int, int],
                      valid: np.ndarray | None = None) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed & 0xFFFFFFFF,
                                    int(round_index)]))
        nz = (self.std * rng.standard_normal(shape)).astype(np.float32)
        if valid is not None:
            nz *= valid
        return nz
