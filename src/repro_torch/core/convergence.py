"""Theorem 1: generalization-aware average-squared-gradient-norm bound.

    (1/(S+1)) sum_s E||grad L~(w~^(s))||^2  <=  theta({a,lambda})
      = alpha
      + beta  * sum_s 1 / (sum_n a_n^(s))
      + sum_s [ gamma1 * |sum_n a_n^(s) phi_n|^2
              + gamma2 *  sum_n a_n^(s) lambda_n^(s) ] / (sum_n a_n^(s))

with
    alpha  = 2 (L(w0) - L(w*)) / (eta (S+1))
    beta   = eta^3 A^2 (L + 1) / (Z (S+1))
    gamma1 = eta A^2 / (Z (S+1))
    gamma2 = L^2 B^2 / (S+1)

This module is the single source of truth for theta: the AO optimizer (P1) and
every benchmark evaluate exactly these functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoundConstants:
    """Assumption constants of Theorem 1."""

    lipschitz_L: float = 10.0    # Assumption 1
    grad_bound_A2: float = 10.0  # Assumption 3: E||g||^2 <= A^2   (A2 == A^2)
    model_bound_B2: float = 10.0  # Assumption 3: E||w||^2 <= B^2  (B2 == B^2)
    loss_gap: float = 10.0       # L(w^(0)) - L(w^*)
    eta: float = 0.01            # learning rate
    batch_Z: int = 32            # per-client mini-batch size
    rounds_S: int = 100          # S (the paper sums s = 0..S, i.e. S+1 rounds)

    def __post_init__(self):
        if min(self.lipschitz_L, self.grad_bound_A2, self.model_bound_B2) < 0:
            raise ValueError("assumption constants must be nonnegative")
        if self.eta <= 0 or self.batch_Z < 1 or self.rounds_S < 0:
            raise ValueError("eta>0, Z>=1, S>=0 required")

    @property
    def s_plus_1(self) -> int:
        return self.rounds_S + 1

    @property
    def alpha(self) -> float:
        return 2.0 * self.loss_gap / (self.eta * self.s_plus_1)

    @property
    def beta(self) -> float:
        return (self.eta**3) * self.grad_bound_A2 * (self.lipschitz_L + 1.0) / (
            self.batch_Z * self.s_plus_1)

    @property
    def gamma1(self) -> float:
        return self.eta * self.grad_bound_A2 / (self.batch_Z * self.s_plus_1)

    @property
    def gamma2(self) -> float:
        return (self.lipschitz_L**2) * self.model_bound_B2 / self.s_plus_1


def round_term(
    a: np.ndarray, lam: np.ndarray, phi: np.ndarray, c: BoundConstants
) -> float:
    """Per-round contribution to theta (the summand for one s).

    a:   [N] binary selection indicators.
    lam: [N] pruning ratios in [0, 1).
    phi: [N] generalization statements.
    """
    a = np.asarray(a, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    n_sel = a.sum()
    if n_sel < 1:
        return float("inf")  # a round with no client makes the bound vacuous
    gen = c.gamma1 * float(np.dot(a, phi)) ** 2
    prune = c.gamma2 * float(np.dot(a, lam))
    return (c.beta + gen + prune) / float(n_sel)


def theta(
    a: np.ndarray, lam: np.ndarray, phi: np.ndarray, c: BoundConstants
) -> float:
    """Full Theorem-1 bound.

    a:   [S+1, N] selection indicators per round.
    lam: [S+1, N] pruning ratios per round.
    phi: [N]      per-client generalization statements (round-invariant, as in
                  the paper: phi_n depends only on the client's data split).
    """
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    lam = np.atleast_2d(np.asarray(lam, dtype=np.float64))
    if a.shape != lam.shape:
        raise ValueError(f"a{a.shape} and lambda{lam.shape} must match")
    total = c.alpha
    for s in range(a.shape[0]):
        total += round_term(a[s], lam[s], phi, c)
    return float(total)


def theta_decomposition(
    a: np.ndarray, lam: np.ndarray, phi: np.ndarray, c: BoundConstants
) -> dict[str, float]:
    """theta split into its four named terms (for EXPERIMENTS.md reporting)."""
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    lam = np.atleast_2d(np.asarray(lam, dtype=np.float64))
    phi = np.asarray(phi, dtype=np.float64)
    n_sel = a.sum(axis=1)
    if np.any(n_sel < 1):
        return {"alpha": c.alpha, "participation": float("inf"),
                "generalization": float("inf"), "pruning": float("inf"),
                "total": float("inf")}
    part = float((c.beta / n_sel).sum())
    gen = float((c.gamma1 * (a @ phi) ** 2 / n_sel).sum())
    prune = float((c.gamma2 * (a * lam).sum(axis=1) / n_sel).sum())
    return {
        "alpha": c.alpha,
        "participation": part,
        "generalization": gen,
        "pruning": prune,
        "total": c.alpha + part + gen + prune,
    }
