"""Information-theoretic generalization statement (Lemma 1 / Proposition 1).

The paper defines, per client n, the *generalization statement*

    phi_n = (D_hat_n + D_til_n) / p'(z|D_hat_n)
            * | sqrt(2 (H(p(z|D_til_n)) - I(p(z|D_hat_n), p(z|D_til_n))))
                / (1 - D_til_n * sqrt(2 (H(p~) - I(p^,p~)))) |

where (eq. 38 of the paper) the entropy/mutual-information combination collapses
to a KL divergence between the train and test label distributions:

    H(p~) - I(p^, p~) = KL(p^ || p~),
    with I(p, q) := H(p) + H(q) - CE(p, q)   (CE = cross-entropy).

Small phi_n  <=>  the client's local training distribution is aligned with the
test distribution  <=>  its updates generalize; the selection problem (P4/P5)
prefers such clients.

All quantities are computed from empirical *label* histograms, exactly how the
paper's Dirichlet(sigma) non-IID simulation induces heterogeneity (Fig. 3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_EPS = 1e-12


def _as_dist(p: np.ndarray) -> np.ndarray:
    """Normalize a nonnegative histogram into a probability vector."""
    p = np.asarray(p, dtype=np.float64)
    if p.ndim != 1:
        raise ValueError(f"distribution must be 1-D, got shape {p.shape}")
    if np.any(p < 0):
        raise ValueError("histogram has negative mass")
    tot = p.sum()
    if tot <= 0:
        raise ValueError("histogram has zero mass")
    return p / tot


def entropy(p: Sequence[float]) -> float:
    """Shannon entropy H(p) in nats."""
    p = _as_dist(np.asarray(p))
    nz = p > _EPS
    return float(-(p[nz] * np.log(p[nz])).sum())


def cross_entropy(p: Sequence[float], q: Sequence[float]) -> float:
    """Cross entropy CE(p, q) = -sum p log q (nats). Infinite if supp(p) !<= supp(q)."""
    p, q = _as_dist(np.asarray(p)), _as_dist(np.asarray(q))
    if p.shape != q.shape:
        raise ValueError("distributions must share support size")
    nz = p > _EPS
    if np.any(q[nz] <= _EPS):
        return float("inf")
    return float(-(p[nz] * np.log(q[nz])).sum())


def mutual_information_term(p_train: Sequence[float], p_test: Sequence[float]) -> float:
    """I(p^, p~) := H(p^) + H(p~) - CE(p^, p~), the paper's eq. (38) decomposition."""
    return entropy(p_train) + entropy(p_test) - cross_entropy(p_train, p_test)


def kl_divergence(p: Sequence[float], q: Sequence[float]) -> float:
    """KL(p || q) in nats, = H(q-term) - I in the paper's decomposition."""
    p, q = _as_dist(np.asarray(p)), _as_dist(np.asarray(q))
    nz = p > _EPS
    if np.any(q[nz] <= _EPS):
        return float("inf")
    return float((p[nz] * (np.log(p[nz]) - np.log(q[nz]))).sum())


@dataclasses.dataclass(frozen=True)
class GeneralizationStatement:
    """phi_n plus its constituent terms, for reporting (Fig. 3 reproduction)."""

    phi: float
    kl: float                 # KL(p_train || p_test) = H(p~) - I(p^,p~)
    entropy_test: float       # H(p(z|D~))
    mutual_information: float  # I(p^, p~)
    p_min_train: float        # p'(z|D_hat): least-frequent *present* train prob
    d_train: int
    d_test: int


def generalization_statement(
    train_hist: Sequence[float],
    test_hist: Sequence[float],
    *,
    d_train: int | None = None,
    d_test: int | None = None,
    size_normalized: bool = True,
) -> GeneralizationStatement:
    """Compute phi_n (Lemma 1) from train/test label histograms.

    Args:
      train_hist: per-class sample counts of the client's training split D_hat_n.
      test_hist:  per-class sample counts of the (sampled) test split D_til_n.
      d_train/d_test: dataset sizes D_hat_n / D_til_n; default = histogram mass.
      size_normalized: the raw Lemma-1 constant uses the absolute dataset sizes
        (D_hat+D_til) and 1 - D_til*sqrt(.); with thousands of samples the raw
        value saturates for every client and loses all discriminative power. The
        paper's own Fig. 3 plots client-distinguishing phi values, which requires
        the *size-normalized* variant (sizes expressed as fractions of the global
        dataset). Both are available; `size_normalized=True` is what the
        selection optimizer consumes.

    Returns the statement with diagnostics. phi is clipped to [0, PHI_MAX] for
    degenerate supports (disjoint train/test support => KL = inf => phi -> cap).
    """
    th = np.asarray(train_hist, dtype=np.float64)
    eh = np.asarray(test_hist, dtype=np.float64)
    # histograms may carry fractional mass (proportions); sizes round up
    d_tr = int(np.ceil(th.sum())) if d_train is None else int(d_train)
    d_te = int(np.ceil(eh.sum())) if d_test is None else int(d_test)
    if d_tr <= 0 or d_te <= 0:
        raise ValueError("empty train or test split")

    p_tr = _as_dist(th)
    p_te = _as_dist(eh)
    h_test = entropy(p_te)
    mi = mutual_information_term(p_tr, p_te)
    kl = kl_divergence(p_tr, p_te)  # == h_test - mi up to fp error when finite

    present = p_tr > _EPS
    p_min = float(p_tr[present].min())

    if size_normalized:
        tot = float(d_tr + d_te)
        size_sum = (d_tr + d_te) / tot          # == 1; relative scale
        d_til = d_te / tot
    else:
        size_sum = float(d_tr + d_te)
        d_til = float(d_te)

    if not np.isfinite(kl):
        phi = PHI_MAX
    else:
        root = np.sqrt(max(2.0 * kl, 0.0))
        denom = 1.0 - d_til * root
        if abs(denom) < _EPS:
            phi = PHI_MAX
        else:
            phi = (size_sum / p_min) * abs(root / denom)
            phi = float(min(phi, PHI_MAX))
    return GeneralizationStatement(
        phi=float(phi), kl=float(kl), entropy_test=h_test,
        mutual_information=float(mi), p_min_train=p_min,
        d_train=d_tr, d_test=d_te,
    )


#: Cap applied when the Lemma-1 constant blows up (disjoint supports / denom ~ 0).
PHI_MAX = 1e6


def client_statements(
    train_hists: np.ndarray, test_hists: np.ndarray, **kw
) -> list[GeneralizationStatement]:
    """Vector helper: one statement per client row."""
    train_hists = np.atleast_2d(np.asarray(train_hists))
    test_hists = np.atleast_2d(np.asarray(test_hists))
    if test_hists.shape[0] == 1 and train_hists.shape[0] > 1:
        test_hists = np.broadcast_to(test_hists, train_hists.shape)
    return [
        generalization_statement(tr, te, **kw)
        for tr, te in zip(train_hists, test_hists)
    ]


def phis(train_hists: np.ndarray, test_hists: np.ndarray, **kw) -> np.ndarray:
    """Just the phi values, shape [N]."""
    return np.array([s.phi for s in client_statements(train_hists, test_hists, **kw)])


def generalization_gap_increment_bound(
    selected_phis: np.ndarray, eta: float, grad_sq_norm: float
) -> float:
    """Proposition 1: bound on phi^{(s+1)} - phi^{(s)} (generalization-gap drift).

        0.5 * (eta^2 + |sum_n a_n phi_n|^2) * E||G(w~)||^2

    `selected_phis` are the phi_n of the *selected* clients only.
    """
    s = float(np.sum(selected_phis))
    return 0.5 * (eta**2 + s * s) * float(grad_sq_norm)
