"""(P4)/(P5): client selection, and per-client data selection.

Per-round objective (Theorem 1 summand):

    J_s(a) = ( beta + gamma1 |sum_n a_n phi_n|^2 + gamma2 sum_n a_n lambda_n )
             / sum_n a_n

subject to the round's energy/delay feasibility. Two solvers:

* `method="exact"` (beyond-paper): with N <= `EXACT_LIMIT` clients the
  per-round subproblem is enumerated over all 2^N - 1 subsets — globally
  optimal per round. Round coupling through the shared budgets is handled by
  an energy-price bisection (Lagrangian on the total-energy row), which is
  exact when rounds are exchangeable (constant channels, as in the paper).
* `method="paper"`: the paper's alternation on (a, mu): fix mu = current
  quadratic+pruning term, relax a to [0,1], solve the resulting program by
  projected gradient, round by threshold sweep, update mu; iterate until the
  objective stops decreasing (Sec. IV-B-3).

Per-client DATA selection (`data_selection_*`, beyond the paper): Albaseer
et al. ("Fine-Grained Data Selection for Improved Energy Efficiency of
Federated Edge Learning") have each client train on a curated subset of its
local samples — excluding marginal/noisy ones — to cut per-round energy at
matched accuracy. Reproduced here as deterministic per-client sample
filters applied ONCE per run, before training: each sample is scored by its
squared distance to its class centroid within the client's own shard (a
model-free typicality proxy), and a policy keeps either the samples under a
relative score threshold (`threshold`) or a fixed fraction of the most
typical ones (`fine_grained`). Static filtering composes with the packed /
block engines untouched — smaller clients simply ride the existing ragged
path — so the axis adds zero per-round host work (the experiment API wires
it through `SchemeSpec.data_selection`).
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.convergence import BoundConstants
from repro_torch.core.resource import solve_round_resources
from repro_torch.wireless.comm import SystemParams

EXACT_LIMIT = 16


# ---------------------------------------------------------------------------
# Per-client data selection (Albaseer-style threshold / fine-grained filters)
# ---------------------------------------------------------------------------

def data_selection_scores(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-sample atypicality: squared distance to the sample's class
    centroid, computed within the client's own shard. Deterministic in
    (x, y); lower = more typical. Classes with a single sample score 0."""
    y = np.asarray(y)
    if len(y) == 0:
        return np.zeros(0, np.float64)
    x = np.asarray(x, np.float64).reshape(len(y), -1)
    scores = np.zeros(len(y), np.float64)
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        centroid = x[idx].mean(axis=0)
        scores[idx] = ((x[idx] - centroid) ** 2).sum(axis=1)
    return scores


def data_selection_keep_mask(
    x: np.ndarray, y: np.ndarray, *, policy: str, tau: float = 1.5,
    keep_frac: float = 0.8,
) -> np.ndarray:
    """Boolean keep-mask for one client's samples under a selection policy.

    ``policy="threshold"``: keep samples whose score is <= tau * mean
    score (relative threshold — scale-free across clients with very
    different shard sizes / spreads). ``policy="fine_grained"``: keep the
    ``ceil(keep_frac * n)`` most typical samples (ties broken by original
    order via a stable argsort). Both always keep at least one sample, and
    kept samples preserve their original order, so the filtered shard is
    reproducible and independent of any RNG."""
    scores = data_selection_scores(x, y)
    n = len(scores)
    if policy == "threshold":
        if tau <= 0:
            raise ValueError(f"tau must be > 0, got {tau}")
        keep = scores <= tau * (scores.mean() if n else 0.0)
    elif policy == "fine_grained":
        if not 0.0 < keep_frac <= 1.0:
            raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
        k = max(1, int(np.ceil(keep_frac * n)))
        keep = np.zeros(n, bool)
        keep[np.argsort(scores, kind="stable")[:k]] = True
    else:
        raise ValueError(f"unknown data-selection policy {policy!r}")
    if not keep.any() and n:
        keep[int(np.argmin(scores))] = True
    return keep


def round_objective(
    a: np.ndarray, lam: np.ndarray, phi: np.ndarray, c: BoundConstants,
    coupling: str = "sum",
) -> float:
    """Per-round selection objective.

    coupling="sum":  the literal Theorem-1 summand — gamma1 |sum a phi|^2 / n.
      Its quadratic growth in the number of selected clients makes the exact
      minimizer degenerate to the single lowest-phi client (EXPERIMENTS.md
      §Paper findings).
    coupling="mean": gamma1 * (mean selected phi)^2 — the normalized variant
      that recovers the paper's reported multi-client behavior."""
    n_sel = float(np.sum(a))
    if n_sel < 1:
        return float("inf")
    quad = c.gamma1 * float(np.dot(a, phi)) ** 2
    if coupling == "mean":
        quad /= n_sel ** 2
    return (c.beta + quad + c.gamma2 * float(np.dot(a, lam))) / n_sel


def _subset_feasible(
    a: np.ndarray, lam: np.ndarray, t_round: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> tuple[bool, float]:
    """Check a candidate round subset against the per-round delay budget and
    return its min-energy cost (for the energy price)."""
    ra = solve_round_resources(a, lam, t_round, h_up, h_down, sp)
    return ra.feasible, ra.energy


def _per_client_table(
    lam: np.ndarray, t_round: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-client (feasible, min-energy) under the round budget.

    Given the per-round delay budget, client allocations are independent
    (FDMA: no shared uplink resource beyond the pre-assigned bandwidth), so a
    subset is feasible iff every member is, and its energy is the sum. This
    turns the 2^N enumeration into vector ops.
    """
    from repro_torch.core.resource import allocate_client
    n = len(lam)
    feas = np.zeros(n, dtype=bool)
    energy = np.zeros(n)
    for i in range(n):
        al = allocate_client(i, float(lam[i]), t_round, h_up, h_down, sp)
        feas[i], energy[i] = al.feasible, al.energy
    return feas, energy


def select_round_exact(
    lam: np.ndarray, phi: np.ndarray, c: BoundConstants,
    t_round: float, energy_price: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
    coupling: str = "sum",
) -> tuple[np.ndarray, float, float]:
    """Enumerate subsets; minimize J_s(a) + price * E_s(a). Returns (a, J, E)."""
    n = len(phi)
    if n > EXACT_LIMIT:
        return select_round_greedy(lam, phi, c, t_round, energy_price,
                                   h_up, h_down, sp, coupling)
    from repro_torch.wireless.comm import broadcast_energy
    feas_n, energy_n = _per_client_table(lam, t_round, h_up, h_down, sp)
    e_bc = broadcast_energy(h_down, sp)
    best_a, best_score, best_j, best_e = None, float("inf"), float("inf"), 0.0
    for bits in range(1, 2**n):
        idx = [(bits >> i) & 1 for i in range(n)]
        a = np.array(idx, dtype=np.float64)
        mask = a > 0
        if not feas_n[mask].all():
            continue
        energy = float(energy_n[mask].sum()) + e_bc
        j = round_objective(a, lam, phi, c, coupling)
        score = j + energy_price * energy
        if score < best_score:
            best_a, best_score, best_j, best_e = a, score, j, energy
    if best_a is None:  # nothing feasible: pick the single fastest client
        from repro_torch.core.resource import min_client_delay
        delays = [min_client_delay(i, float(lam[i]), h_up, h_down, sp)
                  for i in range(n)]
        a = np.zeros(n)
        a[int(np.argmin(delays))] = 1.0
        feas, energy = _subset_feasible(a, lam, t_round, h_up, h_down, sp)
        return a, round_objective(a, lam, phi, c), energy
    return best_a, best_j, best_e


def select_round_greedy(
    lam: np.ndarray, phi: np.ndarray, c: BoundConstants,
    t_round: float, energy_price: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
    coupling: str = "sum",
) -> tuple[np.ndarray, float, float]:
    """Greedy add-in-phi-order with local swaps — used when N > EXACT_LIMIT."""
    from repro_torch.wireless.comm import broadcast_energy
    n = len(phi)
    feas_n, energy_n = _per_client_table(lam, t_round, h_up, h_down, sp)
    e_bc = broadcast_energy(h_down, sp)
    order = [i for i in np.argsort(phi) if feas_n[i]]
    if not order:
        order = [int(np.argmin(energy_n))]
    a = np.zeros(n)
    best_score, best_a, best_e = float("inf"), None, 0.0
    for k in order:
        a[k] = 1.0
        energy = float(energy_n[a > 0].sum()) + e_bc
        score = round_objective(a, lam, phi, c, coupling) + energy_price * energy
        if score < best_score:
            best_score, best_a, best_e = score, a.copy(), energy
    if best_a is None:
        best_a = np.zeros(n)
        best_a[order[0]] = 1.0
        best_e = float(energy_n[order[0]]) + e_bc
    return best_a, round_objective(best_a, lam, phi, c, coupling), best_e


def solve_selection(
    lam: np.ndarray, phi: np.ndarray, c: BoundConstants,
    e0: float, t0: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
    *, method: str = "exact", coupling: str = "sum",
) -> tuple[np.ndarray, dict]:
    """Solve selection for the whole schedule. lam: [S+1, N]. Returns a, info.

    Budget coupling: per-round delay budget t0/(S+1); total energy met by
    bisecting a scalar energy price nu >= 0 in J_s + nu * E_s.
    """
    lam = np.atleast_2d(lam)
    n_rounds, n = lam.shape
    t_round = t0 / max(n_rounds, 1)
    solver = {"exact": select_round_exact, "paper": select_round_paper,
              "greedy": select_round_greedy}[method]

    def run(price: float):
        a_all, e_tot, j_tot = [], 0.0, 0.0
        memo: dict[bytes, tuple] = {}  # identical lam rows => identical round
        for s in range(n_rounds):
            key = lam[s].tobytes()
            if key not in memo:
                memo[key] = solver(lam[s], phi, c, t_round, price,
                                   h_up, h_down, sp, coupling)
            a, j, e = memo[key]
            a_all.append(a)
            e_tot += e
            j_tot += j
        return np.array(a_all), e_tot, j_tot

    a, e_tot, j_tot = run(0.0)
    price = 0.0
    if e_tot > e0:
        lo, hi = 0.0, 1.0
        _, e_hi, _ = run(hi)
        while e_hi > e0 and hi < 1e12:
            hi *= 10.0
            _, e_hi, _ = run(hi)
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            a_m, e_m, j_m = run(mid)
            if e_m > e0:
                lo = mid
            else:
                hi = mid
                a, e_tot, j_tot, price = a_m, e_m, j_m, mid
    return a, {"energy": e_tot, "objective": j_tot, "energy_price": price,
               "feasible": e_tot <= e0 * (1 + 1e-6)}


def select_round_paper(
    lam: np.ndarray, phi: np.ndarray, c: BoundConstants,
    t_round: float, energy_price: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
    coupling: str = "sum", *, iters: int = 20,
) -> tuple[np.ndarray, float, float]:
    """(P5) paper-faithful alternation between a (relaxed+rounded) and mu.

    With mu fixed, the objective sum_s (beta + mu)/sum a is minimized by
    selecting *more* clients; with a fixed, mu tightens to the quadratic term.
    We sweep thresholds on phi (the relaxed problem's optimal structure sorts
    clients by phi), keeping the best feasible rounding — this is the paper's
    iterative scheme made concrete.
    """
    from repro_torch.wireless.comm import broadcast_energy
    n = len(phi)
    feas_n, energy_n = _per_client_table(lam, t_round, h_up, h_down, sp)
    e_bc = broadcast_energy(h_down, sp)
    order = [i for i in np.argsort(phi) if feas_n[i]]
    if not order:
        order = [int(np.argmin(energy_n))]
    mu = 0.0
    best = (None, float("inf"), 0.0)
    for _ in range(iters):
        improved = False
        for k in range(1, len(order) + 1):
            a = np.zeros(n)
            a[order[:k]] = 1.0
            energy = float(energy_n[a > 0].sum()) + e_bc
            quad = c.gamma1 * float(np.dot(a, phi)) ** 2
            if coupling == "mean":
                quad /= a.sum() ** 2
            quad += c.gamma2 * float(np.dot(a, lam))
            score = (c.beta + max(quad, mu)) / a.sum() + energy_price * energy
            if score < best[1]:
                best = (a, score, energy)
                mu = quad
                improved = True
        if not improved:
            break
    if best[0] is None:
        a = np.zeros(n)
        a[order[0]] = 1.0
        best = (a, round_objective(a, lam, phi, c, coupling),
                float(energy_n[order[0]]) + e_bc)
    a = best[0]
    return a, round_objective(a, lam, phi, c, coupling), best[2]
