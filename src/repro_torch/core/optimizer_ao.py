"""Algorithm 1: alternating optimization for (P1).

Iterates, for o = 1..O:
  1. (P2.1) resources {p, f}   given {a, lambda}    — SCA / analytic min-energy
  2. (P3)   pruning {lambda}   given {a, p, f}      — exact LP (HiGHS)
  3. (P5)   selection {a}      given {lambda, p, f} — exact enumeration or the
                                                      paper's iterative scheme
keeping the incumbent with the smallest theta among feasible iterates
(the paper: "Obtain the final solution leading to non-increasing objective").
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.convergence import BoundConstants, theta, theta_decomposition
from repro_torch.core.ratio import solve_pruning_ratios
from repro_torch.core.resource import solve_schedule_resources
from repro_torch.core.selection import solve_selection
from repro_torch.wireless.comm import SystemParams, total_delay, total_energy


@dataclasses.dataclass
class Schedule:
    """The optimizer's output: the full per-round system schedule."""

    a: np.ndarray       # [S+1, N] selection
    lam: np.ndarray     # [S+1, N] pruning ratios
    power: np.ndarray   # [S+1, N] W
    freq: np.ndarray    # [S+1, N] Hz
    theta: float
    energy: float
    delay: float
    feasible: bool
    history: list = dataclasses.field(default_factory=list)

    def decomposition(self, phi: np.ndarray, c: BoundConstants) -> dict:
        return theta_decomposition(self.a, self.lam, phi, c)


@dataclasses.dataclass(frozen=True)
class AOConfig:
    outer_iters: int = 6
    selection_method: str = "exact"   # "exact" | "paper" | "greedy"
    tol: float = 1e-6
    # Benchmark-scheme ablations (paper Sec. V baselines):
    fix_lambda: float | None = None   # "fixed pruning": lambda forced
    fix_selection: bool = False       # "fixed selection": a_n = 1 forall n
    use_phi: bool = True              # "without generalization statement"
    fix_power: float | None = None    # "fixed power design": p_n forced [W]
    fix_freq: bool = False            # "fixed clock": f_n = f_max
    phi_coupling: str = "sum"         # "sum" (Thm-1 literal) | "mean"


def solve_random(
    phi: np.ndarray,
    e0: float,
    t0: float,
    h_up: np.ndarray,
    h_down: np.ndarray,
    sp: SystemParams,
    c: BoundConstants,
    *,
    k: int,
    lam: float = 0.0,
    seed: int = 0,
) -> Schedule:
    """Fleet-scale baseline: k clients uniformly at random per round, fixed
    pruning ratio, max power/clock. Every step is a vectorized [S+1, N]
    draw/broadcast, so it stays O(N) where Algorithm 1's subproblems run
    per-client scalar solves — the scheme that makes 1e5+ populations
    schedulable (registry name "random_k")."""
    n = len(phi)
    n_rounds = c.rounds_S + 1
    k = max(1, min(int(k), n))
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    a = np.zeros((n_rounds, n))
    for s in range(n_rounds):
        a[s, rng.choice(n, size=k, replace=False)] = 1.0
    lam_arr = np.full((n_rounds, n), float(lam))
    p = np.broadcast_to(np.asarray(sp.p_max, float), (n_rounds, n)).copy()
    f = np.broadcast_to(np.asarray(sp.f_max, float), (n_rounds, n)).copy()
    th = theta(a, lam_arr, phi, c)
    e_tot = total_energy(a, lam_arr, p, f, h_up, h_down, sp)
    t_tot = total_delay(a, lam_arr, p, f, h_up, h_down, sp)
    feas = e_tot <= e0 * (1 + 1e-4) and t_tot <= t0 * (1 + 1e-4)
    return Schedule(a, lam_arr, p, f, th, e_tot, t_tot, feas,
                    history=[{"iter": 0, "theta": th, "energy": e_tot,
                              "delay": t_tot, "feasible": feas}])


def solve_p1(
    phi: np.ndarray,
    e0: float,
    t0: float,
    h_up: np.ndarray,
    h_down: np.ndarray,
    sp: SystemParams,
    c: BoundConstants,
    cfg: AOConfig = AOConfig(),
    *,
    a_init: np.ndarray | None = None,
    lam_init: np.ndarray | None = None,
) -> Schedule:
    """Run Algorithm 1 and return the best feasible schedule found."""
    n = len(phi)
    n_rounds = c.rounds_S + 1
    phi_opt = phi if cfg.use_phi else np.zeros_like(phi)
    a = np.ones((n_rounds, n)) if a_init is None else np.atleast_2d(a_init).astype(float)
    if cfg.fix_lambda is not None:
        lam = cfg.fix_lambda * np.ones((n_rounds, n))
    else:
        # start unpruned: theta is increasing in lambda, so lambda should
        # only rise if the budgets force it (initializing at lambda_max
        # lets (P2) stretch the schedule and then traps (P3) at the max)
        lam = (np.zeros((n_rounds, n)) if lam_init is None
               else np.atleast_2d(lam_init).astype(float))

    def overrides(p, f):
        if cfg.fix_power is not None:
            p = np.full_like(p, cfg.fix_power)
        if cfg.fix_freq:
            f = np.broadcast_to(sp.f_max, f.shape).copy()
        return p, f

    best: Schedule | None = None
    history = []
    for o in range(cfg.outer_iters):
        # --- (P2): resources given (a, lam)
        p, f, rinfo = solve_schedule_resources(a, lam, e0, t0, h_up, h_down, sp)
        p, f = overrides(p, f)
        # --- (P3): pruning ratios given (a, p, f)
        if cfg.fix_lambda is None:
            lam, linfo = solve_pruning_ratios(a, p, f, e0, t0, h_up, h_down,
                                              sp, c)
            p, f, rinfo = solve_schedule_resources(a, lam, e0, t0, h_up,
                                                   h_down, sp)
            p, f = overrides(p, f)
        # --- (P5): selection given (lam, p, f)
        if not cfg.fix_selection:
            a, sinfo = solve_selection(lam, phi_opt, c, e0, t0, h_up, h_down,
                                       sp, method=cfg.selection_method,
                                       coupling=cfg.phi_coupling)
            # selection changed the active set: lambdas/resources for newly
            # selected clients must exist -> one more (P3)+(P2) pass
            if cfg.fix_lambda is None:
                lam, _ = solve_pruning_ratios(a, p, f, e0, t0, h_up, h_down,
                                              sp, c)
            p, f, rinfo = solve_schedule_resources(a, lam, e0, t0, h_up,
                                                   h_down, sp)
            p, f = overrides(p, f)

        th = theta(a, lam, phi, c)
        e_tot = total_energy(a, lam, p, f, h_up, h_down, sp)
        t_tot = total_delay(a, lam, p, f, h_up, h_down, sp)
        feas = e_tot <= e0 * (1 + 1e-4) and t_tot <= t0 * (1 + 1e-4)
        history.append({"iter": o, "theta": th, "energy": e_tot,
                        "delay": t_tot, "feasible": feas})
        cand = Schedule(a.copy(), lam.copy(), p.copy(), f.copy(),
                        th, e_tot, t_tot, feas)
        if feas and (best is None or th < best.theta - cfg.tol * abs(best.theta)):
            best = cand
        elif best is not None and feas and th >= best.theta - cfg.tol * abs(best.theta):
            break  # non-increasing objective converged
        if best is None:
            best = cand  # keep something even if infeasible (reported as such)
    best.history = history
    return best
