"""(P3): pruning-ratio optimization — an LP (paper Sec. IV-B-2).

With {a, p, f} fixed, theta is linear *increasing* in every lambda_n (the
gamma2 term), while the energy/delay constraints are linear *decreasing* in
lambda (every cost carries a (1 - lambda) factor). (P3) is therefore the LP

    min   sum_s  (gamma2 / N_sel_s) * sum_n a_ns lambda_ns
    s.t.  sum_s sum_n a_ns (1-lambda_ns) c^E_ns + bc_s           <= E0
          a_ns ( (1-lambda_ns) c^T_ns + t^dl_n ) <= tau_s,  forall n, s
          sum_s tau_s                                            <= T0
          0 <= lambda_ns <= lambda_max

solved exactly with scipy.optimize.linprog (HiGHS). Variables: the lambdas of
the selected (n, s) pairs plus one epigraph variable tau_s per round.
"""
from __future__ import annotations

import numpy as np
from scipy import optimize as sopt

from repro_torch.core.convergence import BoundConstants
from repro_torch.wireless.comm import (
    SystemParams, uplink_rate, downlink_rate, broadcast_energy,
)

_EPS = 1e-30


def solve_pruning_ratios(
    a: np.ndarray, p: np.ndarray, f: np.ndarray,
    e0: float, t0: float,
    h_up: np.ndarray, h_down: np.ndarray,
    sp: SystemParams, c: BoundConstants,
) -> tuple[np.ndarray, dict]:
    """Solve (P3). a, p, f: [S+1, N]. Returns lambda [S+1, N] and info dict."""
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    p = np.atleast_2d(np.asarray(p, dtype=np.float64))
    f = np.atleast_2d(np.asarray(f, dtype=np.float64))
    n_rounds, n_cl = a.shape

    r_up = np.stack([uplink_rate(p[s], h_up, sp) for s in range(n_rounds)])
    r_dn = downlink_rate(h_down, sp)
    t_dl = sp.grad_bits / np.maximum(r_dn, _EPS)

    # Per-(s, n) cost coefficients multiplying (1 - lambda):
    ce = (sp.pue * sp.switched_cap * f**2 * sp.batch_size * sp.flops_per_sample
          / sp.flops_per_cycle) + p * sp.grad_bits / np.maximum(r_up, _EPS)
    ct = (sp.batch_size * sp.flops_per_sample / np.maximum(f * sp.flops_per_cycle, _EPS)
          + sp.grad_bits / np.maximum(r_up, _EPS))

    sel = [(s, n) for s in range(n_rounds) for n in range(n_cl) if a[s, n] > 0]
    n_lam = len(sel)
    if n_lam == 0:
        return np.zeros_like(a), {"status": "no-clients", "objective": 0.0}
    n_var = n_lam + n_rounds  # lambdas then taus

    cost = np.zeros(n_var)
    for j, (s, n) in enumerate(sel):
        n_sel = max(a[s].sum(), 1.0)
        cost[j] = c.gamma2 / n_sel

    a_ub, b_ub = [], []
    # Energy row: sum (1-lam) ce + broadcast <= E0  =>  -sum lam*ce <= E0 - sum ce - bc
    row = np.zeros(n_var)
    rhs = e0
    for j, (s, n) in enumerate(sel):
        row[j] = -ce[s, n]
        rhs -= ce[s, n]
    for s in range(n_rounds):
        if a[s].sum() > 0:
            rhs -= broadcast_energy(h_down, sp)
    a_ub.append(row)
    b_ub.append(rhs)
    # Delay epigraph rows: (1-lam) ct + t_dl <= tau_s
    for j, (s, n) in enumerate(sel):
        row = np.zeros(n_var)
        row[j] = -ct[s, n]
        row[n_lam + s] = -1.0
        a_ub.append(row)
        b_ub.append(-(ct[s, n] + t_dl[n]))
    # sum tau_s <= T0
    row = np.zeros(n_var)
    row[n_lam:] = 1.0
    a_ub.append(row)
    b_ub.append(t0)

    bounds = [(0.0, sp.lambda_max)] * n_lam + [(0.0, None)] * n_rounds
    res = sopt.linprog(cost, A_ub=np.array(a_ub), b_ub=np.array(b_ub),
                       bounds=bounds, method="highs")
    lam = np.zeros_like(a)
    if res.status == 0:
        for j, (s, n) in enumerate(sel):
            lam[s, n] = res.x[j]
        return lam, {"status": "optimal", "objective": float(res.fun)}
    # Infeasible under current (a, p, f): fall back to max pruning (cheapest
    # schedule); the AO outer loop will then adjust selection.
    for (s, n) in sel:
        lam[s, n] = sp.lambda_max
    return lam, {"status": "infeasible-fallback", "objective": float("inf")}
