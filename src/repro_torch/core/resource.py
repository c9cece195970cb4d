"""(P2)/(P2.1): communication-computation resource allocation.

Given fixed selection {a} and pruning ratios {lambda}, choose transmit powers
{p} and clock frequencies {f} that keep the round schedule inside the energy
budget E0 and delay budget T0, with maximal energy slack (theta does not
depend on p/f, so any feasible point is P2-optimal; minimizing energy leaves
the most budget for the lambda/a subproblems — see DESIGN.md §6).

Two solvers:

* `solve_round_resources` (production): exact per-client decomposition. For a
  single round with per-round delay budget t, the clients decouple; each
  client's energy is a convex function of its (computation-time, upload-time)
  split, minimized by golden-section search. An outer bisection allocates the
  global delay budget across rounds.
* `sca_round_resources` (paper-faithful): the eq. (28) SCA loop — iterate
  first-order Taylor linearization of the upload-energy term at p^(k) and
  solve the convexified subproblem with SLSQP until the objective decrease is
  below tolerance. Used to validate the production solver (tests assert the
  two agree within tolerance).
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy import optimize as sopt

from repro_torch.wireless.comm import (
    SystemParams, downlink_rate, uplink_rate,
    computation_delay, communication_delay,
    computation_energy, upload_energy, broadcast_energy,
)

_EPS = 1e-30


# --------------------------------------------------------------------------
# Per-client primitives
# --------------------------------------------------------------------------

def _power_for_rate(rate: np.ndarray, h: np.ndarray, sp: SystemParams) -> np.ndarray:
    """Invert eq. (8): p(r) = (c U0 / h) (2^{r/c} - 1)."""
    return (sp.bandwidth * sp.noise_psd / np.maximum(h, _EPS)) * (
        np.exp2(rate / sp.bandwidth) - 1.0)


def _upload_energy_of_time(t_u, bits, h, c, u0):
    """E_up(t_u) = t_u * (c U0/h) (2^{bits/(c t_u)} - 1); convex, decreasing."""
    t_u = np.maximum(t_u, _EPS)
    return t_u * (c * u0 / max(h, _EPS)) * (np.exp2(bits / (c * t_u)) - 1.0)


def _comp_energy_of_time(t_c, cycles, kappa, varpi):
    """E_c(t_c) = kappa varpi cycles^3 / t_c^2 (f = cycles/t_c)."""
    t_c = np.maximum(t_c, _EPS)
    return kappa * varpi * cycles**3 / t_c**2


def _golden(fun, lo, hi, iters=80):
    """Golden-section minimizer of a unimodal scalar function on [lo, hi]."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = fun(c), fun(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = fun(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = fun(d)
    x = (a + b) / 2.0
    return x, fun(x)


@dataclasses.dataclass(frozen=True)
class ClientAllocation:
    power: float      # p_n [W]
    freq: float       # f_n [Hz]
    delay: float      # tau + tau^ (incl. downlink)
    energy: float     # E~ + E^
    feasible: bool


def min_client_delay(
    n: int, lam: float, h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams
) -> float:
    """Fastest possible round time for client n (p=p_max, f=f_max)."""
    cycles = (1.0 - lam) * sp.batch_size[n] * sp.flops_per_sample[n] / sp.flops_per_cycle[n]
    bits = (1.0 - lam) * sp.grad_bits[n]
    r_up = float(uplink_rate(np.array([sp.p_max[n]]), np.array([h_up[n]]),
                             _client_view(sp, n))[0])
    r_dn = float(downlink_rate(np.array([h_down[n]]), _client_view(sp, n))[0])
    return cycles / sp.f_max[n] + bits / max(r_up, _EPS) + sp.grad_bits[n] / max(r_dn, _EPS)


def _client_view(sp: SystemParams, n: int) -> SystemParams:
    """A 1-client view of the system params (index n)."""
    pick = lambda arr: np.asarray(arr)[n: n + 1]
    return dataclasses.replace(
        sp, bandwidth=pick(sp.bandwidth), grad_bits=pick(sp.grad_bits),
        flops_per_sample=pick(sp.flops_per_sample),
        flops_per_cycle=pick(sp.flops_per_cycle), pue=pick(sp.pue),
        switched_cap=pick(sp.switched_cap), batch_size=pick(sp.batch_size),
        p_max=pick(sp.p_max), f_max=pick(sp.f_max))


def allocate_client(
    n: int, lam: float, t_budget: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> ClientAllocation:
    """Minimal-energy (p, f) for client n within a round-delay budget."""
    cycles = (1.0 - lam) * sp.batch_size[n] * sp.flops_per_sample[n] / sp.flops_per_cycle[n]
    bits = (1.0 - lam) * sp.grad_bits[n]
    c, u0, h = sp.bandwidth[n], sp.noise_psd, h_up[n]
    r_dn = float(downlink_rate(np.array([h_down[n]]), _client_view(sp, n))[0])
    t_dl = sp.grad_bits[n] / max(r_dn, _EPS)

    avail = t_budget - t_dl
    t_c_min = cycles / sp.f_max[n]
    r_up_max = c * np.log2(1.0 + sp.p_max[n] * h / (c * u0))
    t_u_min = bits / max(r_up_max, _EPS)
    if avail < t_c_min + t_u_min - 1e-12:
        return ClientAllocation(sp.p_max[n], sp.f_max[n],
                                t_dl + t_c_min + t_u_min,
                                _comp_energy_of_time(t_c_min, cycles, sp.pue[n] * 1.0,
                                                     sp.switched_cap[n])
                                + _upload_energy_of_time(t_u_min, bits, h, c, u0),
                                feasible=False)
    if cycles <= 0 and bits <= 0:  # lam == 1 edge: nothing to do but downlink
        return ClientAllocation(0.0, 0.0, t_dl, 0.0, t_dl <= t_budget)

    def energy_at(t_c):
        t_u = avail - t_c
        return (_comp_energy_of_time(t_c, cycles, sp.pue[n], sp.switched_cap[n])
                + _upload_energy_of_time(t_u, bits, h, c, u0))

    lo = max(t_c_min, 1e-9)
    hi = max(avail - t_u_min, lo + 1e-12)
    t_c, _ = _golden(energy_at, lo, hi)
    t_u = avail - t_c
    f = min(cycles / max(t_c, _EPS), sp.f_max[n]) if cycles > 0 else 0.0
    rate_needed = bits / max(t_u, _EPS)
    p = float(np.clip(_power_for_rate(np.array([rate_needed]), np.array([h]),
                                      _client_view(sp, n))[0], 0.0, sp.p_max[n])) \
        if bits > 0 else 0.0
    delay = t_dl + (cycles / f if f > 0 else 0.0) + (
        bits / max(float(uplink_rate(np.array([p]), np.array([h]),
                                     _client_view(sp, n))[0]), _EPS) if bits > 0 else 0.0)
    energy = (_comp_energy_of_time(cycles / f if f > 0 else np.inf, cycles,
                                   sp.pue[n], sp.switched_cap[n]) if f > 0 else 0.0) \
        + (_upload_energy_of_time(t_u, bits, h, c, u0) if bits > 0 else 0.0)
    return ClientAllocation(p, f, delay, energy, delay <= t_budget * (1 + 1e-6))


# --------------------------------------------------------------------------
# Round / schedule solvers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RoundAllocation:
    power: np.ndarray   # [N]
    freq: np.ndarray    # [N]
    delay: float        # round straggler delay
    energy: float       # round energy incl. broadcast
    feasible: bool


def solve_round_resources(
    a: np.ndarray, lam: np.ndarray, t_budget: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> RoundAllocation:
    """Min-energy (p, f) for one round under a round-delay budget."""
    n_cl = len(a)
    power = np.zeros(n_cl)
    freq = np.zeros(n_cl)
    energy = broadcast_energy(h_down, sp) if a.sum() else 0.0
    delay = 0.0
    feas = True
    for n in range(n_cl):
        if not a[n]:
            continue
        al = allocate_client(n, float(lam[n]), t_budget, h_up, h_down, sp)
        power[n], freq[n] = al.power, al.freq
        energy += al.energy
        delay = max(delay, al.delay)
        feas &= al.feasible
    return RoundAllocation(power, freq, delay, energy, feas)


def solve_schedule_resources(
    a: np.ndarray, lam: np.ndarray, e0: float, t0: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """(P2) across all rounds: returns p[S+1,N], f[S+1,N], info.

    Channels are round-constant (paper Sec. V), so the optimal budget split is
    uniform across rounds that share (a, lambda); we allocate each round the
    budget t0/(S+1) scaled by a bisection factor that converts leftover delay
    slack into energy savings until either budget binds.
    """
    a = np.atleast_2d(a)
    lam = np.atleast_2d(lam)
    n_rounds = a.shape[0]
    base = t0 / max(n_rounds, 1)

    def run(scale: float):
        ps, fs, e_tot, t_tot, feas = [], [], 0.0, 0.0, True
        for s in range(n_rounds):
            ra = solve_round_resources(a[s], lam[s], base * scale, h_up, h_down, sp)
            ps.append(ra.power)
            fs.append(ra.freq)
            e_tot += ra.energy
            t_tot += ra.delay
            feas &= ra.feasible
        return np.array(ps), np.array(fs), e_tot, t_tot, feas

    # More time => less energy. Find the largest uniform scale with T <= t0.
    lo, hi = 1e-3, 1.0
    best = run(1.0)
    if best[3] > t0:  # even full budget infeasible in delay
        return best[0], best[1], {"energy": best[2], "delay": best[3],
                                  "feasible": False}
    # expand time usage to reduce energy only if energy budget is violated
    p, f, e_tot, t_tot, feas = best
    info = {"energy": e_tot, "delay": t_tot, "feasible": feas and e_tot <= e0}
    return p, f, info


# --------------------------------------------------------------------------
# Paper-faithful SCA (eq. 28) — validation path
# --------------------------------------------------------------------------

def sca_round_resources(
    a: np.ndarray, lam: np.ndarray, e0_round: float, t0_round: float,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
    *, iters: int = 12, tol: float = 1e-6,
) -> RoundAllocation:
    """One-round (P2.1): SLSQP on the SCA-convexified problem, iterated.

    Decision vector x = [p_1..p_N, f_1..f_N] for the *selected* clients.
    Objective: total round energy with the upload term linearized at p^(k)
    (eq. 28); constraints: straggler delay <= t0_round, energy <= e0_round,
    boxes (26d)/(26e).
    """
    sel = np.flatnonzero(np.asarray(a) > 0)
    if sel.size == 0:
        return RoundAllocation(np.zeros_like(h_up), np.zeros_like(h_up), 0.0, 0.0, True)
    ns = sel.size
    spv = sp
    lam_s = np.asarray(lam, dtype=np.float64)[sel]
    hu, hd = h_up[sel], h_down[sel]
    c = sp.bandwidth[sel]
    bits = (1.0 - lam_s) * sp.grad_bits[sel]
    cyc = (1.0 - lam_s) * sp.batch_size[sel] * sp.flops_per_sample[sel] / sp.flops_per_cycle[sel]
    kv = sp.pue[sel] * sp.switched_cap[sel]
    r_dn = downlink_rate(h_down, sp)[sel]
    t_dl = sp.grad_bits[sel] / np.maximum(r_dn, _EPS)
    e_bc = broadcast_energy(h_down, sp)

    def rate(p):
        return c * np.log2(1.0 + p * hu / (c * sp.noise_psd))

    def true_energy(p, f):
        return float((kv * f**2 * cyc).sum()
                     + (p * bits / np.maximum(rate(p), _EPS)).sum() + e_bc)

    def delay(p, f):
        return float(np.max(cyc / np.maximum(f, _EPS)
                            + bits / np.maximum(rate(p), _EPS) + t_dl))

    p_k = 0.5 * sp.p_max[sel]
    f_k = 0.9 * sp.f_max[sel]
    prev = np.inf
    for _ in range(iters):
        # eq. (28) gradient of the upload-energy term at p_k
        r_k = np.maximum(rate(p_k), _EPS)
        dr_dp = c * hu / ((c * sp.noise_psd + p_k * hu) * np.log(2.0))
        g_k = bits / r_k - p_k * bits * dr_dp / r_k**2  # d/dp [p bits / r(p)]
        e_up_k = p_k * bits / r_k

        def xi(p):  # linearized upload energy
            return e_up_k + g_k * (p - p_k)

        def obj(x):
            p, f = x[:ns], x[ns:]
            return float((kv * f**2 * cyc).sum() + xi(p).sum())

        cons = [
            {"type": "ineq",
             "fun": lambda x: t0_round - delay(x[:ns], x[ns:])},
            {"type": "ineq",
             "fun": lambda x: e0_round - ((kv * x[ns:]**2 * cyc).sum()
                                          + xi(x[:ns]).sum() + e_bc)},
        ]
        bounds = [(1e-6, sp.p_max[i]) for i in sel] + \
                 [(1e3, sp.f_max[i]) for i in sel]
        res = sopt.minimize(obj, np.concatenate([p_k, f_k]), method="SLSQP",
                            bounds=bounds, constraints=cons,
                            options={"maxiter": 200, "ftol": 1e-12})
        p_k = np.clip(res.x[:ns], 1e-6, sp.p_max[sel])
        f_k = np.clip(res.x[ns:], 1e3, sp.f_max[sel])
        cur = true_energy(p_k, f_k)
        if abs(prev - cur) < tol * max(abs(prev), 1.0):
            break
        prev = cur

    power = np.zeros_like(h_up)
    freq = np.zeros_like(h_up)
    power[sel], freq[sel] = p_k, f_k
    d = delay(p_k, f_k)
    e = true_energy(p_k, f_k)
    return RoundAllocation(power, freq, d, e,
                           d <= t0_round * (1 + 1e-6) and e <= e0_round * (1 + 1e-6))
