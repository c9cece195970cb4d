"""Delay and energy models — paper eqs. (8)-(15), vectorized over clients.

Conventions: all arrays are shape [N] (per client). Rates in bits/s, delay in
seconds, energy in joules. A selection vector `a` in {0,1}^N gates every
per-client quantity, matching eqs. (12) and (15).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Static system parameters (Table I of the paper).

    Per-client arrays have shape [N]; scalars are shared.
    """

    bandwidth: np.ndarray          # c_n  [Hz]
    noise_psd: float               # U_0  [W/Hz]
    grad_bits: np.ndarray          # H_n  [bits] unpruned gradient payload
    flops_per_sample: np.ndarray   # e_n  [FLOPs]
    flops_per_cycle: np.ndarray    # q_n
    pue: np.ndarray                # kappa_n
    switched_cap: np.ndarray       # varpi_n  [effective capacitance]
    batch_size: np.ndarray         # Z_n
    server_power: float            # p_hat [W]
    server_bandwidth: float        # c_hat [Hz]
    p_max: np.ndarray              # [W]
    f_max: np.ndarray              # [Hz]
    lambda_max: float              # max pruning ratio

    @staticmethod
    def table1(
        n: int,
        *,
        dataset: str = "mnist",
        batch_size: int = 32,
    ) -> "SystemParams":
        """Exact Table-I parameterization for the paper's two setups."""
        ones = np.ones(n)
        # Power coefficients {varpi_n} from Table I (cycled if n > 10).
        base = np.array([0.88, 0.84, 1.41, 1.33, 0.94, 1.37, 1.8, 1.91, 0.92,
                         0.93, 1.13, 1.01, 0.26, 0.96])
        varpi = np.resize(base, n)
        if dataset == "mnist":
            return SystemParams(
                bandwidth=100e3 * ones,
                noise_psd=3.98e-21,
                grad_bits=1.42e6 * ones,
                flops_per_sample=1.8e6 * ones,
                flops_per_cycle=4 * ones,
                pue=ones,
                switched_cap=varpi * 1e-27,
                batch_size=batch_size * np.ones(n, dtype=int),
                server_power=0.5,
                server_bandwidth=100e3 * n,
                p_max=0.5 * ones,
                f_max=500e6 * ones,
                lambda_max=0.5,
            )
        if dataset == "cifar10":
            return SystemParams(
                bandwidth=2e6 * ones,
                noise_psd=3.98e-21,
                grad_bits=21.07e6 * ones,
                flops_per_sample=0.59e9 * ones,
                flops_per_cycle=8 * ones,
                pue=ones,
                switched_cap=varpi * 1e-28,
                batch_size=batch_size * np.ones(n, dtype=int),
                server_power=0.5,
                server_bandwidth=2e6 * n,
                p_max=0.5 * ones,
                f_max=2000e6 * ones,
                lambda_max=0.7,
            )
        raise ValueError(f"unknown dataset {dataset!r}")


# --------------------------------------------------------------------------
# Rates — eqs. (8), (9)
# --------------------------------------------------------------------------

def uplink_rate(p: np.ndarray, h: np.ndarray, sp: SystemParams) -> np.ndarray:
    """r_n(p_n) = c_n log2(1 + p_n h_n / (c_n U_0))  [bits/s], eq. (8)."""
    p = np.asarray(p, dtype=np.float64)
    snr = p * h / (sp.bandwidth * sp.noise_psd)
    return sp.bandwidth * np.log2(1.0 + snr)


def downlink_rate(h_down: np.ndarray, sp: SystemParams) -> np.ndarray:
    """r^_n = c^ log2(1 + p^ h^_n / (c^ U_0))  [bits/s], eq. (9) (multicast)."""
    snr = sp.server_power * h_down / (sp.server_bandwidth * sp.noise_psd)
    return sp.server_bandwidth * np.log2(1.0 + snr)


# --------------------------------------------------------------------------
# Delay — eqs. (10)-(12)
# --------------------------------------------------------------------------

def computation_delay(lam: np.ndarray, f: np.ndarray, sp: SystemParams) -> np.ndarray:
    """tau_n = (1-lam) Z e_n / (f q_n), eq. (10)."""
    f = np.maximum(np.asarray(f, dtype=np.float64), _EPS)
    return (1.0 - lam) * sp.batch_size * sp.flops_per_sample / (f * sp.flops_per_cycle)


def communication_delay(
    lam: np.ndarray, p: np.ndarray, h_up: np.ndarray, h_down: np.ndarray,
    sp: SystemParams,
) -> np.ndarray:
    """tau^_n = (1-lam) H_n / r_n(p) + H_n / r^_n, eq. (11)."""
    r_up = np.maximum(uplink_rate(p, h_up, sp), _EPS)
    r_down = np.maximum(downlink_rate(h_down, sp), _EPS)
    return (1.0 - lam) * sp.grad_bits / r_up + sp.grad_bits / r_down


def per_client_delay(
    lam: np.ndarray, p: np.ndarray, f: np.ndarray,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> np.ndarray:
    """tau_n + tau^_n per client [N] — the quantity eq. (12) maxes over.

    Exposed so the straggler fault model (core/faults.py) judges each
    selected client's scheduled delay against the same round deadline
    `round_delay` reports — exclusion couples to the paper's T constraint.
    """
    return (computation_delay(lam, f, sp)
            + communication_delay(lam, p, h_up, h_down, sp))


def round_delay(
    a: np.ndarray, lam: np.ndarray, p: np.ndarray, f: np.ndarray,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> float:
    """max_n a_n (tau_n + tau^_n): the per-round straggler latency."""
    gated = np.asarray(a, dtype=np.float64) * per_client_delay(
        lam, p, f, h_up, h_down, sp)
    return float(gated.max()) if gated.size else 0.0


def total_delay(
    a: np.ndarray, lam: np.ndarray, p: np.ndarray, f: np.ndarray,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> float:
    """T = sum_s max_n ..., eq. (12). Inputs are [S+1, N] arrays."""
    a, lam = np.atleast_2d(a), np.atleast_2d(lam)
    p, f = np.atleast_2d(p), np.atleast_2d(f)
    return float(sum(
        round_delay(a[s], lam[s], p[s], f[s], h_up, h_down, sp)
        for s in range(a.shape[0])))


# --------------------------------------------------------------------------
# Energy — eqs. (13)-(15)
# --------------------------------------------------------------------------

def computation_energy(lam: np.ndarray, f: np.ndarray, sp: SystemParams) -> np.ndarray:
    """E~_n = (1-lam) kappa varpi f^2 Z e_n / q_n, eq. (13)."""
    f = np.asarray(f, dtype=np.float64)
    return ((1.0 - lam) * sp.pue * sp.switched_cap * f**2
            * sp.batch_size * sp.flops_per_sample / sp.flops_per_cycle)


def upload_energy(
    lam: np.ndarray, p: np.ndarray, h_up: np.ndarray, sp: SystemParams
) -> np.ndarray:
    """E^_n = (1-lam) p H_n / r_n(p), eq. (14)."""
    r_up = np.maximum(uplink_rate(p, h_up, sp), _EPS)
    return (1.0 - lam) * np.asarray(p, dtype=np.float64) * sp.grad_bits / r_up


def broadcast_energy(h_down: np.ndarray, sp: SystemParams) -> float:
    """p^ * max_n H_n / r^_n: server multicast energy per round (eq. 15)."""
    r_down = np.maximum(downlink_rate(h_down, sp), _EPS)
    return float(sp.server_power * np.max(sp.grad_bits / r_down))


def round_energy(
    a: np.ndarray, lam: np.ndarray, p: np.ndarray, f: np.ndarray,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> float:
    """One summand of eq. (15)."""
    a = np.asarray(a, dtype=np.float64)
    e = computation_energy(lam, f, sp) + upload_energy(lam, p, h_up, sp)
    return float((a * e).sum() + broadcast_energy(h_down, sp))


def total_energy(
    a: np.ndarray, lam: np.ndarray, p: np.ndarray, f: np.ndarray,
    h_up: np.ndarray, h_down: np.ndarray, sp: SystemParams,
) -> float:
    """E = eq. (15) over all rounds. Inputs are [S+1, N]."""
    a, lam = np.atleast_2d(a), np.atleast_2d(lam)
    p, f = np.atleast_2d(p), np.atleast_2d(f)
    return float(sum(
        round_energy(a[s], lam[s], p[s], f[s], h_up, h_down, sp)
        for s in range(a.shape[0])))
