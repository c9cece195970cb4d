"""Client fault models: per-(seed, round, client) failure draws.

A numpy copy of ``repro/core/faults.py`` (DESIGN.md §10); the port keeps its
own so that it never imports the JAX package. Callers construct the classes
directly (the JAX package's ``FAULT_MODELS`` registry belongs to the
Experiment API, not ported yet).

The paper's system model assumes every scheduled client uploads a finite
gradient within the round deadline — the exact assumption real FEEL
deployments violate. A `FaultModel` injects those failures:

  * dropout   — the client never uploads (weight 0 in the aggregate);
  * straggler — the upload exceeds a delay deadline derived from the
    wireless delay model (eqs. 10-11): client n faults when its drawn
    slowdown times its scheduled per-client delay exceeds ``tolerance *
    deadline``, where the deadline is the round's scheduled straggler
    latency (``max_n a_n (tau_n + tau^_n)``, eq. 12);
  * corrupt   — the upload arrives but is scaled or NaN-poisoned
    (deep-fade / decode-failure model).

Adversarial (byzantine) models reuse the same draw machinery but model a
deliberate attacker, pairing with the robust aggregators in
core/aggregators.py:

  * sign_flip        — byzantine clients upload ``-scale * g`` (rides the
    multiplicative `corrupt` operand);
  * scaled_malicious — byzantine clients upload ``+scale * g`` (same
    operand);
  * gaussian_poison  — byzantine clients upload ``g + sigma * z`` with
    z ~ N(0, I) over the packed buffer (additive; carried by the draw's
    lazy ``poison`` callable so clean rounds never materialize a
    model-sized array).

Draw protocol
-------------
``draw(round_index, n_clients, selected, ...)`` returns a `FaultDraw` for
the round's selected clients. Every model draws a POPULATION-sized array
from an rng keyed ONLY by ``(seed, round, kind)`` and then indexes it with
the selected ids — so a client's fate at round s is a pure function of
(seed, s, client id), invariant to how many clients are selected. Both
execution backends consume the identical draw, which is what keeps fault
runs bitwise packed-vs-reference, and the same numpy calls make the draws
equal to the JAX package's.

Graceful degradation — how draws are consumed — lives in the engine:
faulted clients get weight 0 in the weighted aggregate, the mean
renormalizes by the surviving count, non-finite (corrupt) uploads are
quarantined by the engine's always-on isfinite guard, and an all-fault
round skips the update entirely (core/round_engine.py, kernels/ops.py).
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np

# Distinct rng streams per fault kind so a mixed model's dropout draw never
# correlates with its corruption draw at the same (seed, round).
_DROPOUT, _STRAGGLER, _CORRUPT, _BYZANTINE = 1, 2, 3, 4


def _round_rng(seed: int, round_index: int, kind: int) -> np.random.Generator:
    """The (seed, round, kind)-keyed generator — same keying discipline as
    wireless/channel.GaussianAggregateNoise: no shared stream position, so
    draws are invariant to dispatch grouping and resume."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(round_index), int(kind)]))


@dataclasses.dataclass(frozen=True)
class FaultDraw:
    """One round's fault outcome for the selected clients (selected order).

    upload_ok : [C_sel] bool — False = the upload never arrives (dropout /
        straggler past the deadline); the client gets weight 0 and the
        aggregate renormalizes over the survivors.
    corrupt   : [C_sel] float32 or None — per-client gradient scale factor
        (1.0 = clean; NaN = poisoned). Applied to uploads that DO arrive;
        non-finite results are then caught by the engine's isfinite guard.
    poison    : callable or None — lazy additive upload poison:
        ``poison(shape, valid) -> float32 [C_sel, *shape]`` with zeros for
        clean clients, drawn per flagged client from an rng keyed
        ``(seed, round, _BYZANTINE, client_id)`` and masked by the packed
        buffer's `valid` lanes (so padding lanes stay exactly 0.0 and the
        engine's zero-padding invariants hold). Lazy because it is the one
        model-sized fault operand: a draw with no byzantine client returns
        ``poison=None`` and the round never materializes the array.
    """

    upload_ok: np.ndarray
    corrupt: np.ndarray | None = None
    poison: "typing.Callable | None" = None

    @property
    def n_faulted(self) -> int:
        return int((~np.asarray(self.upload_ok, bool)).sum())


class FaultModel:
    """Protocol: per-round fault draws over the client population.

    ``delays`` ([C_sel] float, seconds — each selected client's scheduled
    tau_n + tau^_n) and ``deadline`` (the round's scheduled straggler
    latency) come from the wireless bookkeeping the trainer already
    computes; models that don't need them ignore them.
    """

    def draw(self, round_index: int, n_clients: int, selected: np.ndarray,
             *, delays: np.ndarray | None = None,
             deadline: float | None = None) -> FaultDraw:
        raise NotImplementedError

    @staticmethod
    def _all_ok(n_sel: int) -> np.ndarray:
        return np.ones(n_sel, bool)


@dataclasses.dataclass(frozen=True)
class ClientDropout(FaultModel):
    """Each client independently drops its round with probability `rate`."""

    rate: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], got {self.rate}")

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        u = _round_rng(self.seed, round_index, _DROPOUT).random(n_clients)
        return FaultDraw(upload_ok=u[np.asarray(selected, int)] >= self.rate)


@dataclasses.dataclass(frozen=True)
class StragglerTimeout(FaultModel):
    """Lognormal per-client slowdown against a deadline from the wireless
    delay model: client n misses the round when ``slowdown_n * delay_n >
    tolerance * deadline`` — the deadline being the round's scheduled
    straggler latency (eq. 12's per-round max), so the paper's T constraint
    is exactly the budget stragglers are judged against. With no wireless
    context (delays/deadline not supplied) nobody straggles."""

    tolerance: float = 1.5              # deadline slack factor
    sigma: float = 0.5                  # lognormal(0, sigma) slowdown spread
    seed: int = 0

    def __post_init__(self):
        if self.tolerance <= 0.0:
            raise ValueError(f"tolerance must be > 0, got {self.tolerance}")

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        sel = np.asarray(selected, int)
        slow = _round_rng(self.seed, round_index,
                          _STRAGGLER).lognormal(0.0, self.sigma,
                                                n_clients)[sel]
        if delays is None or deadline is None or deadline <= 0.0:
            return FaultDraw(upload_ok=self._all_ok(len(sel)))
        eff = np.asarray(delays, np.float64) * slow
        return FaultDraw(upload_ok=eff <= self.tolerance * float(deadline))


@dataclasses.dataclass(frozen=True)
class CorruptUpload(FaultModel):
    """Each arriving upload is independently corrupted with probability
    `rate`: ``mode="nan"`` poisons the gradient (quarantined by the
    engine's isfinite guard), ``mode="scale"`` multiplies it by `scale`
    (a finite deep-fade distortion that DOES reach the aggregate)."""

    rate: float = 0.05
    mode: str = "nan"                   # "nan" | "scale"
    scale: float = 100.0
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("nan", "scale"):
            raise ValueError(f"unknown corrupt mode {self.mode!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"corrupt rate must be in [0, 1], got {self.rate}")

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        sel = np.asarray(selected, int)
        u = _round_rng(self.seed, round_index, _CORRUPT).random(n_clients)[sel]
        cf = np.ones(len(sel), np.float32)
        cf[u < self.rate] = (np.float32("nan") if self.mode == "nan"
                             else np.float32(self.scale))
        return FaultDraw(upload_ok=self._all_ok(len(sel)), corrupt=cf)


@dataclasses.dataclass(frozen=True)
class MixedFaults(FaultModel):
    """Composition of the three kinds with independent per-kind streams.
    A kind is active when its knob is set: ``dropout_rate`` /
    ``corrupt_rate`` > 0, ``straggler_tolerance`` not None."""

    dropout_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 100.0
    straggler_tolerance: float | None = None
    straggler_sigma: float = 0.5
    seed: int = 0

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        sel = np.asarray(selected, int)
        ok = self._all_ok(len(sel))
        corrupt = None
        if self.dropout_rate > 0.0:
            ok &= ClientDropout(self.dropout_rate, self.seed).draw(
                round_index, n_clients, sel).upload_ok
        if self.straggler_tolerance is not None:
            ok &= StragglerTimeout(self.straggler_tolerance,
                                   self.straggler_sigma, self.seed).draw(
                round_index, n_clients, sel, delays=delays,
                deadline=deadline).upload_ok
        if self.corrupt_rate > 0.0:
            corrupt = CorruptUpload(self.corrupt_rate, self.corrupt_mode,
                                    self.corrupt_scale, self.seed).draw(
                round_index, n_clients, sel).corrupt
        return FaultDraw(upload_ok=ok, corrupt=corrupt)


# -- adversarial (byzantine) models ------------------------------------------
#
# Same draw protocol as the channel faults — a population-sized flag array
# keyed (seed, round, _BYZANTINE), indexed by the selected ids — so the
# byzantine roster at round s is a pure function of (seed, s, client id),
# invariant to selection size, dispatch grouping, and resume. The engine
# never learns who is byzantine; the defense is the robust aggregator
# (core/aggregators.py), which must bound the damage from weights alone.


def _byzantine_flags(seed: int, round_index: int, n_clients: int,
                     selected: np.ndarray, rate: float,
                     exact: bool = False) -> np.ndarray:
    """Population-level byzantine roster for one round. ``exact=False``
    flags each client independently with probability ``rate`` (a Bernoulli
    draw whose count fluctuates — at rate 0.3 over 10 clients it exceeds
    n/2, every reducer's breakdown point, in ~15% of rounds). ``exact=True``
    flags the ``round(rate * n_clients)`` clients with the smallest uniform
    draws instead: the attacker COUNT is exact every round (the standard
    f-of-n Byzantine threat model a robust aggregator is specified
    against) while the membership still rotates per round. Both modes are
    pure functions of (seed, round, client id), so they stay selection-,
    dispatch-, and resume-invariant."""
    u = _round_rng(seed, round_index, _BYZANTINE).random(n_clients)
    if exact:
        k = int(round(rate * n_clients))
        if k <= 0:
            flags = np.zeros(n_clients, bool)
        elif k >= n_clients:
            flags = np.ones(n_clients, bool)
        else:
            flags = u <= np.partition(u, k - 1)[k - 1]
    else:
        flags = u < rate
    return flags[np.asarray(selected, int)]


@dataclasses.dataclass(frozen=True)
class SignFlip(FaultModel):
    """Byzantine clients upload ``-scale * g`` — gradient ascent on the
    global objective. Rides the multiplicative `corrupt` operand (a
    ``1.0 * g`` multiply is exact, so clean clients are bitwise
    unaffected); scale=1.0 is the classic sign-flipping attack.
    ``exact=True`` pins the attacker count to round(rate * n) per round
    (see `_byzantine_flags`)."""

    rate: float = 0.1
    scale: float = 1.0
    seed: int = 0
    exact: bool = False

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"byzantine rate must be in [0, 1], "
                             f"got {self.rate}")

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        flags = _byzantine_flags(self.seed, round_index, n_clients,
                                 selected, self.rate, self.exact)
        cf = np.ones(len(flags), np.float32)
        cf[flags] = np.float32(-self.scale)
        return FaultDraw(upload_ok=self._all_ok(len(flags)), corrupt=cf)


@dataclasses.dataclass(frozen=True)
class ScaledMalicious(FaultModel):
    """Byzantine clients upload ``+scale * g`` — a magnitude attack that
    keeps the honest direction but dominates the mean (the canonical
    finite corruption the isfinite quarantine cannot catch). The robust
    reducers' breakdown-point property test runs against this model.
    ``exact=True`` pins the attacker count to round(rate * n) per round
    (see `_byzantine_flags`)."""

    rate: float = 0.1
    scale: float = 10.0
    seed: int = 0
    exact: bool = False

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"byzantine rate must be in [0, 1], "
                             f"got {self.rate}")

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        flags = _byzantine_flags(self.seed, round_index, n_clients,
                                 selected, self.rate, self.exact)
        cf = np.ones(len(flags), np.float32)
        cf[flags] = np.float32(self.scale)
        return FaultDraw(upload_ok=self._all_ok(len(flags)), corrupt=cf)


@dataclasses.dataclass(frozen=True)
class GaussianPoison(FaultModel):
    """Byzantine clients upload ``g + sigma * z``, z ~ N(0, I) over the
    packed buffer — additive noise poisoning. The per-client noise is
    drawn from an rng keyed ``(seed, round, _BYZANTINE, client_id)`` —
    client-id keyed so the draw stays selection- and dispatch-invariant —
    and returned through the draw's lazy ``poison`` callable (the engine
    materializes the [C_sel, R, L] stack only on rounds with a flagged
    client). Clean rows are exact zeros and padding lanes are masked out,
    so unflagged clients and the packed-buffer invariants are untouched."""

    rate: float = 0.1
    sigma: float = 1.0
    seed: int = 0
    exact: bool = False

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"byzantine rate must be in [0, 1], "
                             f"got {self.rate}")
        if self.sigma < 0.0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")

    def draw(self, round_index, n_clients, selected, *, delays=None,
             deadline=None) -> FaultDraw:
        sel = np.asarray(selected, int)
        flags = _byzantine_flags(self.seed, round_index, n_clients,
                                 sel, self.rate, self.exact)
        ok = self._all_ok(len(sel))
        if not flags.any():
            return FaultDraw(upload_ok=ok)
        seed, sigma, rnd = self.seed, float(self.sigma), int(round_index)

        def poison(shape, valid):
            out = np.zeros((len(sel),) + tuple(shape), np.float32)
            mask = np.asarray(valid, np.float32)
            for j in np.flatnonzero(flags):
                rng = np.random.default_rng(np.random.SeedSequence(
                    [int(seed) & 0xFFFFFFFF, rnd, _BYZANTINE, int(sel[j])]))
                out[j] = (sigma * rng.standard_normal(shape)
                          ).astype(np.float32) * mask
            return out

        # the trainer's corrupt-but-finite counter reads the roster off
        # the callable (the draw itself stays lazy)
        poison.flags = flags
        return FaultDraw(upload_ok=ok, poison=poison)
