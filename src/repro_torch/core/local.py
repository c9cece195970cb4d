"""Local-update scheme configuration (FedAvg / FedProx / FedDyn): the port
of ``repro/core/local.py``, a copy (the module is pure Python).

A :class:`LocalScheme` describes what each client does *between* uploads:
how many local gradient steps it runs and which per-step regularizer it
applies. The round engine runs exactly `steps` local steps per client
(core/round_engine.py); the JAX package pads the step axis to the pow2
`steps_bucket` for its traces, with padded steps that are exact no-ops, so
both give the same bits. The scheme is part of the engine's CUDA-graph key.

``make_local_scheme("fedavg", steps=1)`` returns ``None``: plain
single-step FedAvg *is* FedSGD, and returning ``None`` routes every caller
through the single-gradient code paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_SCHEMES = ("fedavg", "fedprox", "feddyn")


@dataclasses.dataclass(frozen=True)
class LocalScheme:
    """Static description of the client-local update rule.

    name:  one of ``fedavg`` / ``fedprox`` / ``feddyn``.
    steps: number of local gradient steps per round (E >= 1).
    mu:    FedProx proximal coefficient (ignored otherwise).
    alpha: FedDyn regularization coefficient (ignored otherwise).
    """

    name: str
    steps: int
    mu: float = 0.0
    alpha: float = 0.0

    @property
    def steps_bucket(self) -> int:
        """Pow2 bucket the JAX package pads the step axis to."""
        return 1 << (self.steps - 1).bit_length()

    @property
    def stateful(self) -> bool:
        """Whether the scheme carries per-client [R,128] state (FedDyn)."""
        return self.name == "feddyn"

    @property
    def coeff(self) -> float:
        """The per-step (u - u0) coefficient: mu / alpha / 0."""
        if self.name == "fedprox":
            return float(self.mu)
        if self.name == "feddyn":
            return float(self.alpha)
        return 0.0

    @property
    def spec_key(self):
        """Hashable identity used in trainer-pool / reuse keys."""
        return (self.name, int(self.steps), float(self.mu), float(self.alpha))


def make_local_scheme(
    name: str = "fedavg", steps: int = 1, **kwargs
) -> Optional[LocalScheme]:
    """Resolve a local-scheme config; ``None`` means the trivial FedSGD path.

    Unknown kwargs are rejected so sweep-grid typos fail loudly.
    """
    if name not in _SCHEMES:
        raise ValueError(
            f"unknown local scheme {name!r}; expected one of {_SCHEMES}"
        )
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {steps}")
    mu = float(kwargs.pop("mu", 0.0))
    alpha = float(kwargs.pop("alpha", 0.0))
    if kwargs:
        raise ValueError(f"unknown local scheme kwargs: {sorted(kwargs)}")
    if name == "fedprox" and mu < 0.0:
        raise ValueError(f"fedprox mu must be >= 0, got {mu}")
    if name == "feddyn" and alpha < 0.0:
        raise ValueError(f"feddyn alpha must be >= 0, got {alpha}")
    if name == "fedavg" and steps == 1:
        return None
    return LocalScheme(name=name, steps=steps, mu=mu, alpha=alpha)


def local_spec_key(scheme: Optional[LocalScheme]):
    """Pool-key fragment for a possibly-``None`` scheme."""
    return ("fedsgd",) if scheme is None else scheme.spec_key
