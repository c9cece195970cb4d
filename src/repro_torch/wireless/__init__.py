"""Wireless edge substrate: channels, rates, delay and energy models (Sec. II-B/C)."""
from repro_torch.wireless.channel import (ChannelModel, GaussianAggregateNoise,
                                          rayleigh_gains)
from repro_torch.wireless.comm import (
    SystemParams,
    uplink_rate,
    downlink_rate,
    computation_delay,
    communication_delay,
    per_client_delay,
    round_delay,
    total_delay,
    computation_energy,
    upload_energy,
    round_energy,
    total_energy,
)

__all__ = [
    "ChannelModel", "GaussianAggregateNoise", "rayleigh_gains", "SystemParams",
    "uplink_rate", "downlink_rate",
    "computation_delay", "communication_delay", "per_client_delay",
    "round_delay", "total_delay",
    "computation_energy", "upload_energy", "round_energy", "total_energy",
]
