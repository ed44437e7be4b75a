"""Simulation configuration (reference madsim/src/sim/config.rs:15-48).

`Config` holds per-simulation knobs — the network chaos parameters
(`NetConfig`: packet loss + latency range, reference net/network.rs:69-97,
plus the nemesis message-level clauses: extra loss, duplication, bounded
reordering) and a TCP section. Parses from TOML text, dumps back, and
hashes stably for cache keying (config.rs:27-31).

Knobs are VALIDATED at construction and parse time: the host network and
the TPU engine enforce the same ranges with the same messages, so a bad
`packet_loss_rate = 1.5` fails loudly at the config boundary instead of
silently clamping on one backend and raising on the other.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import tomllib


def _check_rate(name: str, value: float) -> float:
    # the same contract (and message shape) BatchedSim enforces for
    # SimConfig.loss_rate — see tpu/engine.py construction-time checks
    if not (0.0 <= value < 1.0):
        raise ValueError(f"{name} must be in [0, 1), got {value}")
    return value


@dataclass
class NetConfig:
    """Network chaos knobs (reference net/network.rs:69-89 + nemesis).

    Defaults mirror the reference: zero loss, 1-10 ms one-way latency.
    The `packet_*` nemesis knobs are the message-level half of a
    `madsim_tpu_torch.nemesis.FaultPlan` (loss / duplication / bounded
    reordering); schedule-level clauses drive NetSim directly.
    """

    packet_loss_rate: float = 0.0
    send_latency_min: float = 0.001
    send_latency_max: float = 0.010
    # nemesis message-level clauses (FaultPlan.to_net_config writes these)
    packet_extra_loss_rate: float = 0.0  # on top of packet_loss_rate
    packet_duplicate_rate: float = 0.0  # copy with an independent latency
    packet_reorder_rate: float = 0.0  # extra delay in [0, reorder_window]
    packet_reorder_window: float = 0.0  # seconds
    # runtime episode state + fire counters, driven by NemesisDriver —
    # NOT declarative config (excluded from to_toml/hash)
    spike_extra_latency: float = field(default=0.0, compare=False)
    nemesis_fires: dict = field(default_factory=dict, compare=False)
    # schedule-matched coin provider (nemesis.ScheduleCoins), installed
    # by NemesisDriver.install; None = ambient GlobalRng rolls
    coins: object = field(default=None, compare=False)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> "NetConfig":
        _check_rate("packet_loss_rate", self.packet_loss_rate)
        _check_rate("packet_extra_loss_rate", self.packet_extra_loss_rate)
        _check_rate("packet_duplicate_rate", self.packet_duplicate_rate)
        _check_rate("packet_reorder_rate", self.packet_reorder_rate)
        if self.send_latency_min < 0 or self.send_latency_max < self.send_latency_min:
            raise ValueError(
                f"latency range [{self.send_latency_min}, "
                f"{self.send_latency_max}] must satisfy 0 <= lo <= hi"
            )
        if self.packet_reorder_window < 0:
            raise ValueError(
                f"packet_reorder_window must be >= 0, got "
                f"{self.packet_reorder_window}"
            )
        if self.packet_reorder_rate > 0 and self.packet_reorder_window <= 0:
            # the engine raises for the equivalent nem_reorder combo; a
            # rate with no window would silently run zero reordering
            raise ValueError(
                "packet_reorder_rate needs packet_reorder_window > 0, got "
                f"{self.packet_reorder_window}"
            )
        return self

    def count_fire(self, kind: str) -> None:
        """Count one nemesis message-coin firing (loss/dup/reorder)."""
        self.nemesis_fires[kind] = self.nemesis_fires.get(kind, 0) + 1

    def to_toml(self) -> str:
        # every declarative knob is emitted (even at its default) so
        # Config.hash() keys on the full chaos surface
        return (
            "[net]\n"
            f"packet_loss_rate = {self.packet_loss_rate}\n"
            f'send_latency = "{self.send_latency_min}s..{self.send_latency_max}s"\n'
            f"packet_extra_loss_rate = {self.packet_extra_loss_rate}\n"
            f"packet_duplicate_rate = {self.packet_duplicate_rate}\n"
            f"packet_reorder_rate = {self.packet_reorder_rate}\n"
            f'packet_reorder_window = "{self.packet_reorder_window}s"\n'
        )


@dataclass
class TcpConfig:
    """TCP section — empty in the reference too (net/tcp/config.rs)."""


@dataclass
class Config:
    net: NetConfig = field(default_factory=NetConfig)
    tcp: TcpConfig = field(default_factory=TcpConfig)

    @staticmethod
    def parse(text: str) -> "Config":
        data = tomllib.loads(text)
        cfg = Config()
        net = data.get("net", {})
        if "packet_loss_rate" in net:
            cfg.net.packet_loss_rate = float(net["packet_loss_rate"])
        if "send_latency" in net:
            lat = net["send_latency"]
            if isinstance(lat, str):
                lo, _, hi = lat.partition("..")
                cfg.net.send_latency_min = _parse_dur(lo)
                cfg.net.send_latency_max = _parse_dur(hi or lo)
            else:
                cfg.net.send_latency_min = cfg.net.send_latency_max = float(lat)
        for key in (
            "packet_extra_loss_rate",
            "packet_duplicate_rate",
            "packet_reorder_rate",
        ):
            if key in net:
                setattr(cfg.net, key, float(net[key]))
        if "packet_reorder_window" in net:
            w = net["packet_reorder_window"]
            cfg.net.packet_reorder_window = (
                _parse_dur(w) if isinstance(w, str) else float(w)
            )
        # parse writes fields post-construction, so re-validate explicitly:
        # an out-of-range TOML knob must fail HERE with the engine's
        # message, not deep inside a send path
        cfg.net.validate()
        return cfg

    def to_toml(self) -> str:
        return self.net.to_toml()

    def hash(self) -> int:
        """Stable 64-bit hash of the config (analog of ahash config-hash)."""
        digest = hashlib.sha256(self.to_toml().encode()).digest()
        return int.from_bytes(digest[:8], "little")


def _parse_dur(s: str) -> float:
    s = s.strip()
    for suffix, scale in (("ms", 1e-3), ("us", 1e-6), ("ns", 1e-9), ("s", 1.0)):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * scale
    return float(s)
