"""ProtocolSpec: how a protocol plugs into the batched PyTorch engine.

The contract of `madsim_tpu/tpu/spec.py`, with one difference of form: the
JAX handlers are written for one (lane, node) and vmapped by the engine,
while these handlers are written over explicit leading `[L, N]` axes —
every node-state leaf is `[L, N, ...]`, every scalar argument `[L, N]` —
which is also the shape a later fused kernel would see.

Handler contract:

    init(key [L,N], node_id [N]) -> (node_state, first_timer_us [L,N])

    on_event(state, node_id, src, kind, payload [L,N,P], now_us, key)
        -> (state', Outbox with [L,N,E] leaves, next_timer_us [L,N])
        `kind == -1` means "your timer fired". On a message a negative
        next_timer keeps the current deadline; on a timer it disarms.

    on_message(state, node_id, src, kind, payload, now_us, key)
    on_timer(state, node_id, now_us, key)
        -> (state', Outbox with [L,N,max_out_msg] / [L,N,max_out] leaves,
            next_timer_us [L,N]); the engine runs these two (and merges
            their states) only for specs without a fused `on_event`.

    on_restart(state, node_id, now_us [L], key) -> (state, first_timer_us)

    on_recover(durable_state, node_id, now_us [L], torn [L], key)
        -> (state', next_timer_us [L,N] relative to now_us); optional, the
        disk clause's recovery hook for specs with `durable_fields`.

    check_invariants(state, alive [L,N], now_us [L]) -> ok [L] bool

Integer conventions (see prng.py): i32 values are int32 tensors, u32
values are int64 tensors in [0, 2^32), bools are bool tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, NamedTuple

import torch

from . import prng

# sentinel for "no timer" / "no event" (int32 microseconds)
INF_US = 2**31 - 1
# sentinel for "no event id" in the causal-lineage plane (u32)
EID_NONE = 0xFFFFFFFF
# unbounded virtual time: every time tensor is an int32 OFFSET from a
# per-lane epoch; a lane whose clock offset crosses REBASE_US shifts every
# live offset down by REBASE_US and bumps its epoch. Values >= INF_GUARD
# are sentinels and are never rebased.
REBASE_US = 1 << 28
INF_GUARD = 1 << 30



def derate_horizon(cap_us: int, skew_max_ppm: int) -> int:
    """Derate a narrow-dtype safe horizon for clock skew (timer floors
    shrink by up to max_ppm * 1e-6, so the horizon cap shrinks with them)."""
    if not (0 <= int(skew_max_ppm) < 1_000_000):
        raise ValueError(
            f"skew_max_ppm must be in [0, 1e6), got {skew_max_ppm}"
        )
    return int(cap_us) * (1_000_000 - int(skew_max_ppm)) // 1_000_000


@dataclasses.dataclass(frozen=True)
class RateFloor:
    """Cadence bound behind a rate-argument narrowing: the field's global
    maximum gains at most `ratchet * inc` per `floor_us` of virtual time."""

    floor_us: int
    ratchet: int = 1
    inc: int = 1
    why: str = ""

    def __post_init__(self):
        if self.floor_us <= 0 or self.ratchet <= 0 or self.inc <= 0:
            raise ValueError(
                "RateFloor floor_us/ratchet/inc must all be positive, got "
                f"({self.floor_us}, {self.ratchet}, {self.inc})"
            )


@dataclasses.dataclass(frozen=True)
class HardCap:
    """Horizon-independent value bound behind a narrowing (inclusive)."""

    cap: int
    why: str = ""

    def __post_init__(self):
        if self.cap < 0:
            raise ValueError(f"HardCap cap must be >= 0, got {self.cap}")


def buggify(key, site: int, p: float = 0.25) -> torch.Tensor:
    """Cooperative fault injection inside handlers: a deterministic coin
    per (lane, node, step) drawn from the handler's own key."""
    return prng.bernoulli(key, site, p)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 word (int32 or int64 input; int64 result):
    `jax.lax.population_count` has no torch counterpart, so SWAR bit
    arithmetic (every intermediate stays below 2^53)."""
    x = prng.u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & prng.M32) >> 24


def majority(mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Popcount-majority over an int32 ack bitmask (> n/2)."""
    return popcount(mask) > n_nodes // 2


def bit(n: torch.Tensor) -> torch.Tensor:
    """`1 << n` in n's dtype (the int32 ack-bitmask idiom)."""
    return torch.bitwise_left_shift(torch.ones_like(n), n)


def select_sum(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values [..., K] at the one-hot `mask` [..., K] as int32, 0 where the
    mask is empty: the JAX face's one-hot multiply-and-sum lookup."""
    return torch.where(mask, values, 0).sum(dim=-1, dtype=torch.int32)


def stack_fields(*fields, width: int = 0) -> torch.Tensor:
    """Stack broadcastable int fields (tensors or Python ints) into an int32
    payload row [..., P], zero-padded to `width` fields. Built with
    `torch.stack`, so every field lands at a static index."""
    ts = [f for f in fields if isinstance(f, torch.Tensor)]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    dev = ts[0].device
    cols = [
        torch.broadcast_to(f.to(torch.int32), shape)
        if isinstance(f, torch.Tensor)
        else torch.full(shape, f, dtype=torch.int32, device=dev)
        for f in fields
    ]
    zero = torch.zeros(shape, dtype=torch.int32, device=dev)
    cols += [zero] * max(0, width - len(cols))
    return torch.stack(cols, dim=-1)


def tree_map(fn: Callable, *trees):
    """Map `fn` over the tensor leaves of NamedTuples (nested); a None leaf
    in the first tree stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(
            tree_map(fn, *leaves) for leaves in zip(*trees)
        ))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Tensor leaves of nested (Named)tuples, in field order, Nones dropped."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for f in tree for x in tree_leaves(f)]
    return [tree]


def expand_to(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Append unit dims to `mask` so it broadcasts against `x`'s trailing
    dims."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def tree_select(cond: torch.Tensor, a, b):
    """Elementwise select between two pytrees on a leading-axes condition."""
    return tree_map(lambda x, y: torch.where(expand_to(cond, x), x, y), a, b)


class Outbox(NamedTuple):
    """Send buffer returned by on_event: up to E messages per node."""

    valid: Any  # bool [L,N,E]
    dst: Any  # int32 [L,N,E]
    kind: Any  # int32 [L,N,E]
    payload: Any  # int32 [L,N,E,P]


def fuse_two_handlers(spec: "ProtocolSpec") -> "ProtocolSpec":
    """Derive a fused `on_event` from a spec's on_message/on_timer by
    running both bodies and selecting (kind == -1 => timer), as the JAX
    face does: the message body sees `max(kind, 0)`. Requires
    max_out == max_out_msg so the two outbox shapes line up."""
    if spec.max_out != spec.max_out_msg:
        raise ValueError(
            "fuse_two_handlers needs max_out == max_out_msg "
            f"(got {spec.max_out} != {spec.max_out_msg})"
        )

    def on_event(s, nid, src, kind, payload, now, key):
        st_m, out_m, tm_m = spec.on_message(
            s, nid, src, torch.clamp(kind, min=0), payload, now, key
        )
        st_t, out_t, tm_t = spec.on_timer(s, nid, now, key)
        is_timer = kind == -1
        return (
            tree_select(is_timer, st_t, st_m),
            tree_select(is_timer, out_t, out_m),
            torch.where(is_timer, tm_t, tm_m),
        )

    # the two-handler bodies this fused body derives from, so the
    # ProtocolSpec stale-wrapper guard accepts the resulting spec
    on_event.__fused_from__ = (spec.on_message, spec.on_timer)
    return dataclasses.replace(spec, on_event=on_event)


def pool_kw_for(spec: "ProtocolSpec", fused: dict, two_handler: dict) -> dict:
    """The pool-sizing SimConfig kwargs for the spec's engine path: fused
    (on_event) specs place node-pooled slots (depth + spare), two-handler
    specs per-class rings (per-class depths)."""
    return dict(fused if spec.on_event is not None else two_handler)


def wraps_event(on_event: Callable) -> Callable:
    """Mark a derived on_message/on_timer wrapper as delegating to the given
    fused `on_event` body (see ProtocolSpec's stale-wrapper guard)."""

    def mark(fn: Callable) -> Callable:
        fn.__wraps_event__ = on_event
        return fn

    return mark


def replace_handlers(spec: "ProtocolSpec", **overrides) -> "ProtocolSpec":
    """dataclasses.replace for handler overrides that also clears the fused
    on_event body unless the override provides its own."""
    if (
        ("on_message" in overrides or "on_timer" in overrides)
        and "on_event" not in overrides
    ):
        overrides = {**overrides, "on_event": None}
    return dataclasses.replace(spec, **overrides)


def empty_outbox(
    max_out: int, payload_width: int, lead: tuple = (), device="cpu",
) -> Outbox:
    return Outbox(
        valid=torch.zeros(lead + (max_out,), dtype=torch.bool, device=device),
        dst=torch.zeros(lead + (max_out,), dtype=torch.int32, device=device),
        kind=torch.zeros(lead + (max_out,), dtype=torch.int32, device=device),
        payload=torch.zeros(
            lead + (max_out, payload_width), dtype=torch.int32, device=device
        ),
    )


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """The fields of the JAX face's ProtocolSpec, with [L,N] handlers.

    `narrow_fields` names the fields the JAX face stores narrow ({field ->
    numpy dtype}). This face stores every node leaf wide; the table still
    drives the `narrow_horizon_us` refusal, so both faces accept the same
    configs."""

    name: str
    n_nodes: int
    payload_width: int
    max_out: int
    init: Callable
    on_message: Callable
    on_timer: Callable
    on_restart: Callable
    check_invariants: Callable
    max_out_msg: int = 1
    on_event: Any = None
    lane_metrics: Any = None
    msg_kind_names: Any = None
    time_fields: tuple = ()
    narrow_fields: Any = None
    narrow_horizon_us: Any = None
    rate_floors: Any = None
    durable_fields: tuple = ()
    sync_field: Any = None
    on_recover: Any = None

    def __post_init__(self):
        # stale-wrapper guard: on a fused spec the engine runs ONLY
        # on_event, so every on_message/on_timer must visibly derive from it
        if self.on_event is None:
            return
        fused_from = getattr(self.on_event, "__fused_from__", ())
        for role in ("on_message", "on_timer"):
            w = getattr(self, role)
            ok = (
                w is self.on_event
                or getattr(w, "__wraps_event__", None) is self.on_event
                or any(w is f for f in fused_from)
            )
            if not ok:
                raise ValueError(
                    f"{self.name}: {role} does not derive from this "
                    "spec's fused on_event, so the engine would silently "
                    f"never run it (a bare dataclasses.replace(spec, "
                    f"{role}=...) on a fused spec is the classic form). "
                    "Use replace_handlers(...) to override handlers on a "
                    "fused spec, or replace on_event as well and mark "
                    "derived wrappers with @wraps_event(on_event)."
                )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Engine knobs. Field for field the JAX face's SimConfig (same order,
    same defaults), so `to_toml()` and `hash()` name one config on both
    faces."""

    msg_capacity: int = 64
    msg_depth_msg: "int | None" = None
    msg_depth_timer: "int | None" = None
    msg_spare_slots: int = 0
    latency_lo_us: int = 1_000
    latency_hi_us: int = 10_000
    loss_rate: float = 0.0
    buggify_delay_rate: float = 0.0
    buggify_delay_lo_us: int = 1_000_000
    buggify_delay_hi_us: int = 5_000_000
    buggify_depth: int = 4
    crash_interval_lo_us: int = 0
    crash_interval_hi_us: int = 0
    restart_delay_lo_us: int = 1_000_000
    restart_delay_hi_us: int = 10_000_000
    partition_interval_lo_us: int = 0
    partition_interval_hi_us: int = 0
    partition_heal_lo_us: int = 500_000
    partition_heal_hi_us: int = 3_000_000
    nem_crash_interval_lo_us: int = 0
    nem_crash_interval_hi_us: int = 0
    nem_crash_down_lo_us: int = 500_000
    nem_crash_down_hi_us: int = 3_000_000
    nem_crash_wipe_rate: float = 0.0
    nem_partition_interval_lo_us: int = 0
    nem_partition_interval_hi_us: int = 0
    nem_partition_heal_lo_us: int = 500_000
    nem_partition_heal_hi_us: int = 3_000_000
    nem_clog_interval_lo_us: int = 0
    nem_clog_interval_hi_us: int = 0
    nem_clog_heal_lo_us: int = 500_000
    nem_clog_heal_hi_us: int = 3_000_000
    nem_spike_interval_lo_us: int = 0
    nem_spike_interval_hi_us: int = 0
    nem_spike_duration_lo_us: int = 200_000
    nem_spike_duration_hi_us: int = 1_000_000
    nem_spike_extra_us: int = 100_000
    nem_loss_rate: float = 0.0
    nem_dup_rate: float = 0.0
    nem_reorder_rate: float = 0.0
    nem_reorder_window_us: int = 0
    nem_skew_max_ppm: int = 0
    nem_reconfig_interval_lo_us: int = 0
    nem_reconfig_interval_hi_us: int = 0
    nem_reconfig_down_lo_us: int = 500_000
    nem_reconfig_down_hi_us: int = 3_000_000
    nem_disk_interval_lo_us: int = 0
    nem_disk_interval_hi_us: int = 0
    nem_disk_slow_lo_us: int = 100_000
    nem_disk_slow_hi_us: int = 500_000
    nem_disk_down_lo_us: int = 500_000
    nem_disk_down_hi_us: int = 3_000_000
    nem_disk_torn_rate: float = 0.0
    nem_disk_extra_us: int = 50_000
    horizon_us: int = 30_000_000
    sched_randomize: bool = True
    lookahead: bool = True

    def to_toml(self) -> str:
        """Every knob as flat TOML in field order; None fields omitted."""
        lines = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, bool):
                lines.append(f"{f.name} = {'true' if v else 'false'}")
            else:
                lines.append(f"{f.name} = {v}")
        return "\n".join(lines) + "\n"

    def hash(self) -> str:
        """Stable hex digest of the full config."""
        return hashlib.sha256(self.to_toml().encode()).hexdigest()[:16]

    @property
    def chaos_enabled(self) -> bool:
        return self.crash_interval_hi_us > 0

    @property
    def partition_enabled(self) -> bool:
        return self.partition_interval_hi_us > 0

    @property
    def nem_crash_enabled(self) -> bool:
        return self.nem_crash_interval_hi_us > 0

    @property
    def nem_partition_enabled(self) -> bool:
        return self.nem_partition_interval_hi_us > 0

    @property
    def nem_clog_enabled(self) -> bool:
        return self.nem_clog_interval_hi_us > 0

    @property
    def nem_spike_enabled(self) -> bool:
        return self.nem_spike_interval_hi_us > 0

    @property
    def nem_skew_enabled(self) -> bool:
        return self.nem_skew_max_ppm > 0

    @property
    def nem_reconfig_enabled(self) -> bool:
        return self.nem_reconfig_interval_hi_us > 0

    @property
    def nem_disk_enabled(self) -> bool:
        return self.nem_disk_interval_hi_us > 0

    @property
    def nem_dup_enabled(self) -> bool:
        return self.nem_dup_rate > 0

    @property
    def any_crash_enabled(self) -> bool:
        return self.chaos_enabled or self.nem_crash_enabled

    @property
    def any_partition_enabled(self) -> bool:
        return self.partition_enabled or self.nem_partition_enabled


def simconfig_from_toml(text: str) -> SimConfig:
    """Parse a SimConfig from its `to_toml` document (round-trip exact).
    Unknown keys fail loudly: a document from a newer tree must not be
    half-applied."""
    import tomllib

    doc = tomllib.loads(text)
    unknown = set(doc) - {f.name for f in dataclasses.fields(SimConfig)}
    if unknown:
        raise ValueError(
            f"SimConfig TOML: unknown SimConfig fields {sorted(unknown)}"
        )
    return SimConfig(**doc)
