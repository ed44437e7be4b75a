"""The speclang language surface: declarations + the restriction validator.

A copy of `madsim_tpu/speclang/lang.py` (tests/test_torch_speclang.py
holds its code equal to the original's). A protocol spec source
(speclang/specs/<x>.py) declares ONE `Protocol`: typed state fields with
bounds and durability, the message vocabulary, tunable knobs, and a `body`
function holding the handler bodies. The vocabulary is deliberately
restricted: frozen declarations, masked dataflow handlers, bounded loops
only, literal PRNG site constants. `validate_protocol` enforces the
restrictions by AST walk over the spec source, so a spec can never smuggle
in unbounded loops, computed draw sites, ambient entropy or host callbacks.

What each declaration DERIVES on the device face (device.py):

  Field.dtype/shape      the state NamedTuple leaf (int32 [L, N, *shape];
                         the port stores every leaf wide)
  Field.init             the init leaf (int constant, or a callable
                         `(key, nid) -> tensor` for draw-based identity
                         like lease's incarnation nonce — draw inits
                         must be durable, there is no constant to
                         restore on restart)
  Field.durable          on_restart: volatile fields reset to their
                         init constants, durable ones survive — the
                         restart handler is derived, not authored
  Field.narrow           the narrow_fields entry ("u8"/"u16"/"i16")
  Field.rate (Rate)      the rate_floors RateFloor entry AND the spec's
                         narrow_horizon_us via the shared formula
                         (dtype_max - max(0, init)) * floor_us
                             // (ratchet * inc * margin)
  Field.rate (Cap)       a HardCap entry (horizon-independent bound)
  Field.time             the time_fields entry (epoch-rebased stamps)
  Messages               msg_kind_names + the payload width
  DiskPlane              durable_fields / sync_field / on_recover
  KnobDecl               the tune SpecKnob rows (`device.knob_rows`)
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
from types import SimpleNamespace
from typing import Any, Callable, Mapping, Optional, Tuple

# the narrow vocabulary: at-rest storage dtypes the engine supports for
# r8 carry compaction (signed variants exist for -1-sentinel fields)
NARROW_DTYPES = ("u8", "u16", "i8", "i16")
# inclusive maxima used by the horizon derivation
NARROW_MAX = {"u8": 255, "u16": 65_535, "i8": 127, "i16": 32_767}


@dataclasses.dataclass(frozen=True)
class Rate:
    """A rate-argument bound: the field's global max gains at most
    `ratchet * inc` per `floor_us` of virtual time; `margin` divides the
    derived horizon once more (skew derating / authoring headroom —
    lease halves its budget, twopc runs at margin 1)."""

    floor_us: int
    ratchet: int = 1
    inc: int = 1
    margin: int = 1
    why: str = ""

    def __post_init__(self):
        if min(self.floor_us, self.ratchet, self.inc, self.margin) <= 0:
            raise ValueError("Rate floor_us/ratchet/inc/margin must be > 0")


@dataclasses.dataclass(frozen=True)
class Cap:
    """A horizon-independent bound: the field provably never exceeds
    `cap` regardless of virtual time."""

    cap: int
    why: str = ""


@dataclasses.dataclass(frozen=True)
class Field:
    """One state leaf. `init` is an int constant (broadcast over
    `shape`) or a callable `(key, nid) -> array` for draw-based
    identity; `shape` is a tuple of ints (params are applied before
    `Protocol.fields` runs, so shapes are already concrete there)."""

    name: str
    init: Any = 0
    shape: Tuple[int, ...] = ()
    durable: bool = True
    narrow: Optional[str] = None
    rate: Any = None  # Rate | Cap | None
    time: bool = False
    doc: str = ""

    def __post_init__(self):
        if self.narrow is not None and self.narrow not in NARROW_DTYPES:
            raise ValueError(
                f"field {self.name}: narrow must be one of {NARROW_DTYPES}"
            )
        if self.rate is not None and not isinstance(self.rate, (Rate, Cap)):
            raise ValueError(f"field {self.name}: rate must be Rate or Cap")
        if self.rate is not None and self.narrow is None:
            raise ValueError(
                f"field {self.name}: a Rate/Cap bound only backs a "
                "narrowed field"
            )
        if self.time and self.narrow is not None:
            raise ValueError(
                f"field {self.name}: time fields may never be narrowed"
            )
        if callable(self.init) and not self.durable:
            raise ValueError(
                f"field {self.name}: a draw-based init must be durable — "
                "there is no constant to restore on restart"
            )
        if (
            isinstance(self.rate, Rate)
            and not isinstance(self.init, int)
        ):
            raise ValueError(
                f"field {self.name}: a Rate-bounded field needs an int "
                "init (the horizon formula starts from it)"
            )


@dataclasses.dataclass(frozen=True)
class KnobDecl:
    """A Tier-B spec knob: `param` names the Protocol param the values
    re-parameterize; tune.py measures each candidate through a rebuild
    of the whole generated spec."""

    name: str
    param: str
    values: Tuple[Any, ...]
    default: Any = None


@dataclasses.dataclass(frozen=True)
class DiskPlane:
    """The durability contract (r18): `fields` are watermarked at every
    `sync_field` bump; `recover` (optional) is the on_recover hook —
    `(durable_state, nid, now, torn, key) -> (state, timer)` — None
    uses the watermark with init's timer verbatim."""

    fields: Tuple[str, ...]
    sync_field: str
    recover: Any = None


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One protocol, single-sourced. `fields(p)` and `body(p, State)`
    receive the resolved params namespace `p`; `body` returns a dict
    with the handler bodies both backends compile:

      on_event(s, nid, src, kind, payload, now, key)  (fused=True), or
      on_message(...) + on_timer(...)                 (fused=False —
          the device backend routes them through fuse_two_handlers)
      first_timer(key, nid)        init's first deadline
      restart_timer(s, nid, now, key)   post-crash deadline; receives
          the PRE-reset state (a spec may inspect what survived)
      check_invariants(ns, alive, now)  the per-lane safety oracle
      lane_metrics(node)           optional diagnostics
      host_stats(ns)               optional host-twin summary fields
    """

    name: str
    messages: Tuple[str, ...]
    payload_width: int
    params: Mapping[str, Any]
    fields: Callable[[Any], Tuple[Field, ...]]
    body: Callable[[Any, Any], Mapping[str, Any]]
    fused: bool = True
    max_out: Callable[[Any], int] = lambda p: 1
    max_out_msg: Optional[Callable[[Any], int]] = None
    horizon_margin: int = 1
    knobs: Tuple[KnobDecl, ...] = ()
    disk: Optional[DiskPlane] = None
    buggy_param: Optional[str] = None
    workload: Optional[Callable[..., Any]] = None
    doc: str = ""

    def resolve(self, **overrides) -> SimpleNamespace:
        """The params namespace `p` with overrides applied; unknown
        override names fail loudly (the classic silent-typo hazard of
        kwargs-driven factories)."""
        params = dict(self.params)
        unknown = set(overrides) - set(params)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown spec params {sorted(unknown)} "
                f"(declared: {sorted(params)})"
            )
        params.update(overrides)
        return SimpleNamespace(**params)


# --------------------------------------------------------------- validation
#
# The restriction walk. Speclang bodies are plain tensor code, but a
# restricted subset: the constructs below are exactly the ones the
# verifier tiers exist to catch, refused at AUTHORING time.

_FORBIDDEN_CALLS = {
    # unbounded control flow — a spec handler must be a bounded circuit
    "while_loop": "lax.while_loop (unbounded loop) in a spec body",
    # host re-entry — invisible step-serializing callbacks
    "io_callback": "host callback in a spec body",
    "pure_callback": "host callback in a spec body",
    "debug_callback": "host callback in a spec body",
    # ambient entropy (the source-lint rule, enforced earlier here)
    "urandom": "ambient entropy in a spec body",
}
# prng helpers whose SITE argument (position 1, after the key) must be
# an int literal. `fold` is exempt: its second argument is DATA mixed
# into the key (twopc folds the txn id before its vote draw), and the
# site contract is carried by the draw call that consumes the folded key.
_PRNG_FNS = {"bits", "uniform", "randint", "bernoulli"}
_PRNG_SITE_ARG = {"bits": 1, "uniform": 1, "randint": 1, "bernoulli": 1}


def _is_literal_int(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, int)


def validate_protocol(proto: Protocol) -> None:
    """AST-walk the spec source module for restriction violations.

    Enforced: no `while` statements or lax.while_loop, no host
    callbacks, no ambient-entropy modules, and every prng draw names
    its site as an int literal (sites are the replay contract — a
    computed site would make two draws collide or drift between
    emits). `for` loops are allowed only over literal/range bounds
    (bounded unrolling)."""
    src = textwrap.dedent(inspect.getsource(inspect.getmodule(proto.body)))
    tree = ast.parse(src)
    errors = []
    for node in ast.walk(tree):
        if isinstance(node, ast.While):
            errors.append(f"line {node.lineno}: while loop in a spec source")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names]
            mod = getattr(node, "module", "") or ""
            for n in names:
                top = (mod or n).split(".")[0]
                if top in ("random", "secrets", "uuid"):
                    errors.append(
                        f"line {node.lineno}: ambient-entropy import {top!r}"
                    )
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in _FORBIDDEN_CALLS:
                errors.append(
                    f"line {node.lineno}: {_FORBIDDEN_CALLS[name]}"
                )
            elif name in _PRNG_FNS:
                pos = _PRNG_SITE_ARG[name]
                if len(node.args) > pos and not _is_literal_int(
                    node.args[pos]
                ):
                    errors.append(
                        f"line {node.lineno}: prng.{name} site must be an "
                        "int literal (the draw-site replay contract)"
                    )
        elif isinstance(node, ast.For):
            it = node.iter
            ok = (
                isinstance(it, (ast.List, ast.Tuple))
                or (
                    isinstance(it, ast.Call)
                    and isinstance(it.func, ast.Name)
                    and it.func.id in ("range", "enumerate")
                )
            )
            if not ok:
                errors.append(
                    f"line {node.lineno}: for loop over a non-literal "
                    "iterable (bounded unrolls only: range/enumerate/"
                    "literal sequences)"
                )
    if errors:
        raise ValueError(
            f"speclang restriction violations in {proto.name}:\n  "
            + "\n  ".join(errors)
        )

    # declaration-level cross-checks (cheap; params at defaults)
    p = proto.resolve()
    fields = proto.fields(p)
    names = [f.name for f in fields]
    if len(set(names)) != len(names):
        raise ValueError(f"{proto.name}: duplicate field names")
    by_name = {f.name: f for f in fields}
    if proto.disk is not None:
        for f in proto.disk.fields:
            if f not in by_name:
                raise ValueError(
                    f"{proto.name}: disk plane names unknown field {f!r}"
                )
        if proto.disk.sync_field not in by_name:
            raise ValueError(
                f"{proto.name}: sync_field {proto.disk.sync_field!r} is "
                "not a declared field"
            )
    for k in proto.knobs:
        if k.param not in proto.params:
            raise ValueError(
                f"{proto.name}: knob {k.name!r} names unknown param "
                f"{k.param!r}"
            )
    if proto.buggy_param is not None and proto.buggy_param not in proto.params:
        raise ValueError(
            f"{proto.name}: buggy_param {proto.buggy_param!r} is not a "
            "declared param"
        )
