"""Cooperative fault injection — FoundationDB-style buggify
(reference madsim/src/sim/buggify.rs:8-32), upgraded to the reference's
TWO-LEVEL semantics:

  * ACTIVATION (per run): a NAMED fault point — `buggify("slow_disk")` —
    is active-this-run with probability `DEFAULT_ACTIVATION`, decided
    deterministically from (seed, name) alone via the same murmur3 chain
    the nemesis schedules use. Activation does NOT consume the global RNG
    stream, so whether a point is active never depends on call order, and
    two runs of one seed agree on the active set before the first hit.
  * FIRE (per hit): an active point fires each hit with probability
    `prob` (default 0.25), drawn from the simulation's global RNG — part
    of the seed-deterministic trajectory like every other draw.

Unnamed `buggify()` keeps the original single-level behavior (fire coin
only, gated on `enable()`), so existing call sites are untouched.

Every NAMED fire is counted in a per-run registry
(`fire_counts()` / `RuntimeMetrics.chaos_fires`), feeding the
chaos-coverage report: a buggify point with an activation that never
fired across a seed sweep is a dead fault point — the fuzzer thinks it
is exploring a failure mode it never actually exercises.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import context

DEFAULT_PROB = 0.25
DEFAULT_ACTIVATION = 0.25

# site constant for the (seed, name) activation coin (see nemesis.py's
# site namespace; schedule sites are 200+, buggify activation sits alone)
_SITE_ACTIVATION = 151


def _activation_coin(seed: int, name: str, activation_prob: float) -> bool:
    from ..nemesis import COIN_DENOM, bits32, fold32, key_from_seed

    key = fold32(key_from_seed(seed), _SITE_ACTIVATION)
    # fold the name in 4-byte words (stable across processes — no str hash)
    data = name.encode("utf-8")
    for i in range(0, len(data), 4):
        key = fold32(key, int.from_bytes(data[i : i + 4], "little"))
    return bits32(key, len(data)) % COIN_DENOM < int(
        round(activation_prob * COIN_DENOM)
    )


def buggify(
    name: Optional[str] = None,
    prob: float = DEFAULT_PROB,
    activation_prob: float = DEFAULT_ACTIVATION,
) -> bool:
    """Fire a fault point; named points use two-level semantics.

        if buggify():             # legacy: 25% per hit when enabled
        if buggify("slow_disk"):  # active in ~25% of runs; 25% per hit
                                  # in those runs; fires counted
    """
    if name is None:
        return buggify_with_prob(prob)
    if not is_active(name, activation_prob):
        return False
    rng = context.current_handle().rng
    fired = rng.gen_bool(prob)
    if fired:
        rng.buggify_fires[name] = rng.buggify_fires.get(name, 0) + 1
    return fired


def buggify_with_prob(prob: float) -> bool:
    handle = context.try_current_handle()
    if handle is None or not handle.rng.buggify_enabled:
        return False
    return handle.rng.gen_bool(prob)


def is_active(name: str, activation_prob: float = DEFAULT_ACTIVATION) -> bool:
    """Whether a named point is active this run (two-level, level one).

    Pure in (seed, name, activation_prob): callable before/after any hits
    without perturbing the RNG stream, and — because the cache is keyed on
    the probability too — never dependent on which call site asked first."""
    handle = context.try_current_handle()
    if handle is None or not handle.rng.buggify_enabled:
        return False
    rng = handle.rng
    cache_key = (name, activation_prob)
    active = rng.buggify_active.get(cache_key)
    if active is None:
        active = _activation_coin(rng.seed, name, activation_prob)
        rng.buggify_active[cache_key] = active
    return active


def fire_counts() -> Dict[str, int]:
    """Per-name fire counts for the current run (chaos-coverage report)."""
    handle = context.try_current_handle()
    if handle is None:
        return {}
    return dict(handle.rng.buggify_fires)


def enable() -> None:
    context.current_handle().rng.buggify_enabled = True


def disable() -> None:
    context.current_handle().rng.buggify_enabled = False


def is_enabled() -> bool:
    handle = context.try_current_handle()
    return handle is not None and handle.rng.buggify_enabled
