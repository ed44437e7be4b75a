"""Deterministic global RNG — the sole source of randomness in a simulation.

TPU-native analog of the reference's global seeded RNG
(madsim/src/sim/rand.rs:28-135): one `GlobalRng` per `Runtime`, seeded by a
u64, from which *every* random decision in the simulation is drawn —
scheduling order, virtual-time charges, network latency/loss rolls, chaos
injection, buggify, and user-visible `rand()` calls. One seed => one bit-exact
execution.

The generator is xoshiro256++ (public-domain algorithm by Blackman & Vigna)
seeded via splitmix64, mirroring the reference's choice of
`Xoshiro256PlusPlus::seed_from_u64`. The port's copy of
`madsim_tpu/core/rng.py`, without the optional native C++ generator: the
pure-Python path below is the one both faces run when the native core is not
built, so one seed draws the same stream on both.

Determinism checking (reference rand.rs:63-111): in check mode the RNG records
a log of `(value, time_hash)` pairs; a second run with the same seed replays
against the log and raises at the first divergence.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, MutableSequence, Optional, Sequence, TypeVar

_MASK64 = (1 << 64) - 1

T = TypeVar("T")


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK64


def splitmix64_next(state: int) -> tuple[int, int]:
    """One step of splitmix64; returns (new_state, output)."""
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


class Xoshiro256PP:
    """xoshiro256++ PRNG over u64, seeded from a u64 via splitmix64."""

    __slots__ = ("s0", "s1", "s2", "s3")

    def __init__(self, seed: int) -> None:
        state = seed & _MASK64
        state, self.s0 = splitmix64_next(state)
        state, self.s1 = splitmix64_next(state)
        state, self.s2 = splitmix64_next(state)
        state, self.s3 = splitmix64_next(state)

    def next_u64(self) -> int:
        s0, s1, s2, s3 = self.s0, self.s1, self.s2, self.s3
        result = (_rotl((s0 + s3) & _MASK64, 23) + s0) & _MASK64
        t = (s1 << 17) & _MASK64
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = _rotl(s3, 45)
        self.s0, self.s1, self.s2, self.s3 = s0, s1, s2, s3
        return result

    def getstate(self) -> tuple[int, int, int, int]:
        return (self.s0, self.s1, self.s2, self.s3)

    def setstate(self, state: tuple[int, int, int, int]) -> None:
        self.s0, self.s1, self.s2, self.s3 = state


class DeterminismError(AssertionError):
    """Raised when a determinism-check run diverges from the recorded log."""


class GlobalRng:
    """The per-runtime deterministic RNG with optional record/replay log.

    All helpers funnel through :meth:`next_u64` so the record/replay
    determinism check observes every draw.
    """

    def __init__(self, seed: int) -> None:
        self.seed = seed & _MASK64
        self._rng = Xoshiro256PP(self.seed)
        # determinism-check log: None = off, else list of (value, time_hash)
        self._log: Optional[List[tuple[int, int]]] = None
        self._check: Optional[List[tuple[int, int]]] = None
        self._check_pos = 0
        # a callback returning the current virtual time in ns, installed by
        # the runtime so log entries are time-annotated (reference
        # rand.rs:90-103 hashes the task + time context).
        self.time_hash_fn: Optional[Callable[[], int]] = None
        # buggify state (reference sim/buggify.rs keeps it beside the RNG):
        # the enable flag plus the two-level bookkeeping — per-run named
        # activation cache and the per-name fire-count registry feeding
        # the chaos-coverage report (core/buggify.py)
        self.buggify_enabled = False
        self.buggify_active: dict = {}
        self.buggify_fires: dict = {}

    # ---- record / replay (determinism check) ----

    def enable_recording(self) -> None:
        self._log = []

    def take_log(self) -> List[tuple[int, int]]:
        log, self._log = self._log or [], None
        return log

    def enable_check(self, log: List[tuple[int, int]]) -> None:
        self._check = log
        self._check_pos = 0

    def _time_hash(self) -> int:
        return self.time_hash_fn() if self.time_hash_fn is not None else 0

    @property
    def plain(self) -> bool:
        """True when no record/replay log is active (fast paths allowed)."""
        return self._log is None and self._check is None

    # ---- draws ----

    def next_u64(self) -> int:
        v = self._rng.next_u64()
        if self._log is not None:
            self._log.append((v, self._time_hash()))
        if self._check is not None:
            if self._check_pos >= len(self._check):
                raise DeterminismError(
                    f"non-determinism detected: extra RNG draw #{self._check_pos} "
                    f"(value={v:#x}, t={self._time_hash()})"
                )
            exp_v, exp_t = self._check[self._check_pos]
            got_t = self._time_hash()
            if v != exp_v or got_t != exp_t:
                raise DeterminismError(
                    f"non-determinism detected at RNG draw #{self._check_pos}: "
                    f"expected (value={exp_v:#x}, t={exp_t}), got (value={v:#x}, t={got_t})"
                )
            self._check_pos += 1
        return v

    def random(self) -> float:
        """Uniform float in [0, 1) with 53 bits of precision."""
        if self.plain:
            return (self._rng.next_u64() >> 11) * (1.0 / (1 << 53))
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    def randrange(self, start: int, stop: Optional[int] = None) -> int:
        """Uniform int in [start, stop) (or [0, start) with one arg)."""
        if stop is None:
            start, stop = 0, start
        n = stop - start
        if n <= 0:
            raise ValueError(f"empty range for randrange({start}, {stop})")
        # Lemire-style unbiased bounded draw via rejection sampling.
        threshold = (_MASK64 + 1) - ((_MASK64 + 1) % n)
        while True:
            v = self.next_u64()
            if v < threshold:
                return start + (v % n)

    def gen_range_f(self, lo: float, hi: float) -> float:
        return lo + self.random() * (hi - lo)

    def gen_bool(self, p: float) -> bool:
        return self.random() < p

    def choice(self, seq: Sequence[T]) -> T:
        return seq[self.randrange(len(seq))]

    def shuffle(self, seq: MutableSequence[T]) -> None:
        for i in range(len(seq) - 1, 0, -1):
            j = self.randrange(i + 1)
            seq[i], seq[j] = seq[j], seq[i]

    def sample_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u64().to_bytes(8, "little")
        return bytes(out[:n])
