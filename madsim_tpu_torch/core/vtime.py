"""Virtual time: clock + timer wheel + sleep/timeout/interval primitives.

TPU-native analog of the reference's `madsim::time`
(madsim/src/sim/time/mod.rs:21-225, sleep.rs, interval.rs): all time in a
simulation is virtual. The clock only moves when the executor advances it —
either by the per-poll 50-100 ns charge or by jumping to the next timer event
(`advance_to_next_event`, +50 ns epsilon, time/mod.rs:45-60). Wall-clock time
is a randomized base date around 2022 (time/mod.rs:26-36) plus elapsed virtual
time, so `SystemTime::now()`-style reads are deterministic per seed.

The port's copy of `madsim_tpu/core/vtime.py`, with the pure-Python timer heap
only (the optional native timer is not ported).

Internally time is integer nanoseconds since simulation start — exact and
deterministic. Public APIs accept/return float seconds (Python idiom).
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Coroutine, List, Optional, Tuple

from .rng import GlobalRng

NANOS_PER_SEC = 1_000_000_000
# epsilon added when jumping to a timer deadline, mirroring the +50ns guard
# in reference time/mod.rs:45-60
_ADVANCE_EPS_NS = 50


def to_nanos(seconds: float | int) -> int:
    """Convert a duration in seconds to integer nanoseconds."""
    if isinstance(seconds, int):
        return seconds * NANOS_PER_SEC
    return round(seconds * NANOS_PER_SEC)


class TimerEntry:
    __slots__ = ("deadline_ns", "callback", "cancelled")

    def __init__(self, deadline_ns: int, callback: Callable[[], None]) -> None:
        self.deadline_ns = deadline_ns
        self.callback = callback
        self.cancelled = False


class Timer:
    """Min-heap timer wheel keyed on (deadline_ns, seq); lazily cancels."""

    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, TimerEntry]] = []
        self._seq = 0
        self._live = 0

    def add(self, deadline_ns: int, callback: Callable[[], None]) -> TimerEntry:
        entry = TimerEntry(deadline_ns, callback)
        heapq.heappush(self._heap, (deadline_ns, self._seq, entry))
        self._seq += 1
        self._live += 1
        return entry

    def cancel(self, entry: TimerEntry) -> None:
        if not entry.cancelled:
            entry.cancelled = True
            self._live -= 1

    def next_deadline(self) -> Optional[int]:
        """Earliest live deadline, or None if no timers remain."""
        heap = self._heap
        while heap and heap[0][2].cancelled:
            heapq.heappop(heap)
        return heap[0][0] if heap else None

    def expire(self, now_ns: int) -> None:
        """Fire (in deadline order) every live timer with deadline <= now."""
        heap = self._heap
        while heap and heap[0][0] <= now_ns:
            _, _, entry = heapq.heappop(heap)
            if entry.cancelled:
                continue
            self._live -= 1
            entry.callback()

    def __len__(self) -> int:
        return self._live


class Clock:
    """Virtual clock: elapsed ns since start + randomized wall-clock base."""

    def __init__(self, base_unix_ns: int) -> None:
        self.base_unix_ns = base_unix_ns
        self.elapsed_ns = 0

    def advance(self, delta_ns: int) -> None:
        self.elapsed_ns += delta_ns

    def set_elapsed(self, elapsed_ns: int) -> None:
        if elapsed_ns > self.elapsed_ns:
            self.elapsed_ns = elapsed_ns


class TimeHandle:
    """Handle to the simulation's time source."""

    def __init__(self, rng: GlobalRng) -> None:
        # base wall-clock date around 2022, mirroring time/mod.rs:26-36
        base_secs = 60 * 60 * 24 * 365 * (2022 - 1970) + rng.randrange(60 * 60 * 24 * 365)
        self.clock = Clock(base_secs * NANOS_PER_SEC)
        self.timer = Timer()
        # nemesis per-node clock skew: node_id -> integer ppm (0 = none),
        # installed by NemesisDriver. RELATIVE waits made by a skewed
        # node's tasks (sleep / add_timer_ns deadlines) stretch or shrink
        # by (1 + ppm * 1e-6) — the node's local clock runs fast or slow
        # while the simulation clock stays the single global truth.
        # Absolute-deadline timers (add_timer_at_ns — network deliveries,
        # backoff retries) are wire/simulator time and are never skewed.
        # Integer ppm, not a float rate (r8): exact-int truncation is the
        # SAME rule the device engine's scale_delay_ppm applies. NOTE the
        # faces still truncate at their own granularity (ns here, us on
        # the device), so a given delay's stretch can differ by up to
        # 1 us — what the shared rule buys is exactness (no float-mantissa
        # loss on long-horizon timers) and a common spec for both
        # implementations, not cross-face timer bit-equality (the twin
        # contract compares skew ASSIGNMENTS, not event times).
        self.node_skew: Optional[dict] = None

    # ---- reads ----

    def elapsed_ns(self) -> int:
        return self.clock.elapsed_ns

    def elapsed(self) -> float:
        """Virtual seconds since simulation start."""
        return self.clock.elapsed_ns / NANOS_PER_SEC

    def now_ns(self) -> int:
        """Monotonic virtual time in ns (Instant analog)."""
        return self.clock.elapsed_ns

    def now_time_ns(self) -> int:
        """Virtual unix time in ns (SystemTime analog)."""
        return self.clock.base_unix_ns + self.clock.elapsed_ns

    def now_time(self) -> float:
        """Virtual unix time in float seconds (`time.time()` analog)."""
        return self.now_time_ns() / NANOS_PER_SEC

    # ---- writes (executor / test API) ----

    def advance(self, seconds: float) -> None:
        """Manually advance the clock without firing timers (test API).

        Mirrors `TimeHandle::advance` used for the per-poll charge: timers due
        in the skipped window fire on the next `advance_to_next_event`.
        """
        self.clock.advance(to_nanos(seconds))

    def advance_ns(self, delta_ns: int) -> None:
        self.clock.advance(delta_ns)

    def add_timer(self, delay_seconds: float, callback: Callable[[], None]) -> TimerEntry:
        return self.add_timer_ns(to_nanos(delay_seconds), callback)

    def skew_delay_ns(self, delay_ns: int) -> int:
        """Scale a relative delay by the current task's node clock skew:
        delay + trunc(delay * |ppm| / 1e6) * sign(ppm), in exact integer
        arithmetic — the host-side mirror of the device engine's
        scale_delay_ppm (tpu/engine.py). The old `int(delay * rate)`
        float path both lost integer precision for large delays and
        rounded differently than the device's truncation rule."""
        if not self.node_skew:
            return delay_ns
        from . import context

        task = context.try_current_task()
        if task is None:
            return delay_ns
        ppm = self.node_skew.get(task.node.id)
        if not ppm:
            return delay_ns
        adj = delay_ns * abs(ppm) // 1_000_000
        return delay_ns + adj if ppm >= 0 else delay_ns - adj

    def add_timer_ns(self, delay_ns: int, callback: Callable[[], None]) -> TimerEntry:
        deadline = self.clock.elapsed_ns + self.skew_delay_ns(max(0, delay_ns))
        return self.timer.add(deadline, callback)

    def add_timer_at_ns(self, deadline_ns: int, callback: Callable[[], None]) -> TimerEntry:
        return self.timer.add(deadline_ns, callback)

    def cancel_timer(self, entry: TimerEntry) -> None:
        self.timer.cancel(entry)

    def advance_to_next_event(self) -> bool:
        """Jump the clock to the earliest timer and fire all due timers.

        Returns False when no timers remain (the executor turns that into a
        deadlock panic). Mirrors time/mod.rs:45-60 including the +50 ns
        epsilon.
        """
        deadline = self.timer.next_deadline()
        if deadline is None:
            return False
        now = deadline + _ADVANCE_EPS_NS
        self.clock.set_elapsed(now)
        self.timer.expire(now)
        return True


# ---- async primitives (bound to the current runtime via context) ----


def _current_time() -> TimeHandle:
    from . import context

    return context.current_handle().time


def current() -> TimeHandle:
    """The `TimeHandle` of the currently running runtime."""
    return _current_time()


class Sleep:
    """Awaitable that completes when virtual time reaches its deadline."""

    def __init__(self, deadline_ns: int, time: Optional[TimeHandle] = None) -> None:
        self._time = time or _current_time()
        self.deadline_ns = deadline_ns
        self._entry: Optional[TimerEntry] = None

    def __await__(self):
        from .futures import Future

        time = self._time
        if time.now_ns() >= self.deadline_ns:
            return
        fut: Future[None] = Future()
        self._entry = time.add_timer_at_ns(self.deadline_ns, lambda: fut.set_result(None))
        try:
            yield from fut.__await__()
        finally:
            if not fut.done():
                time.cancel_timer(self._entry)


def sleep(seconds: float):
    """Sleep for `seconds` of virtual time.

    Production (non-sim) mode: with no simulation context this is a real
    asyncio sleep — same user code against reality (lib.rs:14-23 switch).
    """
    from . import context

    if context.try_current_handle() is None:
        import asyncio

        return asyncio.sleep(seconds)
    t = _current_time()
    return Sleep(t.now_ns() + t.skew_delay_ns(to_nanos(seconds)), t)


def sleep_until(deadline_seconds: float) -> Sleep:
    """Sleep until virtual monotonic time `deadline_seconds` (since start)."""
    t = _current_time()
    return Sleep(to_nanos(deadline_seconds), t)


class TimeoutError_(TimeoutError):
    """Raised by `timeout()` when the inner future does not finish in time.

    Analog of `tokio::time::error::Elapsed` (reference time/error.rs).
    """

    def __str__(self) -> str:  # match tokio's message
        return "deadline has elapsed"


Elapsed = TimeoutError_


async def timeout(seconds: float, awaitable: Coroutine[Any, Any, Any] | Any) -> Any:
    """Run `awaitable` with a virtual-time deadline; raise Elapsed on expiry.

    Production (non-sim) mode: real asyncio.wait_for, re-raising Elapsed."""
    from .futures import Future
    from . import context

    if context.try_current_handle() is None:
        import asyncio

        try:
            return await asyncio.wait_for(awaitable, seconds)
        except asyncio.TimeoutError:
            raise Elapsed() from None

    handle = context.current_handle()
    time = handle.time
    done: Future[Tuple[bool, Any, Optional[BaseException]]] = Future()

    async def runner() -> None:
        try:
            result = await awaitable
        except BaseException as e:  # noqa: BLE001 - forwarded to caller
            if not done.done():
                done.set_result((True, None, e))
            return
        if not done.done():
            done.set_result((True, result, None))

    task = context.current_task().node_spawner().spawn(runner(), name="timeout")
    entry = time.add_timer_ns(
        to_nanos(seconds),
        lambda: done.set_result((False, None, None)) if not done.done() else None,
    )
    try:
        finished, result, exc = await done
    finally:
        # cancelled mid-await (GeneratorExit): drop the inner future + timer,
        # matching tokio's drop-the-timeout-drops-the-inner semantics
        time.cancel_timer(entry)
        if not task.is_finished():
            task.abort()
    if finished:
        if exc is not None:
            raise exc
        return result
    raise Elapsed()


class MissedTickBehavior:
    """What `Interval` does when ticks are missed (tokio semantics)."""

    BURST = "burst"
    DELAY = "delay"
    SKIP = "skip"


class Interval:
    """Fixed-period ticker over virtual time (tokio `Interval` analog;
    reference time/interval.rs)."""

    def __init__(self, start_ns: int, period_ns: int, time: TimeHandle) -> None:
        if period_ns <= 0:
            raise ValueError("interval period must be > 0")
        self._time = time
        self.period_ns = period_ns
        self._next_ns = start_ns
        self.missed_tick_behavior = MissedTickBehavior.BURST

    async def tick(self) -> float:
        """Wait for the next tick; returns its virtual deadline (seconds)."""
        now = self._time.now_ns()
        deadline = self._next_ns
        if deadline > now:
            await Sleep(deadline, self._time)
        behavior = self.missed_tick_behavior
        now = self._time.now_ns()
        if behavior == MissedTickBehavior.BURST or now < deadline + self.period_ns:
            self._next_ns = deadline + self.period_ns
        elif behavior == MissedTickBehavior.DELAY:
            self._next_ns = now + self.period_ns
        else:  # SKIP: next multiple of period after now
            missed = (now - deadline) // self.period_ns + 1
            self._next_ns = deadline + missed * self.period_ns
        return deadline / NANOS_PER_SEC

    def reset(self) -> None:
        self._next_ns = self._time.now_ns() + self.period_ns


def interval(period_seconds: float) -> Interval:
    """Interval whose first tick completes immediately."""
    t = _current_time()
    return Interval(t.now_ns(), to_nanos(period_seconds), t)


def interval_at(start_seconds: float, period_seconds: float) -> Interval:
    """Interval whose first tick completes at monotonic `start_seconds`."""
    t = _current_time()
    return Interval(to_nanos(start_seconds), to_nanos(period_seconds), t)
