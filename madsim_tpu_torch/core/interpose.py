"""Stdlib interposition: make user code deterministic inside a simulation.

Analog of the reference's libc interposition (rand.rs:195-263 fakes
getrandom/getentropy, time/system_time.rs:4-110 fakes gettimeofday/
clock_gettime, task/mod.rs:753-769 errors pthread creation). The reference
dlsym-interposes libc so *std* types are deterministic under the sim and
untouched outside it; the Python analog patches the stdlib entry points with
dispatchers that consult the TLS simulation context:

  - inside a sim: `time.time/monotonic/perf_counter` (+ `_ns` variants) read
    the virtual clock; `random.*` module functions and `os.urandom` draw from
    the seeded GlobalRng (which also makes `uuid.uuid4()`, `random.Random()`
    seeding, and `secrets` deterministic, since they bottom out in urandom);
    `threading.Thread.start`, `asyncio.run`, and `time.sleep` raise — real
    threads / event loops / blocking sleeps inside a sim are bugs.
  - outside a sim: every patch passes straight through to the original.

Installed at Runtime construction (install() is idempotent); uninstall()
restores everything this module patched (used by tests).

The port's copy of `madsim_tpu/core/interpose.py`, made safe to share a
process with the JAX face's interposer (the differential tests run both).
Each patch captures the function it replaced and, outside a port sim,
calls THAT: whichever face installed second wraps the first, and each face
answers only for its own TLS context, so a sim of either face reads its own
clock and RNG. `install()` re-checks every patch rather than trusting a flag
(the other face's uninstall may have put the stdlib back), and `uninstall()`
restores only attributes that still hold this module's patch; a patch that
another face wrapped stays in that chain, switched to pass-through.

`datetime.datetime.now/utcnow/today` and `datetime.date.today` read the
system clock in C without going through `time.time`; they are virtualized
by installing dispatching SUBCLASSES as the `datetime` module attributes
(the reference covers this case because libc interposition sits below
everything, time/system_time.rs:4-110). Residual hole, documented: a module
that captured `from datetime import datetime` BEFORE install() keeps the
unpatched class — install early (Runtime construction does).
"""

from __future__ import annotations

import asyncio
import datetime as datetime_mod
import os
import random as random_mod
import threading
import time as time_mod
from typing import Any, Callable, Dict, List, Tuple

from . import context

# "module.attr" -> (the function this module replaced, its patch)
_installed: Dict[str, Tuple[Any, Any]] = {}
_active = False


def _handle():
    if not _active:
        return None
    return context.try_current_handle()


class SimForbiddenError(RuntimeError):
    """A nondeterministic primitive was used inside a simulation."""


# --------------------------------------------------------------------- time


def _make_time_patch(name: str, virtual_fn):
    def make(orig):
        def patched(*args, **kwargs):
            h = _handle()
            if h is None:
                return orig(*args, **kwargs)
            return virtual_fn(h)

        patched.__name__ = name
        return patched

    return make


def _make_sleep_patch(orig):
    def _patched_sleep(seconds):
        h = _handle()
        if h is None:
            return orig(seconds)
        raise SimForbiddenError(
            "time.sleep() blocks the real clock inside a simulation; "
            "use `await madsim_tpu_torch.time.sleep(...)` instead"
        )

    return _patched_sleep


# ----------------------------------------------------------------- datetime


def _now_seconds() -> float:
    """Virtual seconds inside a sim, real seconds outside (through whatever
    `time.time` is installed, so a sim of the other face reads its own)."""
    h = _handle()
    if h is not None:
        return h.time.now_time()
    return time_mod.time()


def _stdlib_class(cls):
    """The stdlib class under any interposer's dispatching subclass."""
    return next(k for k in cls.__mro__ if k.__module__ == "datetime")


_DATE = _stdlib_class(datetime_mod.date)
_DATETIME = _stdlib_class(datetime_mod.datetime)


class _DateMeta(type(_DATE)):
    """isinstance/issubclass see through the subclass install: a plain
    datetime.date (e.g. parsed or constructed before install) must still
    satisfy `isinstance(x, datetime.date)` when `datetime.date` is the
    patched class — mirroring how the reference's interposition changes
    behavior, never types.

    One metaclass serves both classes (each names its stdlib class in
    `_madsim_torch_base`), so an interposer that later subclasses these
    classes with metaclasses derived from `type(datetime.date)` — the JAX
    face's, imported after this one installed — has no metaclass
    conflict."""

    def __instancecheck__(cls, obj):
        return isinstance(obj, cls._madsim_torch_base)

    def __subclasscheck__(cls, sub):
        return issubclass(sub, cls._madsim_torch_base)


class _SimDate(_DATE, metaclass=_DateMeta):
    """datetime.date with a virtual-clock `today()` (TLS dispatch)."""

    _madsim_torch_base = _DATE

    @classmethod
    def today(cls):
        return cls.fromtimestamp(_now_seconds())


class _SimDatetime(_DATETIME, metaclass=_DateMeta):
    """datetime.datetime with virtual-clock now/utcnow/today."""

    _madsim_torch_base = _DATETIME

    @classmethod
    def now(cls, tz=None):
        return cls.fromtimestamp(_now_seconds(), tz)

    @classmethod
    def utcnow(cls):
        return cls.fromtimestamp(
            _now_seconds(), datetime_mod.timezone.utc
        ).replace(tzinfo=None)

    @classmethod
    def today(cls):
        return cls.fromtimestamp(_now_seconds())


# ------------------------------------------------------------------- random


def _rng_bytes(h, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        out += h.rng.next_u64().to_bytes(8, "little")
    return bytes(out[:n])


_STDLIB_RANDOM = next(
    k for k in random_mod.Random.__mro__ if k.__module__ == "random"
)


class _SimRandom(_STDLIB_RANDOM):
    """A Random whose entropy is the simulation's GlobalRng.

    Overriding random()/getrandbits() routes every distribution method
    (uniform, gauss, choice, shuffle, sample, ...) through the seeded,
    record/replay-logged GlobalRng.
    """

    def random(self) -> float:  # type: ignore[override]
        return context.current_handle().rng.random()

    def getrandbits(self, k: int) -> int:  # type: ignore[override]
        h = context.current_handle()
        out = 0
        filled = 0
        while filled < k:
            take = min(64, k - filled)
            out |= (h.rng.next_u64() >> (64 - take)) << filled
            filled += take
        return out

    def seed(self, *args, **kwargs) -> None:  # type: ignore[override]
        # reseeding the global stream inside a sim is ignored: determinism
        # comes from the simulation seed (mirrors std RandomState seeding,
        # reference rand.rs:176-244)
        return None

    def getstate(self):  # type: ignore[override]
        raise SimForbiddenError(
            "random.getstate() inside a simulation is not supported"
        )

    def setstate(self, state) -> None:  # type: ignore[override]
        raise SimForbiddenError(
            "random.setstate() inside a simulation is not supported"
        )


def _sim_random_for(h) -> _SimRandom:
    """Per-Runtime _SimRandom: distribution methods carry internal state
    (e.g. gauss caches its pair) that must not leak across simulations."""
    sr = getattr(h, "_sim_random", None)
    if sr is None:
        sr = _SimRandom()
        h._sim_random = sr
    return sr


# module-level functions worth dispatching (bound methods of the hidden
# global Random instance in CPython)
_RANDOM_FNS = [
    "random", "uniform", "triangular", "randint", "choice", "randrange",
    "sample", "shuffle", "choices", "normalvariate", "lognormvariate",
    "expovariate", "vonmisesvariate", "gammavariate", "gauss", "betavariate",
    "paretovariate", "weibullvariate", "getrandbits", "randbytes", "seed",
]


def _make_random_patch(name: str):
    def make(orig):
        def patched(*args, **kwargs):
            h = _handle()
            if h is None:
                return orig(*args, **kwargs)
            return getattr(_sim_random_for(h), name)(*args, **kwargs)

        patched.__name__ = name
        return patched

    return make


def _make_urandom_patch(orig):
    def _patched_urandom(n: int) -> bytes:
        h = _handle()
        if h is None:
            return orig(n)
        return _rng_bytes(h, n)

    return _patched_urandom


def _make_random_class(orig):
    class _DispatchRandom(orig):
        """Replacement for `random.Random`: unseeded construction inside a
        sim is deterministic. CPython's `_random.Random.__new__` draws real
        entropy in C (not interceptable from Python), so reseed from the
        GlobalRng after."""

        def __init__(self, x=None) -> None:
            super().__init__(x)
            h = _handle()
            if x is None and h is not None:
                self.seed(int.from_bytes(_rng_bytes(h, 32), "little"))

    return _DispatchRandom


# ------------------------------------------------------------------ threads


def _make_thread_start_patch(orig):
    def _patched_thread_start(self: threading.Thread) -> None:
        if _handle() is not None:
            raise SimForbiddenError(
                "spawning a real thread inside a simulation breaks "
                "determinism (reference forbids pthread creation, "
                "task/mod.rs:753-769); use madsim_tpu_torch.spawn for "
                "concurrency"
            )
        return orig(self)

    return _patched_thread_start


def _make_asyncio_run_patch(orig):
    def _patched_asyncio_run(*args, **kwargs):
        if _handle() is not None:
            raise SimForbiddenError(
                "asyncio.run() inside a simulation would run a real event "
                "loop; madsim_tpu_torch IS the event loop — spawn tasks with "
                "madsim_tpu_torch.spawn"
            )
        return orig(*args, **kwargs)

    return _patched_asyncio_run


# ------------------------------------------------------------------ install


_TIME_FNS: List[Tuple[str, Callable[[Any], Any]]] = [
    ("time", lambda h: h.time.now_time()),
    ("time_ns", lambda h: h.time.now_time_ns()),
    ("monotonic", lambda h: h.time.elapsed()),
    ("monotonic_ns", lambda h: h.time.elapsed_ns()),
    ("perf_counter", lambda h: h.time.elapsed()),
    ("perf_counter_ns", lambda h: h.time.elapsed_ns()),
]


def _targets() -> List[Tuple[str, Any, str, Callable[[Any], Any]]]:
    """(key, owner, attribute, make_patch(replaced)) for every patch."""
    out: List[Tuple[str, Any, str, Callable[[Any], Any]]] = [
        (f"time.{name}", time_mod, name, _make_time_patch(name, fn))
        for name, fn in _TIME_FNS
    ]
    out.append(("time.sleep", time_mod, "sleep", _make_sleep_patch))
    out += [
        (f"random.{name}", random_mod, name, _make_random_patch(name))
        for name in _RANDOM_FNS
        if hasattr(random_mod, name)
    ]
    out.append(("os.urandom", os, "urandom", _make_urandom_patch))
    # SystemRandom / secrets bottom out in the module-captured urandom ref
    if hasattr(random_mod, "_urandom"):
        out.append(("random._urandom", random_mod, "_urandom",
                    _make_urandom_patch))
    # unseeded random.Random() seeds from real entropy in C; rebind the
    # class so in-sim construction reseeds deterministically
    out.append(("random.Random", random_mod, "Random", _make_random_class))
    out.append(("threading.Thread.start", threading.Thread, "start",
                _make_thread_start_patch))
    out.append(("asyncio.run", asyncio, "run", _make_asyncio_run_patch))
    # datetime.now/utcnow/today + date.today read the clock in C below
    # time.time; install dispatching subclasses as the module attributes
    out.append(("datetime.datetime", datetime_mod, "datetime",
                lambda _replaced: _SimDatetime))
    out.append(("datetime.date", datetime_mod, "date",
                lambda _replaced: _SimDate))
    return out


def install() -> None:
    """Patch the stdlib (idempotent). Dispatch is per-call on TLS context.

    Every attribute that does not hold this module's patch is (re)wrapped,
    whatever stands there: the stdlib's function or another interposer's
    patch, which the new patch then calls outside a port sim."""
    global _active
    _active = True
    for key, owner, attr, make in _targets():
        cur = getattr(owner, attr)
        done = _installed.get(key)
        if done is not None and cur is done[1]:
            continue
        patch = make(cur)
        _installed[key] = (cur, patch)
        setattr(owner, attr, patch)


def uninstall() -> None:
    """Restore every attribute that still holds this module's patch. A patch
    that another interposer has since wrapped cannot be lifted out of that
    chain: it stays, passing every call through (`_handle()` is None)."""
    global _active
    _active = False
    for key, owner, attr, _make in _targets():
        done = _installed.pop(key, None)
        if done is not None and getattr(owner, attr) is done[1]:
            setattr(owner, attr, done[0])
