"""The measurement discipline, codified once: the port of
`madsim_tpu/measure.py`.

Every timing the port takes follows the same four rules:

  * FRESH SEEDS every timed rep, derived from the rep index — a repeated
    dispatch with the same inputs must never be what gets timed.
  * WARM THE EXACT TIMED PROGRAM — same shapes, same step count. The
    warmup runs the exact (shape, scan) chunk the timed reps run, so no
    first-call cost (allocator growth, lazy module loads, a card's first
    launch of a kernel) lands inside a timed rep.
  * MEDIANS OVER INTERLEAVED ROUNDS — a card and its host are shared and
    contention is bursty; interleaving variants within a round makes
    contention hit every variant alike, and the median drops one outlier
    either way.
  * SCAN ON DEVICE — time a chunk of steps, never one step's dispatch.

A result is blocked on by `_default_block`: it walks the result's tensors
(through NamedTuples, dicts, lists and tuples) and synchronizes each CUDA
device it finds; CPU tensors need no synchronization. Wall clocks here are
`time.perf_counter` only — measurement clocks never feed simulation state.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch


def fresh_seeds(rep: int, n: int, base: int = 0) -> np.ndarray:
    """The rep's seed block: `n` consecutive u32 seeds starting at
    `base + rep * n`. Pure function of the rep index — deterministic
    across processes, never equal across reps, which is the whole point
    (a cached dispatch must never be timed)."""
    rep, n = int(rep), int(n)
    if n <= 0:
        raise ValueError(f"seed block size must be positive, got {n}")
    return np.arange(base + rep * n, base + (rep + 1) * n, dtype=np.uint32)


def median(xs: Sequence[float]) -> float:
    """Median of a non-empty sequence (upper median for even lengths —
    matches the `sorted(walls)[len // 2]` idiom every bench used)."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("median of an empty sequence")
    return xs[len(xs) // 2]


def _cuda_devices(x: Any, found: set) -> None:
    """Collect the CUDA devices of every tensor inside `x`."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):  # NamedTuples are tuples
        for v in x:
            _cuda_devices(v, found)


def _default_block(x: Any) -> None:
    """Wait until the device work that produced `x` is done: synchronize
    each CUDA device holding one of its tensors. Nothing to wait for on
    the CPU, or for None."""
    if x is None:
        return
    found: set = set()
    _cuda_devices(x, found)
    for dev in sorted(found, key=str):
        torch.cuda.synchronize(dev)


def interleaved_medians(
    variants: Dict[str, Callable[[int], Any]],
    rounds: int = 3,
    rep_base: int = 1,
    block: Optional[Callable[[Any], None]] = None,
) -> Dict[str, float]:
    """Median wall seconds per variant over `rounds` INTERLEAVED rounds.

    Each round runs every variant once, in dict order, so bursty host or
    card contention lands on all variants alike instead of biasing
    whichever ran during the burst. Every call receives a globally
    unique rep index (fresh seeds downstream); the variant must run to
    readback (return a value to block on, or block itself)."""
    block = block or _default_block
    walls: Dict[str, list] = {name: [] for name in variants}
    rep = int(rep_base)
    for _ in range(int(rounds)):
        for name, fn in variants.items():
            t0 = time.perf_counter()
            block(fn(rep))
            walls[name].append(time.perf_counter() - t0)
            rep += 1
    return {name: median(w) for name, w in walls.items()}


def time_sweep(
    run: Callable[[np.ndarray], Any],
    lanes: int,
    rounds: int = 3,
    rep_base: int = 0,
    block: Optional[Callable[[Any], None]] = None,
):
    """(median wall seconds, last result) of `run(seeds)` whole sweeps.

    One warm rep runs the exact program (rep `rep_base`, untimed), then
    `rounds` timed reps on fresh seed blocks, median wall. `run` must
    return something blockable (e.g. the final SimState)."""
    block = block or _default_block
    state = run(fresh_seeds(rep_base, lanes))
    block(state)
    walls = []
    for r in range(1, int(rounds) + 1):
        t0 = time.perf_counter()
        state = run(fresh_seeds(rep_base + r, lanes))
        block(state)
        walls.append(time.perf_counter() - t0)
    return median(walls), state


def time_scan_ms(
    init: Callable[[np.ndarray], Any],
    run_steps: Callable[[Any, int], Any],
    lanes: int,
    scan: int = 300,
    warm_steps: int = 200,
    rounds: int = 3,
    rep_base: int = 0,
    block: Optional[Callable[[Any], None]] = None,
) -> float:
    """Median ms/step over `rounds` fresh-seed reps of a `scan`-step
    on-device chunk.

    The warmup runs BOTH programs this function will time against — the
    (shape, warm_steps) settle chunk and, critically, the exact
    (shape, scan) timed chunk — so nothing a first call pays lands in the
    first timed rep."""
    block = block or _default_block
    st = init(fresh_seeds(rep_base, lanes))
    if warm_steps > 0:
        st = run_steps(st, warm_steps)
    block(run_steps(st, scan))  # run the exact timed program once
    walls = []
    for r in range(1, int(rounds) + 1):
        st = init(fresh_seeds(rep_base + r, lanes))
        if warm_steps > 0:
            st = run_steps(st, warm_steps)
        block(st)
        t0 = time.perf_counter()
        block(run_steps(st, scan))
        walls.append((time.perf_counter() - t0) / scan * 1e3)
    return median(walls)


class SweepTimer:
    """`measure(assignment, rep) -> wall seconds` with the discipline
    baked in — a tuner's trial clock.

    `run(assignment, rep)` performs one sweep under the knob assignment,
    deriving its seeds from the rep index (`fresh_seeds`), and returns a
    value to block on (or blocks itself and returns None). The FIRST
    trial of each distinct `compile_key(assignment)` — the knob subset
    that changes shapes or step counts — runs an extra untimed warm rep
    of the exact program first, so no timed trial pays a first call.
    Timed reps must use rep indices disjoint from `warm_rep`.
    """

    def __init__(
        self,
        run: Callable[[Dict[str, Any], int], Any],
        compile_key: Callable[[Dict[str, Any]], Any] = lambda a: (),
        block: Optional[Callable[[Any], None]] = None,
        warm_rep: int = 0,
    ) -> None:
        self.run = run
        self.compile_key = compile_key
        self.block = block or _default_block
        self.warm_rep = int(warm_rep)
        self._warmed: set = set()

    def __call__(self, assignment: Dict[str, Any], rep: int) -> float:
        key = self.compile_key(assignment)
        if key not in self._warmed:
            self.block(self.run(assignment, self.warm_rep))
            self._warmed.add(key)
        t0 = time.perf_counter()
        self.block(self.run(assignment, int(rep)))
        return time.perf_counter() - t0
