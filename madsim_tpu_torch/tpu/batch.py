"""run_batch: whole seed sweeps as device batches.

The port of `madsim_tpu/tpu/batch.py`'s chunked sweep: every seed becomes a
lane of one BatchedSim batch (in chunks of `chunk` lanes), and the result
carries per-seed rows plus the batch summary. Violating seeds re-run on the
workload's host reproducer when it has one, and a workload's deep
`lane_check` oracle runs on the violating lanes plus a clean sample.
Traces, shrinking, coverage, refill, tuning and mesh sharding are later
slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .convert import state_to_numpy
from .engine import (
    BatchedSim, DEFAULT_DISPATCH_STEPS, SimState, _not_ported, summarize,
)
from .nemesis import coverage_report, enabled_fire_kinds
from .spec import ProtocolSpec, SimConfig

# lanes per device dispatch: bounds peak memory for huge sweeps
DEFAULT_CHUNK = 65_536


@dataclasses.dataclass(frozen=True)
class BatchWorkload:
    """A protocol's faces: the device spec, its config, and an optional
    host-runtime reproducer `host_repro(seed)` for violating seeds."""

    spec: ProtocolSpec
    config: Optional[SimConfig] = None
    host_repro: Optional[Callable[[int], Any]] = None
    max_steps: int = 100_000
    # optional deep oracle over recorded per-lane histories, run host-side
    # on every violating lane plus a clean sample (kv_workload wires the
    # exact per-key linearizability check here): lane_check(final chunk
    # state, lane indices) -> dict of integer counters incl. "violations"
    lane_check: Optional[Callable[[Any, Sequence[int]], dict]] = None
    lane_check_sample: int = 8


class BatchDeterminismError(AssertionError):
    """Two runs of the same seed batch diverged."""


def _assert_runs_bitwise_equal(a: SimState, b: SimState, context: str) -> None:
    la, lb = state_to_numpy(a), state_to_numpy(b)
    for i, (name, x) in enumerate(la.items()):
        if not np.array_equal(x, lb[name]):
            raise BatchDeterminismError(
                f"determinism check failed ({context}): state leaf {i} "
                f"({name}) of {len(la)} differs between two runs of the "
                "same seeds — the spec or backend is nondeterministic"
            )


@dataclasses.dataclass
class BatchResult:
    """Outcome of one batched sweep."""

    seeds: np.ndarray  # [L] the seeds that ran
    violated: np.ndarray  # [L] bool
    deadlocked: np.ndarray  # [L] bool
    summary: Dict[str, Any]
    state: SimState  # final engine state (chunked runs: last chunk only)
    host_repros: Dict[int, Any] = dataclasses.field(default_factory=dict)
    workload: Optional[BatchWorkload] = None
    # the sweep loop's wall time in ms (dispatch through the last readback)
    device_ms: float = 0.0
    # busy lane-steps / lane-steps, each chunk's denominator its longest
    # lane's step count
    occupancy: Optional[float] = None
    retired_step: Optional[np.ndarray] = None  # int32 [L] final step counts
    violation_step: Optional[np.ndarray] = None  # int32 [L] (-1 = none)

    @property
    def violations(self) -> int:
        return int(self.violated.sum())

    @property
    def violating_seeds(self) -> List[int]:
        return [int(s) for s in self.seeds[self.violated]]


def run_batch(
    seeds: Sequence[int],
    workload: BatchWorkload,
    repro_on_host: bool = True,
    max_host_repros: int = 4,
    chunk: Optional[int] = None,
    check_determinism: bool = False,
    dispatch_steps: Optional[int] = None,
    sim: Optional[BatchedSim] = None,
    device="cuda",
    refill: Optional[int] = None,
    mesh: Any = None,
) -> BatchResult:
    """Fuzz every seed as device lanes; re-run violating seeds on the host.

    `check_determinism` runs every chunk twice and compares the full final
    states leaf for leaf. `sim` passes a pre-built BatchedSim (it must be
    built for the workload's spec and config); `device` is used only when
    run_batch builds the sim. Per-seed results do not depend on `chunk`:
    no draw folds the lane index."""
    seeds_arr = np.asarray(list(seeds), dtype=np.uint32)
    if seeds_arr.ndim != 1 or seeds_arr.size == 0:
        raise ValueError("seeds must be a non-empty 1-D sequence")
    if refill:
        raise _not_ported("run_batch(refill=...)", "item 11")
    if mesh is not None:
        raise _not_ported("run_batch(mesh=...)", "item 14")
    chunk = DEFAULT_CHUNK if chunk is None else int(chunk)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if dispatch_steps is None:
        dispatch_steps = DEFAULT_DISPATCH_STEPS
    cfg = workload.config or SimConfig()
    if sim is None:
        sim = BatchedSim(workload.spec, cfg, device=device)
    elif sim.spec is not workload.spec or sim.config.hash() != cfg.hash():
        raise ValueError(
            "run_batch(sim=...) was built for a different (spec, config) "
            f"than the workload: sim runs {sim.spec.name!r} "
            f"cfg={sim.config.hash()[:12]} but the workload is "
            f"{workload.spec.name!r} cfg={cfg.hash()[:12]}"
        )

    violated_parts: List[np.ndarray] = []
    deadlocked_parts: List[np.ndarray] = []
    vstep_parts: List[np.ndarray] = []
    steps_parts: List[np.ndarray] = []
    occ_num = occ_den = 0
    state: Optional[SimState] = None
    totals: Dict[str, Any] = {}
    weights: Dict[str, int] = {}
    t_sweep = time.perf_counter()

    for off in range(0, seeds_arr.size, chunk):
        part = seeds_arr[off: off + chunk]
        st = sim.run(
            part, max_steps=workload.max_steps, dispatch_steps=dispatch_steps
        )
        if check_determinism:
            rerun = sim.run(
                part, max_steps=workload.max_steps,
                dispatch_steps=dispatch_steps,
            )
            _assert_runs_bitwise_equal(
                st, rerun, f"seeds[{off}:{off + part.size}]"
            )
        state = st
        violated_parts.append(st.violated.cpu().numpy())
        deadlocked_parts.append(st.deadlocked.cpu().numpy())
        vstep_parts.append(st.violation_step.cpu().numpy())
        chunk_steps = st.steps.cpu().numpy()
        steps_parts.append(chunk_steps)
        occ_num += int(chunk_steps.astype(np.int64).sum())
        occ_den += int(chunk_steps.max(initial=0)) * chunk_steps.shape[0]
        s = summarize(st, workload.spec)
        if workload.lane_check is not None:
            # deep host-side oracle: every violating lane + a clean sample
            v_lanes = np.nonzero(violated_parts[-1])[0]
            clean = np.nonzero(~violated_parts[-1])[0][
                : workload.lane_check_sample
            ]
            picked = np.concatenate([v_lanes, clean])
            if picked.size:
                for k2, v2 in workload.lane_check(st, picked).items():
                    if isinstance(v2, (int, np.integer)):
                        s["lane_check_" + k2] = int(v2)
        for k, v in s.items():
            if not isinstance(v, (int, float)):
                continue
            if k == "first_violation_step":
                totals[k] = min(totals.get(k, v), v)
            elif k.startswith("mean_"):
                totals[k] = totals.get(k, 0) + v * part.size
                weights[k] = weights.get(k, 0) + part.size
            else:
                totals[k] = totals.get(k, 0) + v
    for k, w in weights.items():
        totals[k] = totals[k] / w
    sweep_ms = (time.perf_counter() - t_sweep) * 1e3

    violated = np.concatenate(violated_parts)
    totals["violation_lanes"] = np.nonzero(violated)[0].tolist()[:32]
    totals["n_devices"] = 1
    if enabled_fire_kinds(cfg):
        totals["chaos_coverage"] = coverage_report(totals, cfg)
    totals["device_ms"] = round(sweep_ms, 3)
    occupancy = occ_num / occ_den if occ_den else 1.0
    totals["occupancy"] = round(occupancy, 4)
    result = BatchResult(
        seeds=seeds_arr,
        violated=violated,
        deadlocked=np.concatenate(deadlocked_parts),
        summary=totals,
        state=state,
        workload=workload,
        device_ms=sweep_ms,
        occupancy=occupancy,
        retired_step=np.concatenate(steps_parts),
        violation_step=np.concatenate(vstep_parts),
    )
    if repro_on_host and workload.host_repro is not None and result.violations:
        for seed in result.violating_seeds[:max_host_repros]:
            try:
                result.host_repros[seed] = workload.host_repro(seed)
            except BaseException as e:  # noqa: BLE001 - a raising repro IS a repro
                result.host_repros[seed] = e
    return result
