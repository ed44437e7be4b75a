"""run_batch: whole seed sweeps as device batches.

The port of `madsim_tpu/tpu/batch.py`: every seed becomes a lane of a
BatchedSim batch (in chunks of `chunk` lanes), or, with `refill=<lanes>`,
an admission of a continuously batched sweep over that many lanes (a lane
that finishes admits the next queued seed); either way the result carries
per-seed rows plus the batch summary, equal between the two paths. With
`coverage=True` it also carries each seed's coverage (`LaneCoverage`). A
workload's deep `lane_check` oracle runs on the violating lanes plus a
clean sample (chunked path only). After the sweep, the first violating
seed can be shrunk into a repro bundle (`shrink_on_violation`,
madsim_tpu_torch/triage.py), the first `max_traces` violating seeds re-run
traced (tpu/trace.py), and violating seeds re-run on the workload's host
reproducer when it has one. With telemetry enabled
(madsim_tpu_torch/telemetry.py), dispatch, decode and trace are spans,
the result is recorded, and each traced seed's timeline is written as a
Perfetto file into `telemetry.out_dir()`. `@batch_test` runs the env-configured seed
range as one sweep, the analog of `#[madsim::test]`. `mesh` (a
`tpu.mesh.Mesh`; "auto", the default as on the JAX face, is every visible
card, and unsharded on the CPU or one card) shards each chunk's lanes, or
each refill chunk's admission queue, over the mesh's devices; per-seed
rows do not depend on it.
`tuning="auto"` applies the device's measured Tier-A dispatch knobs
(madsim_tpu_torch/tune.py).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..testing import single_seed_repro_command
from .convert import state_to_numpy
from .engine import (
    BatchedSim, DEFAULT_DISPATCH_STEPS, ShardedState, SimState,
    refill_results, refill_results_sharded, summarize, summarize_refill,
)
from .mesh import Mesh, visible_devices
from .. import telemetry
from .nemesis import coverage_report, enabled_fire_kinds
from .spec import ProtocolSpec, SimConfig, tree_map

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


def twin_repro(fuzz: Callable[..., dict], violation: type,
               **kw) -> Callable[[int], dict]:
    """A workload's `host_repro` through a host twin: `fuzz(seed, **kw)`'s
    result dict with "violations" 0, or {"violations": 1, "violation":
    message} when it raises `violation` (the twin's InvariantViolation)."""

    def host_repro(seed: int) -> dict:
        try:
            out = fuzz(seed, **kw)
        except violation as e:
            return {"violations": 1, "violation": str(e)}
        out["violations"] = 0
        return out

    return host_repro


def popcount_rows(bitmaps: np.ndarray) -> np.ndarray:
    """Per-row set-bit counts of a u32 bitmap array [..., COV_WORDS] (a
    copy of `madsim_tpu/explore.py:popcount_rows`)."""
    return np.unpackbits(
        np.ascontiguousarray(bitmaps, np.uint32).view(np.uint8), axis=-1
    ).sum(axis=-1)


@dataclasses.dataclass
class LaneCoverage:
    """Per-seed coverage of a sweep (run_batch(coverage=True)), in seed
    order: each lane's event-class bitmap, its clause x occurrence fire
    words (None when no schedule clause is enabled), and the scalar
    features."""

    bitmap: np.ndarray  # u32 [L, engine.COV_WORDS]
    occ_fired: Optional[np.ndarray]  # u32 [L, len(OCC_CLAUSES)] | None
    hiwater: np.ndarray  # int32 [L]
    transitions: np.ndarray  # int32 [L]

    def union_bits(self) -> int:
        """Distinct event-class bits exercised across all lanes."""
        return int(popcount_rows(np.bitwise_or.reduce(self.bitmap, axis=0)))

    @classmethod
    def concat(cls, parts: Sequence[tuple]) -> "LaneCoverage":
        """Join per-chunk (bitmap, occ_fired, hiwater, transitions)."""
        cols = list(zip(*parts))
        return cls(*(None if c[0] is None else np.concatenate(c)
                     for c in cols))


class BatchDeterminismError(AssertionError):
    """Two runs of the same seed batch diverged."""


def _assert_runs_bitwise_equal(a, b, context: str) -> None:
    if isinstance(a, ShardedState):
        for d, (x, y) in enumerate(zip(a.shards, b.shards)):
            _assert_runs_bitwise_equal(x, y, f"{context}, shard {d}")
        return
    la, lb = state_to_numpy(a), state_to_numpy(b)
    for i, (name, x) in enumerate(la.items()):
        if not np.array_equal(x, lb[name]):
            raise BatchDeterminismError(
                f"determinism check failed ({context}): state leaf {i} "
                f"({name}) of {len(la)} differs between two runs of the "
                "same seeds — the spec or backend is nondeterministic"
            )


class BatchViolation(AssertionError):
    """Violations found in a batch; carries the repro seeds, the exact
    single-seed repro command and, after a shrink, the repro bundle's path
    and replay one-liner."""

    def __init__(
        self, seeds: List[int], detail: str,
        bundle_path: Optional[str] = None,
        bundle: Any = None,
    ) -> None:
        shown = ", ".join(str(s) for s in seeds[:16])
        more = "" if len(seeds) <= 16 else f" (+{len(seeds) - 16} more)"
        self.repro_command = single_seed_repro_command(seeds[0])
        self.bundle_path = bundle_path
        msg = (
            f"{len(seeds)} violating seed(s): {shown}{more}\n    {detail}\n"
            f"    reproduce one with: {self.repro_command}"
        )
        if bundle_path:
            msg += f"\n    shrunk repro bundle: {bundle_path}"
            if bundle is not None and not getattr(bundle, "spec_ref", None):
                # without a spec factory reference a fresh process cannot
                # rebuild the ProtocolSpec: say what is missing
                msg += (
                    f"\n    replay it with: python -m madsim_tpu_torch.repro "
                    f"{bundle_path} --spec-ref 'your.module:spec_factory' "
                    "(or pass spec_ref= in shrink_kwargs to bake it in)"
                )
            else:
                msg += (
                    f"\n    replay it with: "
                    f"python -m madsim_tpu_torch.repro {bundle_path}"
                )
        super().__init__(msg)
        self.seeds = seeds


@dataclasses.dataclass
class BatchResult:
    """Outcome of one batched sweep."""

    seeds: np.ndarray  # [L] the seeds that ran
    violated: np.ndarray  # [L] bool
    deadlocked: np.ndarray  # [L] bool
    summary: Dict[str, Any]
    state: SimState  # final engine state (chunked runs: last chunk only)
    host_repros: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # per-seed event traces of violating seeds (trace.TraceEvent lists)
    traces: Dict[int, list] = dataclasses.field(default_factory=dict)
    # the workload that ran (so .shrink() can build the triage sim), and
    # the repro bundle after run_batch(shrink_on_violation=True)
    workload: Optional[BatchWorkload] = None
    bundle: Any = None  # triage.ReproBundle | None
    bundle_path: Optional[str] = None
    # per-seed coverage (run_batch(coverage=True) only)
    coverage: Optional[LaneCoverage] = None
    # the sweep loop's wall time in ms (dispatch through the last readback)
    device_ms: float = 0.0
    # busy lane-steps / lane-steps: exact on the refill path (the engine's
    # counters); on the chunked path each chunk's denominator is its
    # longest lane's step count
    occupancy: Optional[float] = None
    # per seed: the step it retired at (refill: the sweep iteration;
    # chunked: the lane's own final step count) and its first violating
    # step (-1 = none)
    retired_step: Optional[np.ndarray] = None  # int32 [L]
    violation_step: Optional[np.ndarray] = None  # int32 [L]

    @property
    def violations(self) -> int:
        return int(self.violated.sum())

    @property
    def chaos_fires(self) -> Dict[str, int]:
        """Per-fault-kind fire counts over the whole batch (the device
        half of the chaos-coverage report)."""
        return {
            k[len("fires_"):]: v
            for k, v in self.summary.items()
            if k.startswith("fires_")
        }

    def chaos_report(self) -> str:
        """The rendered chaos-coverage line ('' when no chaos enabled)."""
        return self.summary.get("chaos_coverage", "")

    @property
    def violating_seeds(self) -> List[int]:
        return [int(s) for s in self.seeds[self.violated]]

    def shrink(self, seed: Optional[int] = None, **kwargs):
        """Shrink one violating seed (default: the first) into a minimal
        repro bundle (see triage.shrink_seed for the keywords), on the
        sweep's device unless `device=` says otherwise. Returns the
        ShrinkResult and remembers the bundle on this result."""
        from .. import triage

        if self.workload is None:
            raise ValueError(
                "this BatchResult carries no workload — run it through "
                "run_batch (or set result.workload) before shrinking"
            )
        if seed is None:
            if not self.violations:
                raise ValueError("no violating seeds to shrink")
            seed = self.violating_seeds[0]
        kwargs.setdefault("out_dir", triage.default_bundle_dir())
        kwargs.setdefault("device", self.state.device if isinstance(
            self.state, ShardedState) else self.state.clock.device)
        sr = triage.shrink_seed(self.workload, seed, **kwargs)
        self.bundle = sr.bundle
        self.bundle_path = sr.bundle_path
        return sr

    def raise_on_violation(self) -> None:
        if self.violations:
            raise BatchViolation(
                self.violating_seeds,
                f"summary: {self.summary}",
                bundle_path=self.bundle_path,
                bundle=self.bundle,
            )




def pipelined(items, dispatch, decode, serial: bool = False):
    """Double-buffered dispatch/decode loop, shared by run_batch and the
    shrinker: item k+1 is dispatched before entry k is decoded, so host
    decoding overlaps device work, and entries are decoded in item order,
    so any aggregation in `decode` equals the serial loop's. The first
    non-None value `decode` returns ends the loop (an in-flight entry is
    dropped undecoded) and is returned. `serial=True` decodes each entry
    right after its dispatch."""
    pending = None
    for item in items:
        entry = dispatch(item)
        if serial:
            hit = decode(entry)
            if hit is not None:
                return hit
        else:
            if pending is not None:
                hit = decode(pending)
                if hit is not None:
                    return hit
            pending = entry
    if pending is not None:
        return decode(pending)
    return None


def _fold_summary(totals: dict, weights: dict, s: dict, size: int) -> None:
    """Fold one chunk's summary into the sweep's totals: minima of first
    violation steps, maxima of high waters, lane-weighted means, sums of
    the rest (the refill occupancy is set once, after the loop)."""
    for k, v in s.items():
        if not isinstance(v, (int, float)) or k == "occupancy":
            continue
        if k == "first_violation_step":
            totals[k] = min(totals.get(k, v), v)
        elif k == "coverage_hiwater":
            totals[k] = max(totals.get(k, v), v)
        elif k.startswith("mean_"):
            totals[k] = totals.get(k, 0) + v * size
            weights[k] = weights.get(k, 0) + size
        else:
            totals[k] = totals.get(k, 0) + v


def _finish_totals(totals: dict, weights: dict, violated: np.ndarray,
                   cfg: SimConfig, occupancy: float, sweep_ms: float,
                   cov: Optional[LaneCoverage], n_devices: int) -> None:
    """The sweep-wide summary keys both paths add after their loop."""
    for k, w in weights.items():
        totals[k] = totals[k] / w
    totals["violation_lanes"] = np.nonzero(violated)[0].tolist()[:32]
    totals["n_devices"] = n_devices
    if enabled_fire_kinds(cfg):
        totals["chaos_coverage"] = coverage_report(totals, cfg)
    totals["device_ms"] = round(sweep_ms, 3)
    if cov is not None:
        # the union over all seeds (per-chunk counts would double-count
        # bits that chunks share)
        totals["coverage_bits"] = cov.union_bits()
    totals["occupancy"] = round(occupancy, 4)


def resolve_mesh(mesh, device="cuda") -> Optional[Mesh]:
    """Resolve `run_batch`'s, `shrink_seed`'s and `Federation`'s `mesh`
    argument, with the JAX face's rules: None runs unsharded; "auto" is a
    "seeds" mesh over every visible device of `device`'s type (each card
    for CUDA), unsharded when that is one device, and always on the CPU; a
    `Mesh` is used as is, even of size 1 (a sequence of devices is made
    one)."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be None, 'auto' or a Mesh, got "
                             f"{mesh!r}")
        devs = visible_devices(device)
        if torch.device(device).type != "cuda" or len(devs) <= 1:
            return None
        return Mesh(devs, "seeds")
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(mesh, "seeds")


def run_batch(
    seeds: Sequence[int],
    workload: BatchWorkload,
    repro_on_host: bool = True,
    max_host_repros: int = 4,
    chunk: Optional[int] = None,
    max_traces: int = 2,
    check_determinism: bool = False,
    shrink_on_violation: bool = False,
    shrink_kwargs: Optional[Dict[str, Any]] = None,
    pipeline: Optional[bool] = None,
    coverage: bool = False,
    refill: Optional[int] = None,
    dispatch_steps: Optional[int] = None,
    sim: Optional[BatchedSim] = None,
    device="cuda",
    mesh: Any = "auto",
    tuning: Any = None,
) -> BatchResult:
    """Fuzz every seed as device lanes; re-run violating seeds on the host.

    `check_determinism` runs every chunk twice and compares the full final
    states leaf for leaf. `shrink_on_violation` ddmin-shrinks the first
    violating seed into a repro bundle (triage.shrink_seed with
    `shrink_kwargs`; written under triage.default_bundle_dir() unless
    `out_dir` says otherwise) and reports it in BatchViolation; a failed
    shrink warns and keeps the sweep's result. The first `max_traces`
    violating seeds re-run traced into `result.traces`. `pipeline` (default
    on) dispatches chunk k+1 before decoding chunk k; results are those of
    the serial loop. `coverage` turns on the coverage plane: the result
    carries a `LaneCoverage` and the summary a `coverage_bits` union count.
    `refill=<lanes>` runs each chunk of seeds as the queue of one
    continuously batched sweep over that many lanes; every per-seed row
    equals the chunked path's, and `occupancy` is exact. A refill sweep
    keeps no per-seed final node state, so a workload with a `lane_check`
    must run chunked. `sim` passes a pre-built BatchedSim (built for the
    workload's spec and config, with the same coverage); `device` is used
    only when run_batch builds the sim. `mesh` resolves through
    `resolve_mesh`: each chunk's lanes (padded to a multiple of the mesh
    with repeats of its first seed, stripped after) or each refill chunk's
    queue (`refill` lanes per shard) split over its shards, and the
    summary's `n_devices` is its size. Per-seed results do not depend on
    `chunk`, `refill` or `mesh`: no draw folds the lane index. `tuning`
    ("auto", a Tier-A dict, a `tune.TunedEntry` or a saved entry's path)
    fills `chunk`, `dispatch_steps`, `pipeline` and `refill` where the
    caller left them None, from the tuned-config cache entry of the device
    the sweep runs on (an explicit `refill=0` pins the chunked path); a
    miss runs the defaults."""
    seeds_arr = np.asarray(list(seeds), dtype=np.uint32)
    if seeds_arr.ndim != 1 or seeds_arr.size == 0:
        raise ValueError("seeds must be a non-empty 1-D sequence")
    run_device = device if sim is None else sim.device
    if tuning is not None:
        # Tier-A dispatch knobs from the tuned-config cache, keyed by the
        # device this sweep runs on: a tuned value lands only where the
        # caller left the None sentinel (an explicit argument always wins,
        # even one equal to the default), and every knob is
        # result-invariant, so this is a throughput decision only
        from .. import tune as _tune

        tn = _tune.resolve_tuning(
            tuning, workload.spec.name, workload.config or SimConfig(),
            seeds_arr.size, device=run_device,
        )
        if "chunk" in tn and chunk is None:
            chunk = int(tn["chunk"])
        if "pipeline" in tn and pipeline is None:
            pipeline = bool(tn["pipeline"])
        if "dispatch_steps" in tn and dispatch_steps is None:
            dispatch_steps = int(tn["dispatch_steps"])
        if (
            "refill_lanes" in tn and refill is None
            and workload.lane_check is None
        ):
            refill = int(tn["refill_lanes"])
        if "devices" in tn and isinstance(mesh, str) and mesh == "auto":
            # an entry recorded on a bigger host of the same kind falls
            # back to the default mesh instead of failing the sweep
            mesh = _tune._mesh_for(tn["devices"], cached=True)
    mesh = resolve_mesh(mesh, run_device)
    n_dev = 1 if mesh is None else mesh.size
    chunk = DEFAULT_CHUNK if chunk is None else int(chunk)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    pipeline = True if pipeline is None else bool(pipeline)
    refill = int(refill or 0)
    if refill and workload.lane_check is not None:
        raise ValueError(
            "run_batch(refill=...) keeps no per-admission node state, so "
            "lane_check deep oracles cannot run — use the chunked path "
            "(refill=0) or strip the workload's lane_check"
        )
    if dispatch_steps is None:
        dispatch_steps = DEFAULT_DISPATCH_STEPS
    cfg = workload.config or SimConfig()
    if sim is None:
        sim = BatchedSim(workload.spec, cfg, coverage=coverage, device=device)
    elif sim.coverage != bool(coverage):
        raise ValueError(
            f"run_batch(coverage={coverage}) with a pre-built sim whose "
            f"coverage={sim.coverage} — build the sim to match"
        )
    elif sim.spec is not workload.spec or sim.config.hash() != cfg.hash():
        raise ValueError(
            "run_batch(sim=...) was built for a different (spec, config) "
            f"than the workload: sim runs {sim.spec.name!r} "
            f"cfg={sim.config.hash()[:12]} but the workload is "
            f"{workload.spec.name!r} cfg={cfg.hash()[:12]}"
        )
    if refill:
        return _run_batch_refill(
            seeds_arr, workload, sim, refill, chunk=chunk, mesh=mesh,
            pipeline=pipeline, coverage=coverage,
            check_determinism=check_determinism,
            repro_on_host=repro_on_host, max_host_repros=max_host_repros,
            max_traces=max_traces, shrink_on_violation=shrink_on_violation,
            shrink_kwargs=shrink_kwargs, dispatch_steps=dispatch_steps,
        )

    violated_parts: List[np.ndarray] = []
    deadlocked_parts: List[np.ndarray] = []
    vstep_parts: List[np.ndarray] = []
    steps_parts: List[np.ndarray] = []
    cov_parts: List[tuple] = []
    occ_num = occ_den = 0
    state: Optional[SimState] = None
    totals: Dict[str, Any] = {}
    weights: Dict[str, int] = {}
    t_sweep = time.perf_counter()

    def dispatch(off: int):
        part = seeds_arr[off: off + chunk]
        # a mesh takes a multiple of its size: pad with repeats of the
        # first seed, whose lanes run and are stripped in decode
        pad = (-part.size) % n_dev
        part_in = np.concatenate([part, np.repeat(part[:1], pad)])
        with telemetry.span("dispatch", site="run_batch", off=off):
            st = sim.run(
                part_in, max_steps=workload.max_steps,
                dispatch_steps=dispatch_steps, mesh=mesh,
            )
            rerun = sim.run(
                part_in, max_steps=workload.max_steps,
                dispatch_steps=dispatch_steps, mesh=mesh,
            ) if check_determinism else None
        return off, part.size, st, rerun

    def decode(entry) -> None:
        with telemetry.span("decode", site="run_batch", off=entry[0]):
            _decode(entry)

    def _decode(entry) -> None:
        nonlocal state, occ_num, occ_den
        off, size, st, rerun = entry
        if rerun is not None:
            _assert_runs_bitwise_equal(st, rerun, f"seeds[{off}:{off + size}]")
        if st.clock.shape[0] != size:
            st = tree_map(lambda x: x[:size], st)
        state = st
        violated_parts.append(st.violated.cpu().numpy())
        deadlocked_parts.append(st.deadlocked.cpu().numpy())
        vstep_parts.append(st.violation_step.cpu().numpy())
        chunk_steps = st.steps.cpu().numpy()
        steps_parts.append(chunk_steps)
        occ_num += int(chunk_steps.astype(np.int64).sum())
        occ_den += int(chunk_steps.max(initial=0)) * chunk_steps.shape[0]
        if coverage:
            cov_parts.append((
                st.cov.bitmap.cpu().numpy().astype(np.uint32),
                None if st.occ_fired is None
                else st.occ_fired.cpu().numpy().astype(np.uint32),
                st.cov.hiwater.cpu().numpy(),
                st.cov.transitions.cpu().numpy(),
            ))
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
        _fold_summary(totals, weights, s, size)

    pipelined(range(0, seeds_arr.size, chunk), dispatch, decode,
              serial=not pipeline)
    sweep_ms = (time.perf_counter() - t_sweep) * 1e3
    violated = np.concatenate(violated_parts)
    cov = LaneCoverage.concat(cov_parts) if coverage else None
    occupancy = occ_num / occ_den if occ_den else 1.0
    _finish_totals(totals, weights, violated, cfg, occupancy, sweep_ms, cov,
                   n_dev)
    result = BatchResult(
        seeds=seeds_arr,
        violated=violated,
        deadlocked=np.concatenate(deadlocked_parts),
        summary=totals,
        state=state,
        workload=workload,
        coverage=cov,
        device_ms=sweep_ms,
        occupancy=occupancy,
        retired_step=np.concatenate(steps_parts),
        violation_step=np.concatenate(vstep_parts),
    )
    return _post_sweep(result, sim, workload, shrink_on_violation,
                       shrink_kwargs, max_traces, repro_on_host,
                       max_host_repros)


def _post_sweep(
    result: BatchResult, sim: BatchedSim, workload: BatchWorkload,
    shrink_on_violation: bool, shrink_kwargs: Optional[Dict[str, Any]],
    max_traces: int, repro_on_host: bool, max_host_repros: int,
) -> BatchResult:
    """The tail both paths share: auto-triage, violation traces, the
    telemetry leg, host repros."""
    if result.violations and shrink_on_violation:
        # auto-triage of the first violating seed; a triage failure must
        # never eat the primary result (which seeds violated)
        try:
            result.shrink(**{"device": sim.device, **(shrink_kwargs or {})})
        except Exception as e:  # noqa: BLE001 - opt-in convenience step
            import warnings

            warnings.warn(
                f"shrink_on_violation failed ({type(e).__name__}: {e}); "
                "reporting the unshrunken violation",
                stacklevel=3,
            )
    if result.violations and max_traces > 0:
        # the microscope: the same step the sweep ran, one lane, traced
        from .trace import trace_seed

        for seed in result.violating_seeds[:max_traces]:
            with telemetry.span("trace", site="run_batch", seed=seed):
                result.traces[seed] = trace_seed(
                    sim, seed, max_steps=workload.max_steps,
                    kind_names=workload.spec.msg_kind_names,
                )
    if telemetry.enabled():
        # observe-only: the sweep is finished; this reads host-side numbers
        # and the traced TraceEvent streams only
        telemetry.record_batch_result(result, workload=workload.spec.name)
        tdir = telemetry.out_dir()
        if tdir is not None:
            for seed, events in result.traces.items():
                telemetry.write_perfetto(
                    os.path.join(
                        tdir,
                        f"{workload.spec.name}-seed{seed}.perfetto.json",
                    ),
                    events, n_nodes=workload.spec.n_nodes,
                    label=f"{workload.spec.name} seed {seed}",
                )
    if repro_on_host and workload.host_repro is not None and result.violations:
        for seed in result.violating_seeds[:max_host_repros]:
            try:
                result.host_repros[seed] = workload.host_repro(seed)
            except BaseException as e:  # noqa: BLE001 - a raising repro IS a repro
                result.host_repros[seed] = e
    return result


def _run_batch_refill(
    seeds_arr: np.ndarray, workload: BatchWorkload, sim: BatchedSim,
    lanes: int, chunk: int, mesh: Optional[Mesh], pipeline: bool,
    coverage: bool, check_determinism: bool, repro_on_host: bool,
    max_host_repros: int,
    max_traces: int, shrink_on_violation: bool,
    shrink_kwargs: Optional[Dict[str, Any]],
    dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
) -> BatchResult:
    """run_batch's continuously batched sweep: each `chunk` of seeds is the
    queue of one `run_refill` over `lanes` lanes, or with a mesh of one
    `run_refill_sharded` over `lanes` lanes per shard, dispatched through
    the same `pipelined` loop as the chunked path; rows are decoded in
    admission (= seed) order."""
    if lanes < 1:
        raise ValueError(f"refill lane count must be >= 1, got {lanes}")
    n_dev = 1 if mesh is None else mesh.size
    dev_busy = [0] * n_dev
    dev_total = [0] * n_dev
    res_parts: List[dict] = []
    totals: Dict[str, Any] = {}
    weights: Dict[str, int] = {}
    occ_num = occ_den = 0
    state: Optional[SimState] = None
    t_sweep = time.perf_counter()

    def run_part(part: np.ndarray):
        if mesh is not None:
            return sim.run_refill_sharded(
                part, lanes=lanes, mesh=mesh, max_steps=workload.max_steps,
                dispatch_steps=dispatch_steps)
        return sim.run_refill(part, lanes=lanes, max_steps=workload.max_steps,
                              dispatch_steps=dispatch_steps)

    def dispatch(off: int):
        part = seeds_arr[off: off + chunk]
        with telemetry.span("dispatch", site="run_batch_refill", off=off):
            st = run_part(part)
            rerun = run_part(part) if check_determinism else None
        return off, part.size, st, rerun

    def decode(entry) -> None:
        with telemetry.span("decode", site="run_batch_refill",
                            off=entry[0]):
            _decode(entry)

    def _decode(entry) -> None:
        nonlocal state, occ_num, occ_den
        off, size, st, rerun = entry
        if rerun is not None:
            _assert_runs_bitwise_equal(
                st, rerun, f"seeds[{off}:{off + size}] (refill)"
            )
        state = st
        if mesh is not None:
            res = refill_results_sharded(st, admissions=size)
            for d, row in enumerate(res["per_device"]):
                dev_busy[d] += row["busy_lane_steps"]
                dev_total[d] += row["total_lane_steps"]
        else:
            res = refill_results(st)
        res_parts.append(res)
        occ_num += res["busy_lane_steps"]
        occ_den += res["total_lane_steps"]
        _fold_summary(totals, weights, summarize_refill(res), size)

    pipelined(range(0, seeds_arr.size, chunk), dispatch, decode,
              serial=not pipeline)
    sweep_ms = (time.perf_counter() - t_sweep) * 1e3

    def rows(f):
        return np.concatenate([r[f] for r in res_parts])

    violated = rows("violated")
    cov = LaneCoverage.concat([
        (r["cov_bitmap"], r["occ_fired"], r["cov_hiwater"],
         r["cov_transitions"]) for r in res_parts
    ]) if coverage else None
    occupancy = occ_num / occ_den if occ_den else 1.0
    cfg = workload.config or SimConfig()
    _finish_totals(totals, weights, violated, cfg, occupancy, sweep_ms, cov,
                   n_dev)
    totals["refill_lanes"] = lanes
    if mesh is not None:
        totals["per_device_occupancy"] = [
            round(dev_busy[d] / max(dev_total[d], 1), 4)
            for d in range(n_dev)
        ]
    result = BatchResult(
        seeds=seeds_arr,
        violated=violated,
        deadlocked=rows("deadlocked"),
        summary=totals,
        state=state,
        workload=workload,
        coverage=cov,
        device_ms=sweep_ms,
        occupancy=occupancy,
        retired_step=rows("retired"),
        violation_step=rows("violation_step"),
    )
    return _post_sweep(result, sim, workload, shrink_on_violation,
                       shrink_kwargs, max_traces, repro_on_host,
                       max_host_repros)


def batch_test(
    workload: BatchWorkload,
    default_num: int = 1024,
    expect_violations: bool = False,
    shrink_on_violation: bool = False,
    shrink_kwargs: Optional[Dict[str, Any]] = None,
    device="cuda",
):
    """Decorator: run the env-configured seed range as one sweep on
    `device` and pass the BatchResult to the test.

        MADSIM_TEST_SEED               first seed (default 0)
        MADSIM_TEST_NUM                seeds to sweep (default `default_num`)
        MADSIM_TEST_TIME_LIMIT         virtual-time limit in seconds
                                       (overrides the workload's horizon)
        MADSIM_TEST_CONFIG             path to a TOML file of SimConfig
                                       fields laid over the workload's
        MADSIM_TEST_CHECK_DETERMINISM  run every chunk twice + compare

    Unless `expect_violations`, a violation raises BatchViolation with the
    repro seeds (and the bundle, when `shrink_on_violation`).

        @batch_test(raft_workload(), device="cpu")
        def test_fuzz(result): ...
    """

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            env = os.environ
            first = int(env.get("MADSIM_TEST_SEED", "0"))
            num = int(env.get("MADSIM_TEST_NUM", str(default_num)))
            check = env.get("MADSIM_TEST_CHECK_DETERMINISM", "") in (
                "1", "true", "TRUE",
            )
            wl = workload
            overrides: Dict[str, Any] = {}
            if "MADSIM_TEST_TIME_LIMIT" in env:
                overrides["horizon_us"] = int(
                    float(env["MADSIM_TEST_TIME_LIMIT"]) * 1e6
                )
            if "MADSIM_TEST_CONFIG" in env:
                from .spec import simconfig_dict_from_toml

                with open(env["MADSIM_TEST_CONFIG"], encoding="utf-8") as f:
                    overrides.update(simconfig_dict_from_toml(
                        f.read(), context="MADSIM_TEST_CONFIG"
                    ))
            if overrides:
                wl = dataclasses.replace(wl, config=dataclasses.replace(
                    wl.config or SimConfig(), **overrides
                ))
            result = run_batch(
                range(first, first + num), wl, check_determinism=check,
                shrink_on_violation=shrink_on_violation,
                shrink_kwargs=shrink_kwargs, device=device,
            )
            if not expect_violations:
                result.raise_on_violation()
            return fn(result, *args, **kwargs)

        # pytest reads the signature of __wrapped__ and would ask for a
        # fixture named after the injected first parameter: advertise the
        # signature without it
        del wrapper.__wrapped__
        sig = inspect.signature(fn)
        wrapper.__signature__ = sig.replace(  # type: ignore[attr-defined]
            parameters=list(sig.parameters.values())[1:]
        )
        return wrapper

    return deco
