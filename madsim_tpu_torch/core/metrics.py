"""Runtime metrics: task/node censuses for leak hunting
(reference madsim/src/sim/runtime/metrics.rs:6-40, task/mod.rs:142-160),
plus the host half of the chaos-coverage report: per-fault-kind nemesis
fire counts and named buggify fire counts (`chaos_fires`), mirroring the
device-side counters in `BatchResult.summary`.

`madsim_tpu_torch.telemetry.record_runtime_metrics(handle.metrics())` routes
everything here through the unified metrics registry (host_* gauges and
counters, chaos fires labeled `backend=host`) — see
docs/observability.md — or call `to_telemetry()` for the flat dict.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:
    from .task import Executor


class RuntimeMetrics:
    def __init__(self, executor: "Executor", handle=None) -> None:
        self._executor = executor
        self._handle = handle

    def to_telemetry(self) -> Dict[str, Any]:
        """This runtime's counters as one flat JSON-safe dict — the host
        analog of `BatchResult.summary` in the telemetry vocabulary."""
        return {
            "host_nodes": self.num_nodes(),
            "host_tasks": self.num_tasks(),
            "host_dispatches": self.dispatches,
            "host_device_ms": round(self.device_ms, 3),
            "host_occupancy": round(self.occupancy, 4),
            "chaos_fires": dict(sorted(self.chaos_fires().items())),
            "chaos_occ_fired": dict(
                sorted(self.chaos_occ_fired().items())
            ),
        }

    def num_nodes(self) -> int:
        return len(self._executor.nodes)

    def num_tasks(self) -> int:
        return sum(len(n.info.tasks) for n in self._executor.nodes.values())

    def num_tasks_by_node(self) -> Dict[int, int]:
        return {
            id: len(n.info.tasks)
            for id, n in sorted(self._executor.nodes.items())
            if n.info.tasks
        }

    def num_tasks_by_node_by_spawn(self) -> Dict[int, Dict[str, int]]:
        return {
            id: dict(n.info.spawn_counts)
            for id, n in sorted(self._executor.nodes.items())
            if n.info.spawn_counts
        }

    def num_tasks_of(self, node_id: int) -> int:
        node = self._executor.nodes.get(node_id)
        return len(node.info.tasks) if node else 0

    # -- sweep-overhead visibility (the host half of BatchResult's r6
    # `dispatches`/`device_ms` fields: one vocabulary for "what did the
    # execution machinery cost me" on both backends) --

    @property
    def dispatches(self) -> int:
        """Scheduling rounds the executor drained so far — the host
        runtime's analog of device program launches: each round is one
        ready-queue drain between virtual-time advances."""
        return self._executor.sched_rounds

    @property
    def device_ms(self) -> float:
        """Wall-clock ms spent inside the executor's run loop (task
        polls, not time-wheel bookkeeping) — what `BatchResult.device_ms`
        reports for a device sweep."""
        return self._executor.loop_busy_s * 1e3

    @property
    def occupancy(self) -> float:
        """Fraction of scheduling rounds that actually polled a task —
        the host runtime's counter behind `BatchResult.occupancy`'s
        busy-lane-steps / total-lane-steps (r9 continuous batching), so
        refill-vs-host comparisons stay apples-to-apples: both report
        "of the execution slots the machinery ran, how many did real
        work"."""
        ex = self._executor
        return ex.busy_rounds / max(ex.sched_rounds, 1)

    # -- chaos coverage (the nemesis / buggify fire registries) --

    def chaos_fires(self) -> Dict[str, int]:
        """Per-fault-kind fire counts for this run.

        Merges the NemesisDriver's schedule-event counts (crash/restart/
        partition/...), the NetSim message-coin counts (loss/dup/reorder),
        and named buggify points (as `buggify:<name>`). A clause or fault
        point listed in the plan but absent here (or zero) is a DEAD
        clause — it never exercised anything this run."""
        out: Dict[str, int] = {}
        handle = self._handle
        if handle is None:
            return out
        driver = getattr(handle, "nemesis", None)
        if driver is not None:
            out.update(driver.fire_counts())
        else:
            try:
                from ..net.netsim import NetSim

                net = handle.simulators.get(NetSim)
            except ImportError:
                net = None
            if net is not None:
                for kind, n in net.network.config.nemesis_fires.items():
                    out[kind] = out.get(kind, 0) + n
        for name, n in handle.rng.buggify_fires.items():
            out[f"buggify:{name}"] = out.get(f"buggify:{name}", 0) + n
        return out

    # -- causal lineage (the host half of the device lineage plane) --

    def lineage(self):
        """The runtime's HostLineage mirror (net/netsim.py): per-node
        Lamport clocks over the datagram delivery path, runtime-global
        event ids, and the (send_eid -> deliver_eid) edge list — the
        host face of `BatchedSim(lineage=True)`'s in-jit plane. OPT-IN
        like the device plane: call `.enable()` on the returned object
        BEFORE traffic starts (disabled runs retain nothing). Validate
        with `causal.check_host_lineage`; None when no NetSim exists."""
        handle = self._handle
        if handle is None:
            return None
        try:
            from ..net.netsim import NetSim

            net = handle.simulators.get(NetSim)
        except ImportError:
            return None
        return None if net is None else net.lineage

    def chaos_occ_fired(self) -> Dict[str, int]:
        """Per-clause OCCURRENCE fire bitmasks for this run (bit k set when
        window k of the schedule clause applied) — the host half of the
        chaos report's occurrence dimension. The device half is the
        engine's `occ_fired` tensor, surfaced as `occfires_<clause>_k<k>`
        summary keys; both index occurrences by `NemesisEvent.k`, so a twin
        test can compare the masks directly."""
        handle = self._handle
        driver = getattr(handle, "nemesis", None) if handle else None
        return dict(driver.occ_fired) if driver is not None else {}
