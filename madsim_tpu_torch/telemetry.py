"""Telemetry: unified metrics, virtual-time Perfetto timelines, farm status.

The port of `madsim_tpu/telemetry.py`, copied whole (the port imports
nothing of the JAX package). Every layer of the fuzz stack counts things —
`BatchResult.summary` dicts, the nemesis chaos-coverage report, explorer
coverage curves, shrink progress — and this module is their one shared
vocabulary. Three faces:

  * **Metrics registry** — typed counters/gauges/histograms with labels,
    one versioned line-JSON event schema (``madsim-tpu-telemetry/1``, the
    JAX face's), and two sinks: an append-only JSONL stream and Prometheus
    textfile exposition. `record_*` helpers route every existing counter
    through it (batch summaries, chaos coverage, explorer curves, shrink
    progress, causal digests, campaign slices).
  * **Timelines** — Chrome-trace/Perfetto JSON from (a) the virtual-time
    `TraceEvent` stream a traced replay extracts (one track per node,
    deliveries as flow events src→dst, chaos windows as duration slices,
    the violation as an instant marker) and (b) wall-clock spans of the
    fuzz loop itself (``with telemetry.span("dispatch"): ...`` around
    dispatch/decode/trace/shrink), so pipelined overlap is *visible*.
  * **Farm status** — a status document + a metrics textfile, written
    atomically; ``python -m madsim_tpu_torch.telemetry tail|render`` reads
    either surface.

Telemetry is OBSERVE-ONLY and off by default. All capture happens at host
boundaries (after a dispatch returns, inside a decode that already reads
the card), never inside the engine's step, and a span adds no host read
or device sync: explorer fingerprints and digests are bit-identical with
telemetry on and off. Timestamps are `time.perf_counter` offsets, never
wall-clock. Every output (Prometheus text, event lines, Perfetto JSON of
the same trace) equals the JAX face's byte for byte
(tests/test_torch_telemetry.py).

    import madsim_tpu_torch.telemetry as telemetry
    reg = telemetry.enable(out_dir="/tmp/telem")   # events.jsonl lives here
    ... run sweeps / explorers ...
    telemetry.write_spans_perfetto("/tmp/telem/loop.perfetto.json")
    telemetry.disable()
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

TELEMETRY_FORMAT = "madsim-tpu-telemetry/1"
FARM_STATUS_FORMAT = "madsim-tpu-farm-status/1"

# every event kind the /1 schema admits, with its required payload keys
# (beyond the envelope: format, kind, name, seq, labels)
EVENT_KINDS: Dict[str, Tuple[str, ...]] = {
    "counter": ("value",),
    "gauge": ("value",),
    "histogram": ("value",),
    "span": ("t0_s", "dur_s"),
}

# prometheus metric/label name restrictions are stricter than ours
_PROM_BAD = str.maketrans({c: "_" for c in ".-/ :"})


def _prom_escape(v: str) -> str:
    """Exposition-format label-VALUE escaping (`\\` -> `\\\\`, `"` ->
    `\\"`, newline -> `\\n`): campaign ids come from user-supplied
    request files, and one bad value must not poison the whole scrape."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )

# span-duration histogram buckets (seconds): dispatch latencies span
# microseconds (no-op segments) to minutes (cold compiles)
SPAN_BUCKETS = (
    0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0,
)

# bound on retained span records: a week-long campaign must not grow host
# memory without bound; overflow is counted, never silent
MAX_SPANS = 200_000


def _canon_labels(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# --------------------------------------------------------------------------
# instruments
# --------------------------------------------------------------------------


class _Instrument:
    """Shared label-set plumbing: one value cell per canonical label set.

    Each instrument carries its OWN cell lock (never the registry's —
    `_emit` acquires that one, so reusing it here would deadlock):
    `serve`'s per-device threads update cells concurrently."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", registry=None) -> None:
        self.name = name
        self.help = help
        self._registry = registry
        self._cells: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = threading.Lock()

    def _emit(self, value: float, labels: Dict[str, Any]) -> None:
        if self._registry is not None:
            self._registry._event(self.kind, self.name, value, labels)

    def labelsets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(ls) for ls in sorted(self._cells)]

    def _cells_snapshot(self) -> Dict[Tuple[Tuple[str, str], ...], Any]:
        """Consistent copy for exposition (histogram cells deep enough
        that a concurrent observe can't tear the rendered numbers)."""
        with self._lock:
            return {
                ls: dict(c, buckets=list(c["buckets"]))
                if isinstance(c, dict) else c
                for ls, c in self._cells.items()
            }


class Counter(_Instrument):
    """Monotone count (fires, dispatches, violations...)."""

    kind = "counter"

    def inc(self, value: float = 1, **labels: Any) -> None:
        ls = _canon_labels(labels)
        with self._lock:
            self._cells[ls] = self._cells.get(ls, 0) + value
        self._emit(value, labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._cells.get(_canon_labels(labels), 0)


class Gauge(_Instrument):
    """Point-in-time level (occupancy, queue depth, corpus size...)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._cells[_canon_labels(labels)] = value
        self._emit(value, labels)

    def value(self, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._cells.get(_canon_labels(labels))


class Histogram(_Instrument):
    """Bucketed distribution (span durations, device_ms...)."""

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "", registry=None,
        buckets: Sequence[float] = SPAN_BUCKETS,
    ) -> None:
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels: Any) -> None:
        ls = _canon_labels(labels)
        with self._lock:
            cell = self._cells.get(ls)
            if cell is None:
                cell = self._cells[ls] = {
                    "count": 0, "sum": 0.0,
                    "buckets": [0] * (len(self.buckets) + 1),
                }
            cell["count"] += 1
            cell["sum"] += value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    cell["buckets"][i] += 1
                    break
            else:
                cell["buckets"][-1] += 1
        self._emit(value, labels)

    def snapshot(self, **labels: Any) -> Optional[Dict[str, Any]]:
        with self._lock:
            cell = self._cells.get(_canon_labels(labels))
            if cell is None:
                return None
            return {
                "count": cell["count"], "sum": cell["sum"],
                "buckets": list(cell["buckets"]),
            }


# --------------------------------------------------------------------------
# the registry + sinks
# --------------------------------------------------------------------------


class MetricsRegistry:
    """Named instruments + the two sinks (JSONL events, prom textfile).

    Thread-safe: `campaign serve` updates it from one thread per device.
    Instruments are create-once (re-asking by name returns the same
    object; a kind mismatch is a loud error, never a silent shadow).
    """

    def __init__(self, jsonl_path: Optional[str] = None) -> None:
        self._metrics: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()
        self._jsonl_path = jsonl_path
        self._seq = 0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------- instruments

    def _get(self, cls, name: str, help: str, **kw) -> _Instrument:
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = cls(
                    name, help, registry=self, **kw
                )
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: Sequence[float] = SPAN_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # ------------------------------------------------------------- events

    def _write_line(self, doc: Dict[str, Any]) -> None:
        """Append one event line OUTSIDE the registry lock: the seq was
        reserved under it, and a single O_APPEND write keeps lines whole,
        so concurrent device threads never queue behind each other's file
        I/O (lines may land slightly out of seq order; `seq` is the
        consumer's total order)."""
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(doc, sort_keys=True) + "\n")

    def _event(
        self, kind: str, name: str, value: float, labels: Dict[str, Any]
    ) -> None:
        if self._jsonl_path is None:
            return
        with self._lock:
            seq = self._seq
            self._seq += 1
        self._write_line({
            "format": TELEMETRY_FORMAT,
            "kind": kind,
            "name": name,
            "value": value,
            "labels": {str(k): str(v) for k, v in sorted(labels.items())},
            "seq": seq,
            "t_rel_s": round(time.perf_counter() - self._t0, 6),
        })

    def span_event(self, rec: "SpanRecord") -> None:
        if self._jsonl_path is None:
            return
        with self._lock:
            seq = self._seq
            self._seq += 1
        self._write_line({
            "format": TELEMETRY_FORMAT,
            "kind": "span",
            "name": rec.name,
            "t0_s": round(rec.t0_s, 6),
            "dur_s": round(rec.dur_s, 6),
            "labels": {k: str(v) for k, v in sorted(rec.labels.items())},
            "seq": seq,
            "thread": rec.thread,
        })

    # ----------------------------------------------------------- textfile

    def to_prom(self) -> str:
        """Prometheus textfile exposition of every instrument's cells."""
        lines: List[str] = []
        with self._lock:
            metrics = dict(self._metrics)
        for name in sorted(metrics):
            inst = metrics[name]
            pname = "madsim_" + name.translate(_PROM_BAD)
            if inst.help:
                lines.append(f"# HELP {pname} {inst.help}")
            ptype = {
                "counter": "counter", "gauge": "gauge",
                "histogram": "histogram",
            }[inst.kind]
            lines.append(f"# TYPE {pname} {ptype}")
            cells = inst._cells_snapshot()
            for ls in sorted(cells):
                lbl = ",".join(
                    f'{k.translate(_PROM_BAD)}="{_prom_escape(v)}"'
                    for k, v in ls
                )
                cell = cells[ls]
                if inst.kind in ("counter", "gauge"):
                    suffix = "_total" if inst.kind == "counter" else ""
                    lines.append(
                        f"{pname}{suffix}{{{lbl}}} {_num(cell)}"
                        if lbl else f"{pname}{suffix} {_num(cell)}"
                    )
                else:
                    cum = 0
                    for i, b in enumerate(inst.buckets):
                        cum += cell["buckets"][i]
                        le = ([f'le="{b}"'] + ([lbl] if lbl else []))
                        lines.append(
                            f"{pname}_bucket{{{','.join(le)}}} {cum}"
                        )
                    cum += cell["buckets"][-1]
                    inf = (['le="+Inf"'] + ([lbl] if lbl else []))
                    lines.append(f"{pname}_bucket{{{','.join(inf)}}} {cum}")
                    tail = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{pname}_sum{tail} {_num(cell['sum'])}")
                    lines.append(f"{pname}_count{tail} {cell['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_textfile(self, path: str) -> str:
        return _atomic_write(path, self.to_prom())


def _num(v: Any) -> str:
    if isinstance(v, float):
        return repr(round(v, 9))
    return str(v)


def _atomic_write(path: str, text: str) -> str:
    """tmp + os.replace: a scraper never reads a torn file."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def parse_event(line: str) -> Dict[str, Any]:
    """Parse + validate one ``madsim-tpu-telemetry/1`` JSONL event line.

    Raises ValueError on schema violations — the round-trip test and
    `telemetry tail --validate` both go through here.
    """
    doc = json.loads(line)
    if not isinstance(doc, dict):
        raise ValueError("event is not a JSON object")
    if doc.get("format") != TELEMETRY_FORMAT:
        raise ValueError(
            f"unknown telemetry format {doc.get('format')!r} "
            f"(expected {TELEMETRY_FORMAT})"
        )
    kind = doc.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {kind!r}")
    for key in ("name", "seq", "labels") + EVENT_KINDS[kind]:
        if key not in doc:
            raise ValueError(f"{kind} event missing required key {key!r}")
    if not isinstance(doc["labels"], dict):
        raise ValueError("labels must be an object")
    return doc


def read_events(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(parse_event(line))
    return out


# --------------------------------------------------------------------------
# module state + the span API
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SpanRecord:
    name: str
    t0_s: float  # perf_counter offset from enable()
    dur_s: float
    thread: str
    labels: Dict[str, Any]


class _TelemetryState:
    def __init__(self) -> None:
        self.enabled = False
        self.registry: Optional[MetricsRegistry] = None
        self.out_dir: Optional[str] = None
        self.spans: List[SpanRecord] = []
        self.spans_dropped = 0
        self.t0 = 0.0
        self.lock = threading.Lock()


_STATE = _TelemetryState()


def enabled() -> bool:
    return _STATE.enabled


def get_registry() -> Optional[MetricsRegistry]:
    return _STATE.registry


def out_dir() -> Optional[str]:
    return _STATE.out_dir


def enable(
    out_dir: Optional[str] = None, registry: Optional[MetricsRegistry] = None,
) -> MetricsRegistry:
    """Turn capture on. With `out_dir`, events stream to
    ``<out_dir>/events.jsonl`` and traced-violation timelines land there
    too; without it everything stays in memory. Idempotent-ish: a second
    enable replaces the state (spans reset)."""
    jsonl = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        jsonl = os.path.join(out_dir, "events.jsonl")
    st = _STATE
    st.registry = registry or MetricsRegistry(jsonl_path=jsonl)
    st.out_dir = out_dir
    st.spans = []
    st.spans_dropped = 0
    st.t0 = time.perf_counter()
    st.enabled = True
    return st.registry


def disable() -> None:
    _STATE.enabled = False
    _STATE.registry = None
    _STATE.out_dir = None


class _NoopSpan:
    """The disabled-path span: one shared instance, nothing captured."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "labels", "_t0")

    def __init__(self, name: str, labels: Dict[str, Any]) -> None:
        self.name = name
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        st = _STATE
        if not st.enabled:
            return False
        t1 = time.perf_counter()
        rec = SpanRecord(
            name=self.name,
            t0_s=self._t0 - st.t0,
            dur_s=t1 - self._t0,
            thread=threading.current_thread().name,
            labels=self.labels,
        )
        with st.lock:
            if len(st.spans) < MAX_SPANS:
                st.spans.append(rec)
            else:
                st.spans_dropped += 1
        reg = st.registry
        if reg is not None:
            reg.histogram(
                "span_seconds", "wall-clock span durations by site"
            ).observe(rec.dur_s, site=self.name)
            reg.span_event(rec)
        return False


def span(name: str, **labels: Any):
    """Wall-clock span context manager (no-op singleton when disabled).

    The fuzz loop's sites — dispatch, decode, checkpoint, shrink, merge,
    slice — wrap their host-side bodies in this. Spans never run inside
    the engine's step and never touch simulation state or the card; they
    only read the monotonic clock (`time.perf_counter`) and append to a
    host-side list.
    """
    if not _STATE.enabled:
        return _NOOP_SPAN
    return _Span(name, labels)


def spans() -> List[SpanRecord]:
    with _STATE.lock:
        return list(_STATE.spans)


# --------------------------------------------------------------------------
# routing: the existing counters, through one vocabulary
# --------------------------------------------------------------------------


def record_summary(summary: Dict[str, Any], **labels: Any) -> None:
    """Route one sweep summary (BatchResult.summary / summarize() dict)
    into the registry: scalar totals as counters, rates/levels as gauges,
    chaos fires (per clause AND per occurrence) as labeled counters."""
    reg = _STATE.registry
    if reg is None:
        return
    for key in ("lanes", "violations", "deadlocked", "total_events",
                "total_overflow", "total_dead_drops", "dispatches"):
        if key in summary:
            reg.counter(f"sweep_{key}", f"sweep {key} total").inc(
                int(summary[key]), **labels
            )
    if "device_ms" in summary:
        reg.counter("sweep_device_ms", "sweep wall ms (dispatch→decode)") \
            .inc(float(summary["device_ms"]), **labels)
    for key in ("occupancy", "coverage_bits", "first_violation_step"):
        if key in summary and isinstance(summary[key], (int, float)):
            reg.gauge(f"sweep_{key}", f"sweep {key}").set(
                float(summary[key]), **labels
            )
    fires = reg.counter(
        "chaos_fires", "nemesis fault-clause fires by kind"
    )
    for key, v in summary.items():
        if key.startswith("fires_"):
            fires.inc(int(v), clause=key[len("fires_"):], **labels)
    occ = reg.counter(
        "chaos_occurrence_lanes",
        "lanes in which occurrence k of a schedule clause applied",
    )
    for row in chaos_rows(summary):
        occ.inc(row["lanes"], clause=row["clause"], k=row["k"], **labels)


def record_batch_result(result, **labels: Any) -> None:
    """BatchResult → registry (summary scalars ride through
    record_summary; occupancy/dispatches/device_ms are summary keys)."""
    if _STATE.registry is None:
        return
    record_summary(result.summary, **labels)


def chaos_rows(summary: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The nemesis per-occurrence fire counts as STABLE-ORDER rows.

    Row schema (the JAX face's docs/nemesis.md "Occurrence rows", held
    equal by tests/test_torch_telemetry.py):
    ``{"clause": str, "k": int, "lanes": int}``
    with that exact key order, rows ordered by clause in
    ``nemesis.OCC_CLAUSES`` registry order then by ascending occurrence
    index k. This is the serialization contract for every sink that
    carries the chaos-coverage occurrence dimension.
    """
    from .nemesis import OCC_CLAUSES
    from .tpu.nemesis import occurrence_fires

    occ = occurrence_fires(summary)
    rows: List[Dict[str, Any]] = []
    for clause in OCC_CLAUSES:
        for k in sorted(occ.get(clause, ())):
            rows.append(
                {"clause": clause, "k": k, "lanes": int(occ[clause][k])}
            )
    return rows


def record_runtime_metrics(metrics, **labels: Any) -> None:
    """Host `RuntimeMetrics` → registry: task/node censuses, scheduling
    occupancy, dispatch rounds, loop wall, chaos fires + occurrence masks
    — the host half of the sweep vocabulary."""
    reg = _STATE.registry
    if reg is None:
        return
    reg.gauge("host_nodes", "host runtime node census").set(
        metrics.num_nodes(), **labels
    )
    reg.gauge("host_tasks", "host runtime task census").set(
        metrics.num_tasks(), **labels
    )
    reg.gauge("host_occupancy", "host scheduling-round occupancy").set(
        metrics.occupancy, **labels
    )
    reg.counter("host_dispatches", "host executor scheduling rounds").inc(
        metrics.dispatches, **labels
    )
    reg.counter("host_device_ms", "host executor loop wall ms").inc(
        metrics.device_ms, **labels
    )
    fires = reg.counter("chaos_fires", "nemesis fault-clause fires by kind")
    for kind, n in sorted(metrics.chaos_fires().items()):
        fires.inc(n, clause=kind, backend="host", **labels)
    occ = reg.counter(
        "chaos_occurrence_lanes",
        "lanes in which occurrence k of a schedule clause applied",
    )
    for clause, mask in sorted(metrics.chaos_occ_fired().items()):
        k = 0
        m = int(mask)
        while m:
            if m & 1:
                occ.inc(1, clause=clause, k=k, backend="host", **labels)
            m >>= 1
            k += 1


def record_explore_report(report, **labels: Any) -> None:
    """ExploreReport → registry: coverage/corpus/violation curve heads,
    seeds run, device dispatches — the explorer's per-generation stats."""
    reg = _STATE.registry
    if reg is None:
        return
    reg.gauge("explore_coverage_bits", "coverage-union popcount").set(
        report.coverage_bits, **labels
    )
    reg.gauge("explore_corpus_size", "novelty-ranked corpus entries").set(
        report.corpus_size, **labels
    )
    reg.gauge("explore_violations", "unique violations found").set(
        len(report.violations), **labels
    )
    reg.gauge("explore_generations", "explorer generations run").set(
        report.dispatches, **labels
    )
    reg.gauge("explore_seeds_run", "cumulative candidate lane-runs").set(
        report.seeds_run, **labels
    )
    reg.gauge("explore_device_dispatches", "device program launches").set(
        report.device_dispatches, **labels
    )


def record_explore_generation(ex, **labels: Any) -> None:
    """One finished Explorer generation → registry (the cheap per-slice
    face of record_explore_report: curve heads only, no corpus digest)."""
    reg = _STATE.registry
    if reg is None:
        return
    labels = {"meta_seed": ex.meta_seed, **labels}
    reg.gauge("explore_coverage_bits", "coverage-union popcount").set(
        ex.coverage_curve[-1] if ex.coverage_curve else 0, **labels
    )
    reg.gauge("explore_corpus_size", "novelty-ranked corpus entries").set(
        len(ex.corpus), **labels
    )
    reg.gauge("explore_violations", "unique violations found").set(
        len(ex.violations), **labels
    )
    reg.gauge("explore_generations", "explorer generations run").set(
        len(ex.coverage_curve), **labels
    )
    reg.gauge("explore_seeds_run", "cumulative candidate lane-runs").set(
        ex.seeds_run, **labels
    )


def record_explore_devloop(ex, res: Dict[str, Any], window: int,
                           **labels: Any) -> None:
    """One decoded device-resident window → registry: ring occupancy,
    generations per dispatch, novelty acceptance. Called at the window's
    DECODE boundary only — the one host sync — so it observes values the
    host already holds. Its caller is the explorer's device loop
    (`Explorer._run_device_window`)."""
    reg = _STATE.registry
    if reg is None:
        return
    labels = {"meta_seed": ex.meta_seed, **labels}
    reg.gauge(
        "explore_devloop_ring_occupancy",
        "corpus-ring valid rows / capacity",
    ).set(res["ring"]["n"] / max(ex.top_k, 1), **labels)
    reg.gauge(
        "explore_devloop_window_generations",
        "in-jit generations retired by the last window",
    ).set(res["gens_done"], **labels)
    reg.counter(
        "explore_devloop_generations",
        "generations run device-resident",
    ).inc(res["gens_done"], **labels)
    reg.counter(
        "explore_devloop_accepts",
        "corpus-ring admissions (novelty acceptances) in-jit",
    ).inc(res["accepts"], **labels)
    reg.gauge(
        "explore_devloop_seen_rows",
        "genome-dedup table rows in use",
    ).set(res["seen_n"], **labels)


def record_shrink(result, **labels: Any) -> None:
    """Triage ShrinkResult → registry: atoms before/after, dispatches."""
    reg = _STATE.registry
    if reg is None:
        return
    reg.gauge("shrink_atoms_original", "fault atoms before ddmin").set(
        result.original_atoms, **labels
    )
    reg.gauge("shrink_atoms_kept", "fault atoms remaining after ddmin") \
        .set(len(result.kept_atoms), **labels)
    reg.counter("shrink_dispatches", "batched shrink evaluations").inc(
        result.dispatches, **labels
    )


# causal-structure histogram buckets: event counts, not seconds
CAUSAL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


def record_causal(digest: Dict[str, Any], **labels: Any) -> None:
    """One causal digest (causal.causal_digest) → registry: the
    causal-depth / cone-width / chain-length distributions of explained
    violations — the bug-anatomy shape of a campaign at a glance
    (docs/causality.md)."""
    reg = _STATE.registry
    if reg is None:
        return
    reg.histogram(
        "causal_depth", "longest dependency path in the violation cone",
        buckets=CAUSAL_BUCKETS,
    ).observe(int(digest.get("depth", 0)), **labels)
    reg.histogram(
        "causal_cone_width", "events in the violation's backward cone",
        buckets=CAUSAL_BUCKETS,
    ).observe(int(digest.get("cone_size", 0)), **labels)
    reg.histogram(
        "causal_chain_len", "events in the minimal causal slice",
        buckets=CAUSAL_BUCKETS,
    ).observe(int(digest.get("chain_len", 0)), **labels)


def record_slice(line: Dict[str, Any], **labels: Any) -> None:
    """One `campaign serve` slice line → registry."""
    reg = _STATE.registry
    if reg is None:
        return
    cid = str(line.get("campaign"))
    reg.gauge("campaign_generation", "per-campaign generation cursor").set(
        int(line.get("generation", 0)), campaign=cid, **labels
    )
    reg.gauge("campaign_remaining", "generations left in the request").set(
        int(line.get("remaining", 0)), campaign=cid, **labels
    )
    reg.gauge("campaign_bugs", "deduped BugRecords").set(
        int(line.get("bugs", 0)), campaign=cid, **labels
    )
    reg.counter("campaign_slices", "service slices run").inc(
        1, campaign=cid, **labels
    )


def record_oracle(status: Dict[str, Any], **labels: Any) -> None:
    """One differential-oracle tenant status (oracle.OracleTenant.status)
    → registry: lanes replayed, divergences found, sampling pressure.
    Its caller, the oracle tenant, is a later slice of the port."""
    reg = _STATE.registry
    if reg is None:
        return
    reg.gauge("oracle_seeds_checked", "lanes replayed schedule-matched") \
        .set(int(status.get("seeds_checked", 0)), **labels)
    reg.gauge("oracle_divergences", "host/schedule divergences found") \
        .set(int(status.get("divergences", 0)), **labels)
    reg.gauge("oracle_draws_checked", "coin draws verified draw-for-draw") \
        .set(int(status.get("draws_checked", 0)), **labels)
    reg.gauge(
        "oracle_skipped_saturated",
        "sampled lanes dropped by the per-round budget",
    ).set(int(status.get("skipped_saturated", 0)), **labels)
    reg.gauge("oracle_sample_rate", "oracle lane-sampling rate").set(
        float(status.get("sample_rate", 0.0)), **labels
    )


# --------------------------------------------------------------------------
# Perfetto / Chrome-trace timelines
# --------------------------------------------------------------------------

SIM_PID = 1  # virtual-time tracks (one tid per node + chaos/invariant)
LOOP_PID = 2  # wall-clock fuzz-loop spans (one tid per thread)
CHAOS_TID_BASE = 1000  # chaos window/instant tracks sit above node tids
INVARIANT_TID = 1999


def _meta(pid: int, tid: Optional[int], name: str, what: str) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ph": "M", "pid": pid, "ts": 0, "name": what,
        "args": {"name": name},
    }
    if tid is not None:
        ev["tid"] = tid
    return ev


def perfetto_from_events(
    events: Sequence[Any],
    n_nodes: Optional[int] = None,
    label: str = "madsim-tpu",
) -> Dict[str, Any]:
    """Virtual-time protocol timeline from a `TraceEvent` stream
    (tpu/trace.extract_trace) as Chrome-trace JSON, loadable in Perfetto.

    The mapping is 1:1 with `format_trace` (pinned event-for-event by
    tests/test_telemetry.py):

      * every TraceEvent becomes exactly ONE anchor event — deliveries
        are complete slices (``ph:"X"``) on the destination node's track,
        everything else an instant (``ph:"i"``) on its own track — so a
        timeline and a text trace carry the same information;
      * each delivery additionally gets a flow arrow src→dst
        (``ph:"s"``/``ph:"f"`` pair, one id per delivery). With a
        LINEAGE-enabled trace (BatchedSim(lineage=True): events carry
        eids and deliveries their send event's eid) the arrow is TRUE
        causality — it starts at the actual emitting event's timestamp
        on the source track. Without lineage the arrow falls back to
        starting at the delivery instant, which carries no send-time
        information and (worse) any send-side heuristic would pick the
        wrong origin when a link carries several in-flight messages of
        the same kind — the regression tests/test_telemetry.py pins the
        lineage pairing against exactly that case;
      * chaos windows additionally render as duration slices: crash→
        restart on the node's track, split→heal / clog→unclog /
        spike_on→spike_off on dedicated chaos tracks (an unclosed window
        runs to the last event's timestamp);
      * violation/deadlock are process-scoped instant markers on the
        invariant track.

    Timestamps are the events' VIRTUAL times in µs (Chrome-trace native
    unit), so the timeline reads in simulated time, not wall time.
    """
    evs = list(events)
    if n_nodes is None:
        n_nodes = max(
            [e.node for e in evs if e.node >= 0]
            + [e.src for e in evs if e.kind == "deliver" and e.src >= 0]
            + [0]
        ) + 1
    out: List[Dict[str, Any]] = [
        _meta(SIM_PID, None, f"{label} (virtual time)", "process_name"),
    ]
    for n in range(n_nodes):
        out.append(_meta(SIM_PID, n, f"node{n}", "thread_name"))
    chaos_tracks = {
        "partition": CHAOS_TID_BASE,
        "clog": CHAOS_TID_BASE + 1,
        "spike": CHAOS_TID_BASE + 2,
    }
    for name, tid in chaos_tracks.items():
        out.append(_meta(SIM_PID, tid, f"chaos:{name}", "thread_name"))
    out.append(_meta(SIM_PID, INVARIANT_TID, "invariant", "thread_name"))

    t_end = max([e.t_us for e in evs] + [0])
    flow_id = 0
    # lineage pairing: map each stamped event's eid to the event, so a
    # delivery's send arrow can anchor at the real emitting event
    by_eid = {
        e.eid: e for e in evs if getattr(e, "eid", -1) >= 0
    }
    # open chaos windows: kind -> (start event, extra)
    down_since: Dict[int, int] = {}  # node -> crash t_us
    open_win: Dict[str, Tuple[int, str]] = {}  # track -> (t_us, name)

    def close_window(track: str, t1: int) -> None:
        t0, name = open_win.pop(track)
        out.append({
            "ph": "X", "pid": SIM_PID, "tid": chaos_tracks[track],
            "ts": t0, "dur": max(t1 - t0, 1), "name": name,
            "cat": "chaos",
        })

    for e in evs:
        if e.kind == "deliver":
            name = e.msg_name or f"kind{e.msg_kind}"
            args = {
                "step": e.step, "src": e.src,
                "payload": list(e.payload or ()),
            }
            send = by_eid.get(getattr(e, "sent_eid", -1))
            if getattr(e, "eid", -1) >= 0:
                args["eid"] = e.eid
                args["sent_eid"] = e.sent_eid
            out.append({
                "ph": "X", "pid": SIM_PID, "tid": e.node, "ts": e.t_us,
                "dur": 1, "name": name, "cat": "deliver", "args": args,
            })
            flow_id += 1
            # TRUE flow (lineage): the arrow starts at the emitting
            # event's own timestamp on the source track; legacy traces
            # (no lineage) fall back to the delivery instant
            s_ts = send.t_us if send is not None else e.t_us
            out.append({
                "ph": "s", "pid": SIM_PID, "tid": e.src, "ts": s_ts,
                "id": flow_id, "name": name, "cat": "msg",
            })
            out.append({
                "ph": "f", "bp": "e", "pid": SIM_PID, "tid": e.node,
                "ts": e.t_us, "id": flow_id, "name": name, "cat": "msg",
            })
            continue
        if e.kind == "timer":
            out.append({
                "ph": "i", "s": "t", "pid": SIM_PID, "tid": e.node,
                "ts": e.t_us, "name": "timer", "cat": "timer",
                "args": {"step": e.step},
            })
            continue
        if e.kind in ("violation", "deadlock"):
            out.append({
                "ph": "i", "s": "p", "pid": SIM_PID, "tid": INVARIANT_TID,
                "ts": e.t_us, "name": e.kind, "cat": "invariant",
                "args": {"step": e.step, "detail": e.detail},
            })
            continue
        # chaos instants (the 1:1 anchors) + window bookkeeping
        tid = e.node if e.kind in ("crash", "restart") else (
            chaos_tracks["partition"] if e.kind in ("split", "heal")
            else chaos_tracks["clog"] if e.kind in ("clog", "unclog")
            else chaos_tracks["spike"]
        )
        out.append({
            "ph": "i", "s": "t", "pid": SIM_PID, "tid": tid, "ts": e.t_us,
            "name": e.kind + (f" {e.detail}" if e.detail else ""),
            "cat": "chaos", "args": {"step": e.step},
        })
        if e.kind == "crash":
            down_since[e.node] = e.t_us
        elif e.kind == "restart" and e.node in down_since:
            t0 = down_since.pop(e.node)
            out.append({
                "ph": "X", "pid": SIM_PID, "tid": e.node, "ts": t0,
                "dur": max(e.t_us - t0, 1), "name": "down", "cat": "chaos",
            })
        elif e.kind == "split":
            if "partition" in open_win:
                close_window("partition", e.t_us)
            open_win["partition"] = (e.t_us, f"partition {e.detail}")
        elif e.kind == "heal" and "partition" in open_win:
            close_window("partition", e.t_us)
        elif e.kind == "clog":
            if "clog" in open_win:
                close_window("clog", e.t_us)
            open_win["clog"] = (e.t_us, f"clog {e.detail}")
        elif e.kind == "unclog" and "clog" in open_win:
            close_window("clog", e.t_us)
        elif e.kind == "spike_on":
            if "spike" in open_win:
                close_window("spike", e.t_us)
            open_win["spike"] = (e.t_us, "latency spike")
        elif e.kind == "spike_off" and "spike" in open_win:
            close_window("spike", e.t_us)
    # unclosed windows run to the end of the trace
    for node, t0 in sorted(down_since.items()):
        out.append({
            "ph": "X", "pid": SIM_PID, "tid": node, "ts": t0,
            "dur": max(t_end - t0, 1), "name": "down", "cat": "chaos",
        })
    for track in sorted(open_win):
        close_window(track, t_end)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"format": TELEMETRY_FORMAT, "source": label},
    }


def write_perfetto(
    path: str, events: Sequence[Any], n_nodes: Optional[int] = None,
    label: str = "madsim-tpu",
) -> str:
    """Write a virtual-time timeline next to whatever produced it
    (atomic: a half-written JSON is never observable)."""
    doc = perfetto_from_events(events, n_nodes=n_nodes, label=label)
    return _atomic_write(path, json.dumps(doc) + "\n")


def spans_perfetto(label: str = "fuzz loop (wall clock)") -> Dict[str, Any]:
    """The captured wall-clock spans as Chrome-trace JSON: one track per
    host thread, so pipelined dispatch/decode overlap and `serve`'s
    per-device slice lanes are visible as interleaved slices."""
    recs = spans()
    threads = sorted({r.thread for r in recs})
    tid_of = {name: i for i, name in enumerate(threads)}
    out: List[Dict[str, Any]] = [
        _meta(LOOP_PID, None, label, "process_name"),
    ]
    for name, tid in sorted(tid_of.items(), key=lambda kv: kv[1]):
        out.append(_meta(LOOP_PID, tid, name, "thread_name"))
    for r in recs:
        out.append({
            "ph": "X", "pid": LOOP_PID, "tid": tid_of[r.thread],
            "ts": round(r.t0_s * 1e6, 3), "dur": round(r.dur_s * 1e6, 3),
            "name": r.name, "cat": "span",
            "args": {k: str(v) for k, v in sorted(r.labels.items())},
        })
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "format": TELEMETRY_FORMAT,
            "dropped_spans": _STATE.spans_dropped,
        },
    }


def write_spans_perfetto(path: str) -> str:
    return _atomic_write(path, json.dumps(spans_perfetto()) + "\n")


# --------------------------------------------------------------------------
# farm status (the serve surface)
# --------------------------------------------------------------------------


def write_status(path: str, status: Dict[str, Any]) -> str:
    """Atomically persist a farm status document (format-stamped)."""
    doc = {"format": FARM_STATUS_FORMAT, **status}
    return _atomic_write(
        path, json.dumps(doc, indent=2, sort_keys=True) + "\n"
    )


def farm_textfile(status: Dict[str, Any]) -> str:
    """Render a farm status document as a Prometheus textfile — the
    scrape face of status.json, same numbers, flat exposition."""
    reg = MetricsRegistry()
    reg.gauge("farm_queue_depth", "requests waiting in queue/").set(
        int(status.get("queue_depth", 0))
    )
    reg.gauge("farm_active_campaigns", "campaigns holding a slice").set(
        len(status.get("active", {}))
    )
    reg.gauge("farm_completed_campaigns", "requests finished").set(
        len(status.get("completed", []))
    )
    reg.gauge("farm_rounds", "service rounds run").set(
        int(status.get("rounds", 0))
    )
    reg.gauge("farm_uptime_seconds", "service uptime (monotonic)").set(
        float(status.get("uptime_s", 0.0))
    )
    g_gen = reg.gauge("farm_campaign_generation", "generation cursor")
    g_rem = reg.gauge("farm_campaign_remaining", "generations remaining")
    g_bugs = reg.gauge("farm_campaign_bugs", "deduped BugRecords")
    for cid, row in sorted(status.get("active", {}).items()):
        g_gen.set(int(row.get("generation", 0)), campaign=cid)
        g_rem.set(int(row.get("remaining", 0)), campaign=cid)
        g_bugs.set(int(row.get("bugs", 0)), campaign=cid)
    g_occ = reg.gauge("farm_device_occupancy", "device busy fraction")
    g_sps = reg.gauge("farm_device_seeds_per_sec", "device fuzz throughput")
    for d, row in enumerate(status.get("per_device", [])):
        g_occ.set(float(row.get("occupancy", 0.0)), device=d)
        g_sps.set(float(row.get("seeds_per_sec", 0.0)), device=d)
    total_bugs = sum(
        int(r.get("bugs", 0)) for r in status.get("active", {}).values()
    )
    reg.gauge("farm_bugs", "BugRecords across active campaigns").set(
        total_bugs
    )
    return reg.to_prom()


def write_farm_textfile(path: str, status: Dict[str, Any]) -> str:
    """Atomically persist a farm status document's Prometheus face —
    the scrape-side sibling of `write_status` (campaign.serve calls
    both after every round)."""
    return _atomic_write(path, farm_textfile(status))


def render_status(status: Dict[str, Any]) -> str:
    """Human rendering of a farm status document (`telemetry render`)."""
    lines = [
        f"farm status ({status.get('format', '?')}): "
        f"round {status.get('rounds', 0)}, "
        f"uptime {float(status.get('uptime_s', 0.0)):.1f}s, "
        f"{status.get('devices', 1)} device(s)",
        f"  queue depth: {status.get('queue_depth', 0)}   "
        f"active: {len(status.get('active', {}))}   "
        f"completed: {len(status.get('completed', []))}",
    ]
    for cid, row in sorted(status.get("active", {}).items()):
        dev = row.get("device")
        lines.append(
            f"  campaign {cid}: generation {row.get('generation', 0)}, "
            f"{row.get('remaining', 0)} to go, {row.get('bugs', 0)} bug(s)"
            + (f", device {dev}" if dev is not None else "")
        )
    for d, row in enumerate(status.get("per_device", [])):
        lines.append(
            f"  device {d}: occupancy {float(row.get('occupancy', 0)):.2f}, "
            f"{float(row.get('seeds_per_sec', 0)):.1f} seeds/s "
            f"({int(row.get('seeds_run', 0))} run)"
        )
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI: python -m madsim_tpu_torch.telemetry tail|render
# --------------------------------------------------------------------------


def _cmd_tail(args) -> int:
    try:
        with open(args.path) as f:
            lines = [ln for ln in f if ln.strip()]
    except OSError as e:
        print(f"telemetry tail: {e}", file=sys.stderr)
        return 1
    bad = 0
    for ln in lines[-args.n:]:
        try:
            doc = parse_event(ln)
        except ValueError as e:
            bad += 1
            if args.validate:
                print(f"INVALID: {e}: {ln.strip()[:120]}", file=sys.stderr)
            continue
        if doc["kind"] == "span":
            lbl = ",".join(f"{k}={v}" for k, v in doc["labels"].items())
            print(
                f"[{doc['t0_s']:10.6f}s +{doc['dur_s'] * 1e3:8.3f}ms] "
                f"span {doc['name']}"
                + (f" {{{lbl}}}" if lbl else "")
            )
        else:
            lbl = ",".join(f"{k}={v}" for k, v in doc["labels"].items())
            print(
                f"[seq {doc['seq']:6d}] {doc['kind']:9s} {doc['name']}"
                + (f"{{{lbl}}}" if lbl else "")
                + f" = {doc['value']}"
            )
    if args.validate and bad:
        print(f"{bad} invalid line(s)", file=sys.stderr)
        return 1
    return 0


def _cmd_render(args) -> int:
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "status.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"telemetry render: {e}", file=sys.stderr)
        return 1
    if doc.get("format") == FARM_STATUS_FORMAT:
        print(render_status(doc))
        return 0
    if "traceEvents" in doc:
        evs = doc["traceEvents"]
        kinds: Dict[str, int] = {}
        for e in evs:
            kinds[e.get("ph", "?")] = kinds.get(e.get("ph", "?"), 0) + 1
        print(
            f"chrome-trace: {len(evs)} events "
            + ", ".join(f"{k}:{v}" for k, v in sorted(kinds.items()))
        )
        return 0
    print(f"telemetry render: unrecognized document at {path}",
          file=sys.stderr)
    return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.telemetry",
        description="telemetry surfaces: tail an events stream, render a "
        "farm status / timeline",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tail", help="print the last N events of a JSONL "
                       "telemetry stream")
    t.add_argument("path")
    t.add_argument("-n", type=int, default=20)
    t.add_argument("--validate", action="store_true",
                   help="exit 1 if any line fails schema validation")
    t.set_defaults(fn=_cmd_tail)
    r = sub.add_parser("render", help="render status.json (or a serve dir, "
                       "or a timeline JSON) as text")
    r.add_argument("path")
    r.set_defaults(fn=_cmd_render)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
