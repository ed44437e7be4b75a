"""Per-lane violation traces: the device-side repro microscope.

The port of `madsim_tpu/tpu/trace.py`. A violating seed re-runs single-lane
through the same step a sweep runs, with event capture on
(`BatchedSim.run_traced`), and the captured TraceRecord stream renders as
a readable event log: every delivery (src -> dst, kind, payload), timer
fire and chaos event, stamped with step index and virtual time, ending at
the step the invariant broke. `str(TraceEvent)` is byte-equal to the JAX
face's for the same event, so repro bundles carry the same `trace_tail`.

    state, recs = sim.run_traced(bad_seed)
    events = extract_trace(recs, kind_names=spec.msg_kind_names)
    print(format_trace(events[-200:]))     # the tail leading to the bug
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .engine import BatchedSim, TraceRecord
from .spec import REBASE_US


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    step: int
    t_us: int
    # deliver | timer | crash | restart | split | heal | clog | unclog |
    # spike_on | spike_off | remove | join | disk_slow | disk_crash |
    # disk_recover | violation | deadlock
    kind: str
    node: int = -1  # acting node (dst for deliver; src for clog)
    src: int = -1  # sender (deliver only)
    msg_kind: int = -1  # protocol message kind (deliver only)
    msg_name: str = ""  # human name for msg_kind, if provided
    payload: Optional[tuple] = None
    detail: str = ""
    # causal lineage fields (lineage is not ported: always -1)
    eid: int = -1
    sent_eid: int = -1
    lam: int = -1

    def __str__(self) -> str:
        t = self.t_us / 1e6
        head = f"[{t:9.6f}s #{self.step}]"
        if self.kind == "deliver":
            name = self.msg_name or str(self.msg_kind)
            return (
                f"{head} node{self.node} <- node{self.src} "
                f"{name} {list(self.payload or ())}"
            )
        if self.kind == "timer":
            return f"{head} node{self.node} timer fired"
        if self.kind in ("crash", "restart"):
            return f"{head} {self.kind} node{self.node}"
        if self.kind == "split":
            return f"{head} partition split {self.detail}"
        if self.kind == "heal":
            return f"{head} partition healed"
        if self.kind in ("clog", "unclog"):
            return f"{head} {self.kind} link {self.detail}"
        if self.kind == "spike_on":
            return f"{head} latency spike begins {self.detail}"
        if self.kind == "spike_off":
            return f"{head} latency spike ends"
        if self.kind == "remove":
            return f"{head} node{self.node} REMOVED from membership"
        if self.kind == "join":
            return f"{head} node{self.node} joins as a fresh replica"
        if self.kind == "disk_slow":
            return (
                f"{head} node{self.node} disk degrades "
                "(slow writes, failing fsync)"
            )
        if self.kind == "disk_crash":
            w = " (torn tail)" if self.detail else ""
            return (
                f"{head} node{self.node} disk dies{w} "
                "— unsynced state lost"
            )
        if self.kind == "disk_recover":
            return (
                f"{head} node{self.node} recovers from its durable watermark"
            )
        return f"{head} {self.kind.upper()} {self.detail}"


def extract_trace(
    recs: TraceRecord,
    kind_names: Optional[Sequence[str]] = None,
    lane: int = 0,
) -> List[TraceEvent]:
    """Flatten a [T, L, ...] TraceRecord into a chronological event list.
    Steps after the lane finished record no events, so the list ends at
    the violation or the horizon."""
    r = {
        f: np.asarray(getattr(recs, f).cpu().numpy()[:, lane])
        for f in TraceRecord._fields if getattr(recs, f) is not None
    }
    epoch = r["epoch"].astype(np.int64)  # [T]
    clock = r["clock"].astype(np.int64) + epoch * REBASE_US
    t_evt = r["t_evt"].astype(np.int64) + epoch[:, None] * REBASE_US
    msg_fired, timer_fired = r["msg_fired"], r["timer_fired"]

    T, N = msg_fired.shape
    events: List[TraceEvent] = []
    busy = (
        msg_fired.any(1) | timer_fired.any(1) | (r["crash"] >= 0)
        | (r["restart"] >= 0) | r["split"] | r["heal"] | r["violation"]
        | r["deadlock"] | (r["clog_src"] >= 0) | r["unclog"] | r["spike_on"]
        | r["spike_off"] | (r["remove"] >= 0) | (r["join"] >= 0)
        | (r["disk_slow"] >= 0) | (r["disk_crash"] >= 0)
        | (r["disk_recover"] >= 0)
    )
    for t in np.nonzero(busy)[0]:
        t = int(t)
        # chaos fires at the window start t_next == min(t_evt) (inactive
        # nodes default to it); violation/deadlock keep the lane clock
        t_chaos = int(t_evt[t].min())
        t_us = int(clock[t])
        # node events carry their own times (the lookahead window batches
        # independent events into one step): in time order within the step
        node_events: List[TraceEvent] = []
        for n in range(N):
            if msg_fired[t, n]:
                mk = int(r["msg_kind"][t, n])
                node_events.append(TraceEvent(
                    step=t, t_us=int(t_evt[t, n]), kind="deliver", node=n,
                    src=int(r["msg_src"][t, n]), msg_kind=mk,
                    msg_name=(
                        kind_names[mk]
                        if kind_names and 0 <= mk < len(kind_names) else ""
                    ),
                    payload=tuple(int(x) for x in r["msg_payload"][t, n]),
                ))
            if timer_fired[t, n]:
                node_events.append(TraceEvent(
                    step=t, t_us=int(t_evt[t, n]), kind="timer", node=n,
                ))
        node_events.sort(key=lambda e: e.t_us)
        events.extend(node_events)

        def chaos(kind, **kw):
            events.append(TraceEvent(step=t, t_us=t_chaos, kind=kind, **kw))

        if r["crash"][t] >= 0:
            chaos("crash", node=int(r["crash"][t]))
        if r["restart"][t] >= 0:
            chaos("restart", node=int(r["restart"][t]))
        if r["split"][t]:
            sides = int(r["side_mask"][t])
            a = [n for n in range(N) if sides >> n & 1]
            b = [n for n in range(N) if not sides >> n & 1]
            chaos("split", detail=f"{a} | {b}")
        if r["heal"][t]:
            chaos("heal")
        if r["clog_src"][t] >= 0:
            src, dst = int(r["clog_src"][t]), int(r["clog_dst"][t])
            chaos("clog", node=src, src=dst, detail=f"{src}->{dst}")
        if r["unclog"][t]:
            chaos("unclog")
        if r["spike_on"][t]:
            chaos("spike_on")
        if r["spike_off"][t]:
            chaos("spike_off")
        if r["remove"][t] >= 0:
            chaos("remove", node=int(r["remove"][t]))
        if r["join"][t] >= 0:
            chaos("join", node=int(r["join"][t]))
        torn = "torn" if r["disk_torn"][t] else ""
        if r["disk_slow"][t] >= 0:
            chaos("disk_slow", node=int(r["disk_slow"][t]))
        if r["disk_crash"][t] >= 0:
            chaos("disk_crash", node=int(r["disk_crash"][t]), detail=torn)
        if r["disk_recover"][t] >= 0:
            chaos("disk_recover", node=int(r["disk_recover"][t]), detail=torn)
        if r["violation"][t]:
            events.append(TraceEvent(
                step=t, t_us=t_us, kind="violation",
                detail="invariant check failed",
            ))
        if r["deadlock"][t]:
            events.append(TraceEvent(
                step=t, t_us=t_us, kind="deadlock", detail="no runnable events",
            ))
    # a node's deferred event can be processed a step after another node's
    # later in-window event; a stable time sort restores chronology
    events.sort(key=lambda e: e.t_us)
    return events


def format_trace(events: Sequence[TraceEvent]) -> str:
    return "\n".join(str(e) for e in events)


def trace_seed(
    sim: BatchedSim,
    seed: int,
    max_steps: int = 20_000,
    kind_names: Optional[Sequence[str]] = None,
    ctl=None,
) -> List[TraceEvent]:
    """One-call microscope: re-run `seed` traced and return its event list.
    `ctl` (a single-lane TriageCtl; triage sims only) traces a shrunk
    candidate, whose suppressed faults never appear."""
    _, recs = sim.run_traced(seed, max_steps=max_steps, ctl=ctl)
    return extract_trace(recs, kind_names=kind_names)
