"""Causal explainability: happens-before decode, cone slicing, bug anatomy.

The port of `madsim_tpu/causal.py`, copied function for function (the port
imports nothing of the JAX package; tests/test_torch_causal.py holds each
copy equal to its original on the same inputs). With
`BatchedSim(lineage=True)` the engine threads exact happens-before
metadata through the deterministic step: per-node Lamport clocks, a global
per-lane event counter, and a 16-bit `sent_eid` stamp on every pooled
message. A traced replay's record stream is therefore the
(send_eid -> deliver_eid) edge list, with nothing sampled or missed.

This module is the host-side decoder over that plane:

  * `graph_from_trace` rebuilds the happens-before DAG of a traced
    replay: program-order edges (consecutive events on one node) and
    message edges (send event -> delivery event). It verifies that every
    recorded send eid resolves to a real event at the recorded source
    node (the 16-bit stamp's rolling-window reconstruction is checked,
    never trusted) and that the recorded Lamport clocks equal a pure
    recomputation from the edges.
  * `causal_cone` is the backward closure from any event.
  * `causal_slice` reduces the cone to the ordered chain of deliveries and
    timer fires the violation transitively depends on (each delivery
    followed back through its message edge, each timer fire through
    program order), with the overlapping chaos windows attached. It
    renders as text (`format_slice`) and as a ShiViz log with decode-side
    vector clocks (`shiviz_log`) and as a Perfetto timeline
    (`slice_perfetto`, through `telemetry.perfetto_from_events`).
  * bug anatomy: `slice_labels` canonicalizes a slice into a
    seed-independent label sequence (node ids renamed by order of first
    appearance); `skeleton` aligns several witnesses' slices into the
    shared event skeleton.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple


class LineageError(AssertionError):
    """The recorded lineage plane is inconsistent — a send eid that
    resolves to no event (the u16 stamp's 65536-events-per-flight
    reconstruction window was exceeded) or to the wrong node, or an
    in-jit Lamport clock diverging from the pure edge recomputation."""


# --------------------------------------------------------------------------
# the happens-before DAG
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CausalGraph:
    """The decoded happens-before DAG of ONE traced lane.

    `events` maps eid -> TraceEvent (deliver/timer only — the events
    that carry ids); `prog_pred` is the program-order predecessor
    (previous event on the same node, if any), `msg_pred` the message
    edge (the delivery's send event). `chaos` holds the trace's chaos
    events (crash/restart/split/heal/clog/unclog/spike windows) in time
    order, and `violation` the violation marker if the lane violated.
    """

    events: Dict[int, Any]
    prog_pred: Dict[int, int]
    msg_pred: Dict[int, int]
    chaos: List[Any]
    violation: Optional[Any]
    n_nodes: int

    @property
    def edges(self) -> List[Tuple[int, int]]:
        """The (send_eid -> deliver_eid) message-edge list, eid order."""
        return sorted(self.msg_pred.items(), key=lambda kv: kv[0])

    def preds(self, eid: int) -> List[int]:
        out = []
        p = self.prog_pred.get(eid)
        if p is not None:
            out.append(p)
        m = self.msg_pred.get(eid)
        if m is not None:
            out.append(m)
        return out


def graph_from_events(
    events: Sequence[Any], n_nodes: Optional[int] = None,
    check: bool = True,
) -> CausalGraph:
    """Build the DAG from a lineage-enabled `trace.extract_trace` list.

    `check=True` (default) verifies the lineage plane instead of
    trusting it: every message edge must point to an earlier event at
    the delivery's recorded source node (this is what catches a u16
    stamp whose rolling-window reconstruction aliased — more than 65535
    lane events during one message's flight), and the recorded in-jit
    Lamport clocks must equal the pure recomputation from the edges
    (`lamport_mirror`). Raises LineageError on any mismatch."""
    evs = [e for e in events if getattr(e, "eid", -1) >= 0]
    if not evs:
        raise LineageError(
            "no lineage-stamped events in this trace — re-run the replay "
            "with BatchedSim(lineage=True)"
        )
    evs.sort(key=lambda e: e.eid)
    if n_nodes is None:
        n_nodes = max(e.node for e in evs) + 1
    g = CausalGraph(
        events={}, prog_pred={}, msg_pred={}, chaos=[], violation=None,
        n_nodes=n_nodes,
    )
    last_on: Dict[int, int] = {}
    for e in evs:
        if e.eid in g.events:
            raise LineageError(f"duplicate event id {e.eid}")
        g.events[e.eid] = e
        p = last_on.get(e.node)
        if p is not None:
            g.prog_pred[e.eid] = p
        last_on[e.node] = e.eid
        if e.kind == "deliver" and e.sent_eid >= 0:
            g.msg_pred[e.eid] = e.sent_eid
    for e in events:
        if e.kind in ("crash", "restart", "split", "heal", "clog",
                      "unclog", "spike_on", "spike_off", "remove", "join"):
            g.chaos.append(e)
        elif e.kind == "violation" and g.violation is None:
            g.violation = e
    if check:
        for de, se in g.msg_pred.items():
            send = g.events.get(se)
            if send is None:
                raise LineageError(
                    f"delivery eid={de} names send eid={se}, which is not "
                    "an event in this trace — the sent_eid reconstruction "
                    "window (65536 lane events per flight) was exceeded"
                )
            if se >= de:
                raise LineageError(
                    f"message edge {se} -> {de} runs backward in eid order"
                )
            d = g.events[de]
            if send.node != d.src:
                raise LineageError(
                    f"delivery eid={de} (src node{d.src}) resolved to a "
                    f"send event at node{send.node} — stamp aliasing"
                )
        check_lamport(g)
    return g


def graph_from_trace(
    recs, kind_names: Optional[Sequence[str]] = None, lane: int = 0,
    n_nodes: Optional[int] = None, check: bool = True,
) -> CausalGraph:
    """Decode a lineage-enabled TraceRecord stream (BatchedSim.run_traced
    with lineage=True) into its happens-before DAG."""
    from .tpu.trace import extract_trace

    if recs.evt_eid is None:
        raise LineageError(
            "trace carries no lineage plane — build the sim with "
            "BatchedSim(..., lineage=True)"
        )
    events = extract_trace(recs, kind_names=kind_names, lane=lane)
    return graph_from_events(events, n_nodes=n_nodes, check=check)


def lamport_mirror(g: CausalGraph) -> Dict[int, int]:
    """Recompute every event's Lamport clock from the DAG alone — the
    pure host-side mirror of the in-jit rule (delivery:
    max(local, send eid) + 1 with the message's send-event id as the
    sender's value; local event: +1). Returns eid -> clock."""
    lam_node = [0] * g.n_nodes
    out: Dict[int, int] = {}
    for eid in sorted(g.events):
        e = g.events[eid]
        if eid in g.msg_pred:
            lam_node[e.node] = max(lam_node[e.node], g.msg_pred[eid]) + 1
        else:
            lam_node[e.node] += 1
        out[eid] = lam_node[e.node]
    return out


def check_lamport(g: CausalGraph) -> None:
    """Assert recorded in-jit Lamport clocks == the pure mirror."""
    mirror = lamport_mirror(g)
    for eid, want in mirror.items():
        got = g.events[eid].lam
        if got >= 0 and got != want:
            raise LineageError(
                f"event eid={eid}: in-jit Lamport clock {got} != mirror "
                f"recomputation {want} — the lineage plane desynced"
            )


def vector_clocks(g: CausalGraph) -> Dict[int, List[int]]:
    """Decode-side vector clocks over the DAG (for ShiViz rendering and
    concurrency queries): VC[e] = elementwise max over predecessors,
    then own node's component += 1. Cheap on the host; the device never
    carries them (N words per message would blow the carry budget the
    u16 stamp exists to respect)."""
    out: Dict[int, List[int]] = {}
    for eid in sorted(g.events):
        e = g.events[eid]
        vc = [0] * g.n_nodes
        for p in g.preds(eid):
            pv = out[p]
            for i in range(g.n_nodes):
                if pv[i] > vc[i]:
                    vc[i] = pv[i]
        vc[e.node] += 1
        out[eid] = vc
    return out


def check_host_lineage(lineage) -> int:
    """Validate a host-runtime HostLineage mirror (net/netsim.py) against
    the SAME Lamport law the device face obeys: events replay in eid
    order, a send ticks its node's clock, a delivery updates
    max(local, send event id) + 1, every edge points backward in eid
    order to a real send event. Returns the number of edges checked.

    This is the host face of the lineage twin. Host and device EDGES are
    not compared event-for-event: the two backends roll their own
    network latencies, so trajectories differ by design even under the
    schedule-matched replay the differential oracle performs
    (`madsim_tpu/oracle.py`, docs/oracle.md — the oracle compares the
    schedule stream, coin draws, skew, and this law instead). What IS
    shared — and checked by this one function plus `check_lamport` — is
    the lineage LAW both faces implement with the same sender-value
    vocabulary (the message carries its send event's id)."""
    lam: Dict[int, int] = {}
    by_eid: Dict[int, tuple] = {}
    edge_of: Dict[int, int] = {
        de: se for se, de in lineage.edges
    }
    checked = 0
    for eid, node, lam_after, kind in lineage.events:
        if kind == "send":
            want = lam.get(node, 0) + 1
        else:
            se = edge_of.get(eid)
            if se is None:
                # the edge list is bounded; a dropped edge can't be
                # law-checked (lineage.dropped counts it)
                lam[node] = lam_after
                by_eid[eid] = (node, kind)
                continue
            send = by_eid.get(se)
            if send is None or send[1] != "send" or se >= eid:
                raise LineageError(
                    f"host delivery eid={eid} edge names eid={se}, which "
                    "is not an earlier send event"
                )
            want = max(lam.get(node, 0), se) + 1
            checked += 1
        if lam_after != want:
            raise LineageError(
                f"host event eid={eid} ({kind} at node{node}): recorded "
                f"Lamport clock {lam_after} != law recomputation {want}"
            )
        lam[node] = lam_after
        by_eid[eid] = (node, kind)
    return checked


def host_causal_slice(lineage, anchor_eid: int, max_len: int = 16) -> List[tuple]:
    """The host-lineage analog of `causal_slice`: the minimal explanation
    chain ending at `anchor_eid`, walked over the HostLineage mirror —
    each delivery followed back through its (send_eid -> deliver_eid)
    edge, each other event through program order on its node. Rows are
    the mirror's `(eid, node, lam, kind)` tuples, ascending eid. The
    differential oracle uses this to name the first divergent delivery
    when a schedule-matched host replay diverges (docs/oracle.md)."""
    by_eid: Dict[int, tuple] = {
        row[0]: row for row in lineage.events
    }
    if not by_eid:
        return []
    send_of: Dict[int, int] = {de: se for se, de in lineage.edges}
    prev_on_node: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for eid, node, _lam, _kind in lineage.events:
        if node in last:
            prev_on_node[eid] = last[node]
        last[node] = eid
    cur: Optional[int] = (
        anchor_eid if anchor_eid in by_eid else max(by_eid)
    )
    chain: List[tuple] = []
    while cur is not None and len(chain) < max_len:
        row = by_eid[cur]
        chain.append(row)
        if row[3] == "deliver" and send_of.get(cur) in by_eid:
            cur = send_of[cur]
        else:
            cur = prev_on_node.get(cur)
    chain.reverse()
    return chain


def host_slice_labels(chain: Sequence[tuple], canonical: bool = True) -> List[str]:
    """`slice_labels` for a host slice: seed-independent label sequence
    with nodes renamed by order of first appearance."""
    rename: Dict[int, int] = {}

    def nm(node: int) -> str:
        if not canonical:
            return f"n{node}"
        if node not in rename:
            rename[node] = len(rename)
        return f"N{rename[node]}"

    return [f"{kind}:{nm(node)}" for _eid, node, _lam, kind in chain]


def format_host_slice(chain: Sequence[tuple]) -> str:
    """Human rendering of a host slice, one line per event."""
    return "\n".join(
        f"  eid={eid:<7d} node{node:<3d} lam={lam:<7d} {kind}"
        for eid, node, lam, kind in chain
    )


def host_slice_digest(chain: Sequence[tuple]) -> Dict[str, Any]:
    """`causal_digest`'s shape for a host slice — the JSON-portable form
    a divergence ReproBundle carries in its v3 `causal` field (no schema
    bump: same keys, host-lineage provenance)."""
    labels = host_slice_labels(chain)
    return {
        "labels": labels,
        "chain_len": len(chain),
        "cone_size": len(chain),
        "depth": len(chain),
        "chaos_events": 0,
        "anchor_eid": chain[-1][0] if chain else -1,
        "sha": hashlib.sha256(
            json.dumps(labels, separators=(",", ":")).encode()
        ).hexdigest()[:16],
    }


# --------------------------------------------------------------------------
# cone + slice
# --------------------------------------------------------------------------


def violation_anchor(g: CausalGraph) -> int:
    """The violation's anchor event: the LAST event of the violating
    step (the invariant check runs after the step's handlers, so the
    step's final event is what flipped it), or the trace's last event
    when no violation marker is present."""
    if g.violation is not None:
        step = g.violation.step
        at_step = [eid for eid, e in g.events.items() if e.step == step]
        if at_step:
            return max(at_step)
    return max(g.events)


def causal_cone(g: CausalGraph, eid: int) -> List[int]:
    """Backward closure: every event `eid` transitively depends on
    (program order + message edges), ascending eid order, inclusive."""
    seen = {eid}
    stack = [eid]
    while stack:
        cur = stack.pop()
        for p in g.preds(cur):
            if p not in seen:
                seen.add(p)
                stack.append(p)
    return sorted(seen)


def cone_depth(g: CausalGraph, cone: Sequence[int]) -> int:
    """Longest dependency path inside the cone (true causal depth —
    distinct from the Lamport values, which live on the eid scale)."""
    depth: Dict[int, int] = {}
    for eid in cone:  # ascending: predecessors are already solved
        depth[eid] = 1 + max(
            (depth[p] for p in g.preds(eid) if p in depth), default=0
        )
    return max(depth.values(), default=0)


@dataclasses.dataclass
class CausalSlice:
    """The minimal explanation chain: `chain` is the ordered (ascending
    eid) list of deliveries/timer-fires the anchor transitively depends
    on along the deliver-edge spine — each delivery followed back
    through its message edge to the send event, each local event
    through program order — and `chaos` the chaos-window events whose
    time overlaps the chain (the faults gating the links it crossed).
    `cone_size`/`depth` summarize the FULL cone the chain was cut from.
    """

    chain: List[Any]
    chaos: List[Any]
    anchor_eid: int
    cone_size: int
    depth: int
    n_nodes: int


def causal_slice(
    g: CausalGraph, anchor: Optional[int] = None,
    max_len: Optional[int] = None,
) -> CausalSlice:
    """Reduce the anchor's backward cone to its explanation spine.

    At each delivery the walk follows the MESSAGE edge (the delivery
    chain is the mechanism — who told whom); at a timer fire it follows
    program order. One predecessor per event keeps the slice a chain: a
    minimal ordered sequence of events that is causally sufficient to
    reach the anchor, which is what a developer reads first (the full
    cone stays available via `causal_cone`). `max_len` truncates at the
    root end (the tail nearest the violation is the interesting part).
    """
    if anchor is None:
        anchor = violation_anchor(g)
    if anchor not in g.events:
        raise LineageError(f"anchor eid={anchor} is not an event")
    chain_ids = [anchor]
    cur = anchor
    while True:
        nxt = g.msg_pred.get(cur)
        if nxt is None:
            nxt = g.prog_pred.get(cur)
        if nxt is None:
            break
        chain_ids.append(nxt)
        cur = nxt
    chain_ids.reverse()
    if max_len is not None and len(chain_ids) > max_len:
        chain_ids = chain_ids[-max_len:]
    chain = [g.events[i] for i in chain_ids]
    t0 = min(e.t_us for e in chain)
    t1 = g.events[anchor].t_us
    chaos = [e for e in g.chaos if t0 <= e.t_us <= t1]
    cone = causal_cone(g, anchor)
    return CausalSlice(
        chain=chain, chaos=chaos, anchor_eid=anchor,
        cone_size=len(cone), depth=cone_depth(g, cone),
        n_nodes=g.n_nodes,
    )


def format_slice(s: CausalSlice) -> str:
    """Human-readable slice: the chain interleaved (by virtual time)
    with its chaos context, tail = the violation's immediate cause."""
    lines = [
        f"causal slice -> anchor eid={s.anchor_eid}: chain of "
        f"{len(s.chain)} events (cone {s.cone_size} events, "
        f"depth {s.depth}), {len(s.chaos)} chaos events in window"
    ]
    rows: List[Tuple[int, int, str]] = []
    for e in s.chain:
        if e.kind == "deliver":
            name = e.msg_name or f"kind{e.msg_kind}"
            desc = (
                f"eid={e.eid} node{e.node} <- node{e.src} {name} "
                f"{list(e.payload or ())} (send eid={e.sent_eid})"
            )
        else:
            desc = f"eid={e.eid} node{e.node} timer fired"
        rows.append((e.t_us, 0, desc))
    for e in s.chaos:
        rows.append((e.t_us, 1, f"[chaos] {e}"))
    rows.sort(key=lambda r: (r[0], r[1]))
    for t_us, _, desc in rows:
        lines.append(f"  [{t_us / 1e6:9.6f}s] {desc}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# bug anatomy: seed-independent labels, cross-witness skeleton
# --------------------------------------------------------------------------


def slice_labels(s: CausalSlice, canonical: bool = True) -> List[str]:
    """The slice as a seed-independent label sequence.

    Node ids are renamed by order of FIRST APPEARANCE in the chain
    (`canonical=True`): two witnesses whose chaos elected different
    leaders then produce the SAME labels when the mechanism is the same
    (crash victims and partition sides are seed-local noise; the shape
    of who-told-whom is the mechanism). Payloads and times are dropped
    for the same reason."""
    rename: Dict[int, int] = {}

    def nm(node: int) -> str:
        if not canonical:
            return f"n{node}"
        if node not in rename:
            rename[node] = len(rename)
        return f"N{rename[node]}"

    out = []
    for e in s.chain:
        if e.kind == "deliver":
            name = e.msg_name or f"kind{e.msg_kind}"
            out.append(f"deliver:{name}:{nm(e.src)}->{nm(e.node)}")
        else:
            out.append(f"timer:{nm(e.node)}")
    return out


def _lcs(a: Sequence[str], b: Sequence[str]) -> List[str]:
    """Longest common subsequence (classic DP; slices are short)."""
    la, lb = len(a), len(b)
    dp = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la - 1, -1, -1):
        for j in range(lb - 1, -1, -1):
            if a[i] == b[j]:
                dp[i][j] = dp[i + 1][j + 1] + 1
            else:
                dp[i][j] = max(dp[i + 1][j], dp[i][j + 1])
    out: List[str] = []
    i = j = 0
    while i < la and j < lb:
        if a[i] == b[j]:
            out.append(a[i])
            i += 1
            j += 1
        elif dp[i + 1][j] >= dp[i][j + 1]:
            i += 1
        else:
            j += 1
    return out


def skeleton(label_seqs: Sequence[Sequence[str]]) -> List[str]:
    """The shared event skeleton of >= 1 witnesses' slices: the longest
    label subsequence common to ALL of them (pairwise LCS fold). What
    survives is the mechanism every witness shares; what each witness
    has beyond it is seed-local noise. Order-insensitive by
    construction up to LCS tie-breaks — the fold is run in the given
    order; callers who care pin witness order (campaign sorts by seed)."""
    if not label_seqs:
        return []
    acc = list(label_seqs[0])
    for seq in label_seqs[1:]:
        acc = _lcs(acc, list(seq))
    return acc


def causal_digest(s: CausalSlice) -> Dict[str, Any]:
    """The compact, JSON-portable summary a ReproBundle carries
    (bundle schema v3, optional field `causal`): canonical labels, cone
    stats, and a sha over the labels (drift detector for repro
    --explain replays)."""
    labels = slice_labels(s)
    return {
        "labels": labels,
        "chain_len": len(s.chain),
        "cone_size": s.cone_size,
        "depth": s.depth,
        "chaos_events": len(s.chaos),
        "anchor_eid": s.anchor_eid,
        "sha": hashlib.sha256(
            json.dumps(labels, separators=(",", ":")).encode()
        ).hexdigest()[:16],
    }


# --------------------------------------------------------------------------
# renderers: ShiViz log, Perfetto slice
# --------------------------------------------------------------------------

# the ShiViz parser regex matching shiviz_log's line format (paste it
# into ShiViz's "log parsing regular expression" box)
SHIVIZ_REGEX = r"(?<host>\S+) (?<clock>{.*})\n(?<event>.*)"


def shiviz_log(g: CausalGraph) -> str:
    """The DAG as a ShiViz-compatible log: per event, one host+vector-
    clock line then one description line (SHIVIZ_REGEX parses it).
    Vector clocks are computed decode-side from the edges."""
    vcs = vector_clocks(g)
    lines: List[str] = []
    for eid in sorted(g.events):
        e = g.events[eid]
        host = f"node{e.node}"
        vc = {
            f"node{i}": c for i, c in enumerate(vcs[eid]) if c > 0
        }
        if e.kind == "deliver":
            name = e.msg_name or f"kind{e.msg_kind}"
            desc = (
                f"deliver {name} from node{e.src} "
                f"(eid={eid}, t={e.t_us}us)"
            )
        else:
            desc = f"timer fired (eid={eid}, t={e.t_us}us)"
        lines.append(f"{host} {json.dumps(vc, sort_keys=True)}")
        lines.append(desc)
    return "\n".join(lines) + "\n"


def slice_perfetto(
    s: CausalSlice, label: str = "causal slice",
) -> Dict[str, Any]:
    """The slice as a Chrome-trace/Perfetto timeline: the chain's events
    plus its chaos context through `telemetry.perfetto_from_events`. The
    events carry eids, so every send->deliver arrow is a true flow,
    anchored at the real send event."""
    from . import telemetry

    evs = sorted(s.chain + list(s.chaos), key=lambda e: e.t_us)
    return telemetry.perfetto_from_events(
        evs, n_nodes=s.n_nodes, label=label,
    )


# --------------------------------------------------------------------------
# one-call explain
# --------------------------------------------------------------------------


def explain(
    spec, config, seed: int, ctl=None, max_steps: int = 20_000,
    triage: bool = False, max_len: Optional[int] = None, device="cuda",
) -> Tuple[CausalGraph, CausalSlice]:
    """Replay ONE seed with lineage on and slice its violation cone.

    The one-call path behind `repro --explain` and `shrink_seed(causal=
    True)`: build the lineage-enabled sim on `device` (triage=True when a
    shrunk `ctl` is being replayed), trace the seed, decode + verify the
    DAG, and cut the slice at the violation anchor (or the final event
    when the seed did not violate within max_steps)."""
    from .tpu.engine import BatchedSim

    sim = BatchedSim(
        spec, config, triage=triage or ctl is not None, lineage=True,
        device=device,
    )
    _, recs = sim.run_traced(seed, max_steps=max_steps, ctl=ctl)
    g = graph_from_trace(
        recs, kind_names=spec.msg_kind_names, n_nodes=spec.n_nodes,
    )
    return g, causal_slice(g, max_len=max_len)
