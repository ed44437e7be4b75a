"""Raft on the host runtime: the single-seed CPU baseline + flagship example.

This is the same protocol as `madsim_tpu_torch.tpu.raft` written the way a
*user* of the host runtime writes distributed code: async tasks, typed RPC over
`Endpoint`, virtual-time timers, chaos via `Handle.kill/restart` — the MadRaft
analog running on this framework's tokio-analog core, one seed per run (the
reference's thread-per-seed model, runtime/builder.rs:118-136). The port's
copy of `madsim_tpu/workloads/raft_host.py`; the differential oracle
(`madsim_tpu_torch/oracle.py`) replays device lanes on it.

Run one seed: `fuzz_one_seed(seed)` -> dict of stats; raises
InvariantViolation on a safety bug. `buggy=True` injects the classic
unsafe-commit mistake (commit on a single ack, no current-term check — what
Raft §5.4.2 forbids) to validate that the invariant monitors catch real
protocol bugs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

ELECTION_LO, ELECTION_HI = 0.150, 0.300
HEARTBEAT = 0.050


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class RequestVote:
    def __init__(self, term, cand, last_idx, last_term):
        self.term, self.cand = term, cand
        self.last_idx, self.last_term = last_idx, last_term


@rpc.rpc_request
class AppendEntries:
    def __init__(self, term, leader, prev_idx, prev_term, entry, commit):
        self.term, self.leader = term, leader
        self.prev_idx, self.prev_term = prev_idx, prev_term
        self.entry = entry  # None (heartbeat) or (term, cmd)
        self.commit = commit


@dataclass
class RaftNode:
    node_id: int
    n: int
    addrs: List[str]
    client_rate: float = 0.5
    log_capacity: int = 24
    buggy: bool = False

    term: int = 0
    voted_for: Optional[int] = None
    role: int = FOLLOWER
    votes: int = 0
    log: List[tuple] = field(default_factory=list)  # (term, cmd)
    commit: int = -1
    next_idx: Dict[int, int] = field(default_factory=dict)
    match_idx: Dict[int, int] = field(default_factory=dict)
    next_cmd: int = 1
    last_contact: float = 0.0
    timeout: float = 0.0

    async def run(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        rpc.add_rpc_handler(self.ep, RequestVote, self.on_request_vote)
        rpc.add_rpc_handler(self.ep, AppendEntries, self.on_append)
        self.reset_election_timer()
        while True:
            if self.role == LEADER:
                await ms.time.sleep(HEARTBEAT)
                self.maybe_client_write()
                ms.spawn(self.broadcast_append())
            else:
                now = ms.time.current().elapsed()
                wait = self.timeout - now
                # a wait under half a nanosecond sleeps 0 ns, which returns
                # without yielding: the JAX face's `wait > 0` spins there
                # forever (a ClockSkew node reaches it by shrinking its
                # sleeps geometrically toward the deadline). Such a wait
                # has expired; every run that ends on the JAX face runs
                # the same here.
                if ms.time.to_nanos(wait) > 0:
                    # short ticks: a mid-sleep promotion to leader must start
                    # heartbeating promptly, not after the residual wait
                    await ms.time.sleep(min(wait, HEARTBEAT / 2))
                    continue
                ms.spawn(self.start_election())
                self.reset_election_timer()

    # -- timers --

    def reset_election_timer(self) -> None:
        self.timeout = ms.time.current().elapsed() + ELECTION_LO + ms.rand() * (
            ELECTION_HI - ELECTION_LO
        )

    # -- election --

    async def start_election(self) -> None:
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.node_id
        self.votes = 1 << self.node_id
        term = self.term
        last_idx = len(self.log) - 1
        last_term = self.log[last_idx][0] if last_idx >= 0 else 0
        for peer in range(self.n):
            if peer != self.node_id:
                ms.spawn(self.request_vote_from(peer, term, last_idx, last_term))

    async def request_vote_from(self, peer, term, last_idx, last_term) -> None:
        try:
            rterm, granted = await rpc.call_timeout(
                self.ep,
                self.addrs[peer],
                RequestVote(term, self.node_id, last_idx, last_term),
                0.1,
            )
        except (TimeoutError, OSError):
            return
        if rterm > self.term:
            self.step_down(rterm)
            return
        if self.role != CANDIDATE or self.term != term or not granted:
            return
        self.votes |= 1 << peer
        majority = self.n // 2 + 1
        if bin(self.votes).count("1") >= majority and self.role == CANDIDATE:
            self.role = LEADER
            self.next_idx = {p: len(self.log) for p in range(self.n)}
            self.match_idx = {p: -1 for p in range(self.n)}
            self.match_idx[self.node_id] = len(self.log) - 1
            # assert leadership NOW — waiting for the next run-loop tick can
            # exceed followers' election timeouts and livelock elections
            ms.spawn(self.broadcast_append())

    async def on_request_vote(self, req: RequestVote):
        if req.term > self.term:
            self.step_down(req.term)
        my_last_idx = len(self.log) - 1
        my_last_term = self.log[my_last_idx][0] if my_last_idx >= 0 else 0
        log_ok = (req.last_term, req.last_idx) >= (my_last_term, my_last_idx)
        grant = (
            req.term == self.term
            and self.voted_for in (None, req.cand)
            and log_ok
        )
        if grant:
            self.voted_for = req.cand
            self.reset_election_timer()
        return (self.term, grant)

    def step_down(self, term: int) -> None:
        self.term = term
        self.role = FOLLOWER
        self.voted_for = None
        self.votes = 0

    # -- replication --

    def maybe_client_write(self) -> None:
        if (
            self.role == LEADER
            and len(self.log) < self.log_capacity
            and ms.rand() < self.client_rate
        ):
            self.log.append((self.term, self.node_id * 100_000 + self.next_cmd))
            self.next_cmd += 1
            self.match_idx[self.node_id] = len(self.log) - 1

    async def broadcast_append(self) -> None:
        for peer in range(self.n):
            if peer != self.node_id:
                ms.spawn(self.append_to(peer))

    async def append_to(self, peer: int) -> None:
        # spawned-task races found by partition fuzzing: between
        # broadcast_append spawning this task and it running, this node may
        # have (a) stepped down and adopted a NEWER term — sending its stale
        # log stamped with that term would forge "current leader" messages
        # that make followers truncate committed entries — or (b) had its
        # log truncated, leaving next_idx past the end.
        if self.role != LEADER:
            return
        term = self.term
        ni = min(self.next_idx.get(peer, 0), len(self.log))
        prev_idx = ni - 1
        prev_term = self.log[prev_idx][0] if 0 <= prev_idx < len(self.log) else 0
        entry = self.log[ni] if ni < len(self.log) else None
        try:
            rterm, ok, match = await rpc.call_timeout(
                self.ep,
                self.addrs[peer],
                AppendEntries(term, self.node_id, prev_idx, prev_term, entry, self.commit),
                0.1,
            )
        except (TimeoutError, OSError):
            return
        if rterm > self.term:
            self.step_down(rterm)
            return
        if self.role != LEADER or self.term != term:
            return
        if ok:
            self.match_idx[peer] = max(self.match_idx.get(peer, -1), match)
            self.next_idx[peer] = max(self.next_idx.get(peer, 0), match + 1)
            self.advance_commit()
        else:
            self.next_idx[peer] = max(0, self.next_idx.get(peer, 1) - 1)

    def advance_commit(self) -> None:
        matches = sorted(self.match_idx.get(p, -1) for p in range(self.n))
        if self.buggy:
            # injected bug (for detector validation): commit as soon as ANY
            # single replica acks, and skip the current-term check — the
            # classic unsafe-commit mistake Raft §5.4.2 exists to prevent
            majority_idx = matches[-1]
            if majority_idx > self.commit and majority_idx < len(self.log):
                self.commit = majority_idx
            return
        majority_idx = matches[self.n - (self.n // 2 + 1)]
        if majority_idx > self.commit and (
            majority_idx < len(self.log) and self.log[majority_idx][0] == self.term
        ):
            self.commit = majority_idx

    async def on_append(self, req: AppendEntries):
        if req.term < self.term:
            return (self.term, False, -1)
        if req.term > self.term:
            self.step_down(req.term)
        self.role = FOLLOWER
        self.reset_election_timer()
        prev_ok = req.prev_idx < 0 or (
            req.prev_idx < len(self.log)
            and self.log[req.prev_idx][0] == req.prev_term
        )
        if not prev_ok:
            return (self.term, False, -1)
        match = req.prev_idx
        if req.entry is not None:
            w = req.prev_idx + 1
            if w < len(self.log):
                if self.log[w][0] != req.entry[0]:
                    del self.log[w:]
                    self.log.append(req.entry)
            elif w == len(self.log):
                self.log.append(req.entry)
            match = w if w < self.log_capacity else req.prev_idx
        self.commit = max(self.commit, min(req.commit, match))
        return (self.term, True, match)


async def _fuzz_body(
    n_nodes: int,
    virtual_secs: float,
    chaos: bool,
    buggy: bool,
    client_rate: float,
    partitions: bool = False,
    plan=None,
    occ_off=None,
    seed=None,
    lineage: bool = False,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    addrs = [f"10.0.1.{i + 1}:6000" for i in range(n_nodes)]
    rafts: list = [None] * n_nodes

    first_committed: dict = {}  # index -> (term, cmd) first observed committed
    dead: set = set()  # node ids currently killed (state frozen mid-crash)

    def make_node(i: int) -> RaftNode:
        """Fresh node object; durable state (term/vote/log/next_cmd) is
        carried over from the previous incarnation unless it was wiped."""
        old = rafts[i]
        fresh = RaftNode(i, n_nodes, addrs, buggy=buggy, client_rate=client_rate)
        if old is not None:
            fresh.term, fresh.voted_for = old.term, old.voted_for
            fresh.log = list(old.log)
            fresh.next_cmd = old.next_cmd
        rafts[i] = fresh
        return fresh

    nodes = []
    if plan is not None:
        # schedule-matched mode: crash/restart come from the compiled
        # FaultPlan stream (NemesisDriver), so nodes are built with
        # `.init(...)` closures — `handle.restart` respawns the protocol
        # node through the same durable-state carry the host-native
        # chaos_task below performs
        def make_init(i: int):
            def _init():
                dead.discard(i)
                return make_node(i).run()

            return _init

        for i in range(n_nodes):
            node = (
                handle.create_node()
                .name(f"raft-{i}")
                .ip(f"10.0.1.{i + 1}")
                .init(make_init(i))
                .build()
            )
            nodes.append(node)
    else:
        for i in range(n_nodes):
            node = (
                handle.create_node().name(f"raft-{i}").ip(f"10.0.1.{i + 1}").build()
            )
            node.spawn(make_node(i).run())
            nodes.append(node)

    def check_invariants() -> None:
        # election safety (a killed node's state is frozen; still applies)
        leaders = [(r.term, r.node_id) for r in rafts if r.role == LEADER]
        terms = [t for t, _ in leaders]
        if len(terms) != len(set(terms)):
            raise InvariantViolation(f"two leaders in one term: {leaders}")
        # a committed entry must exist: commit index beyond the log means a
        # committed entry was truncated away
        for r in rafts:
            if r.commit >= len(r.log):
                raise InvariantViolation(
                    f"node {r.node_id} committed up to {r.commit} but log has "
                    f"only {len(r.log)} entries (committed entry truncated)"
                )
        # committed-prefix agreement
        for a in rafts:
            for b in rafts:
                for i in range(min(a.commit, b.commit) + 1):
                    if a.log[i] != b.log[i]:
                        raise InvariantViolation(
                            f"log mismatch at {i}: {a.log[i]} vs {b.log[i]}"
                        )
        # committed entries are immutable (catches unsafe early commits even
        # when no two nodes disagree at the same instant)
        for r in rafts:
            for i in range(r.commit + 1):
                seen = first_committed.get(i)
                if seen is None:
                    first_committed[i] = r.log[i]
                elif r.log[i] != seen:
                    raise InvariantViolation(
                        f"committed entry rewritten at {i}: {seen} -> {r.log[i]} "
                        f"(node {r.node_id})"
                    )
        # leader completeness (Raft §5.4), mirroring tpu/raft.py's device
        # check: a live leader must hold every node's committed prefix once
        # its term has reached that node's (a's commits happened at terms
        # <= a.term; a deposed lower-term leader is legitimately behind)
        for leader in rafts:
            if leader.role != LEADER or leader.node_id in dead:
                continue
            for a in rafts:
                if a.term > leader.term:
                    continue
                for i in range(a.commit + 1):
                    if i >= len(leader.log) or leader.log[i] != a.log[i]:
                        raise InvariantViolation(
                            f"incomplete leader {leader.node_id} (term "
                            f"{leader.term}): misses node {a.node_id}'s "
                            f"committed entry {i}"
                        )

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.5 + ms.rand() * 2.5)
            victim = ms.randrange(n_nodes)
            dead.add(victim)
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.3 + ms.rand() * 1.7)
            # fresh RaftNode object: volatile state lost, durable state kept
            old = rafts[victim]
            fresh = RaftNode(
                victim, n_nodes, addrs, buggy=buggy, client_rate=client_rate
            )
            fresh.term, fresh.voted_for = old.term, old.voted_for
            fresh.log = list(old.log)
            fresh.next_cmd = old.next_cmd
            rafts[victim] = fresh
            dead.discard(victim)
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos and plan is None:
        ms.spawn(chaos_task())

    async def partition_task() -> None:
        # random bipartition, hold, heal — mirrors the batched engine's
        # partition chaos (SimState.link_ok) on the host NetSim clog masks
        net = ms.plugin.simulator(NetSim)
        ids = [n.id for n in nodes]
        while True:
            await ms.time.sleep(0.3 + ms.rand() * 1.2)
            side = [ms.rand() < 0.5 for _ in ids]
            group_a = [i for i, s_ in zip(ids, side) if s_]
            group_b = [i for i, s_ in zip(ids, side) if not s_]
            net.partition(group_a, group_b)
            await ms.time.sleep(0.5 + ms.rand() * 1.5)
            net.heal_partition(group_a, group_b)

    if partitions and plan is None:
        ms.spawn(partition_task())

    driver = None
    if plan is not None:
        from madsim_tpu_torch import nemesis as nem

        net = ms.plugin.simulator(NetSim)
        if lineage:
            net.lineage.enable()

        def on_wipe(i: int) -> None:
            # crash-with-wipe: the next incarnation starts from init
            # state (durable state gone), like the device's wipe path
            rafts[i] = None

        driver = nem.NemesisDriver(
            plan,
            handle,
            node_ids=[n.id for n in nodes],
            horizon_us=int(virtual_secs * 1e6),
            seed=seed,
            on_wipe=on_wipe,
            occ_off=occ_off,
            on_crash=dead.add,
        )
        driver.install()

    t = ms.time.current()
    end = t.elapsed() + virtual_secs
    while t.elapsed() < end:
        await ms.time.sleep(0.01)
        check_invariants()
    stats = {
        "events": ms.plugin.simulator(NetSim).stat().msg_count,
        "commits": [r.commit for r in rafts],
        "max_term": max(r.term for r in rafts),
    }
    if driver is not None:
        # the comparator surfaces (madsim_tpu_torch/oracle.py): the applied
        # schedule stream, occurrence masks, skew assignment, coin draw
        # log, fire counts, lineage mirror, and a canonical durable-state
        # snapshot for digesting
        net = ms.plugin.simulator(NetSim)
        stats["nemesis"] = {
            "applied": list(driver.applied),
            "occ_fired": dict(driver.occ_fired),
            "node_skew": dict(getattr(handle.time, "node_skew", {}) or {}),
            "node_ids": [n.id for n in nodes],
            "coins": driver.coins,
            "fires": driver.fire_counts(),
            "lineage": net.lineage if lineage else None,
            "state": [
                (r.term, r.voted_for, tuple(r.log), r.commit, r.next_cmd)
                for r in rafts
            ],
        }
    return stats


def fuzz_one_seed(
    seed: int,
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    chaos: bool = True,
    buggy: bool = False,
    client_rate: float = 0.5,
    partitions: bool = False,
    plan=None,
    occ_off=None,
    lineage: bool = False,
) -> dict:
    """One complete fuzzed execution (the unit the reference runs per thread).

    With `plan=` (a `nemesis.FaultPlan`), chaos comes from the compiled
    per-seed schedule via `NemesisDriver` instead of the host-native
    chaos/partition tasks — the schedule-matched mode the differential
    oracle (`madsim_tpu_torch/oracle.py`) replays; the returned dict carries a
    `"nemesis"` artifact bundle (applied stream, coin draws, skew, state
    snapshot, optional lineage when `lineage=True`)."""
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    return rt.block_on(
        _fuzz_body(
            n_nodes, virtual_secs, chaos, buggy, client_rate, partitions,
            plan=plan, occ_off=occ_off, seed=seed, lineage=lineage,
        )
    )
