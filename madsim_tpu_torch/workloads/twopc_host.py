"""Two-Phase Commit on the host runtime: twopc's debuggable twin.

The port's copy of `madsim_tpu/workloads/twopc_host.py`.

Same protocol as `madsim_tpu_torch.tpu.twopc` written the way a user of the host
runtime writes distributed code — async tasks, typed RPC over `Endpoint`,
virtual-time timers, chaos via `Handle.kill/restart` and NetSim partitions
(the reference's everything-is-a-debuggable-multi-node-sim pattern,
tonic-example/tests/test.rs:155-278):

  * node 0 is the COORDINATOR running one-shot presumed-abort rounds:
    start txn `tid`, broadcast PREPARE, decide COMMIT only on unanimous
    yes-votes, record the decision durably BEFORE broadcasting OUTCOME
    (the commit point);
  * participants vote (seeded coin), record yes-votes durably (the
    in-doubt state), and run cooperative termination: an unresolved
    yes-vote periodically asks the coordinator (DREQ) for the recorded
    outcome;
  * coordinator recovery: a restart finds an open undecided txn and
    presumed-aborts it.

`fuzz_one_seed(seed)` runs one complete execution under loss + crash +
partition chaos and verifies the SAME invariants as the device face:
atomicity (no two nodes record different outcomes for one tid) and vote
respect (no COMMIT recorded for a txn the node voted NO on). `buggy=True`
plants the canonical wrong participant — an in-doubt timeout unilaterally
aborts instead of asking — to prove the oracle bites on this face too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

NONE, COMMIT, ABORT = 0, 1, 2

TXN_GAP = 0.040
PREPARE_TIMEOUT = 0.120
DOUBT_RETRY = 0.080
RPC_TIMEOUT = 0.060
VOTE_YES_P = 0.85


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Prepare:
    def __init__(self, tid):
        self.tid = tid


@rpc.rpc_request
class Outcome:
    def __init__(self, tid, val):
        self.tid, self.val = tid, val


@rpc.rpc_request
class Dreq:
    def __init__(self, tid):
        self.tid = tid


@dataclass
class TpcNode:
    node_id: int
    n: int
    addrs: List[str]
    buggy: bool = False

    # durable (survives crash/restart — the paper's stable log)
    tid_cur: int = -1
    outcomes: Dict[int, int] = field(default_factory=dict)  # tid -> COMMIT/ABORT
    votes: Dict[int, int] = field(default_factory=dict)  # tid -> my vote

    def record_outcome(self, tid: int, val: int) -> None:
        # first write wins: a recorded outcome is immutable (re-delivered
        # OUTCOMEs / late DREQ answers must not flip it)
        self.outcomes.setdefault(tid, val)

    # ------------------------------------------------------------- handlers

    async def on_prepare(self, req: Prepare):
        """Participant votes. Returns COMMIT (yes) or ABORT (no)."""
        tid = req.tid
        if tid in self.votes:  # duplicate PREPARE must not re-roll
            return self.votes[tid]
        if tid in self.outcomes:
            return ABORT if self.outcomes[tid] == ABORT else COMMIT
        yes = ms.rand() < VOTE_YES_P
        vote = COMMIT if yes else ABORT
        self.votes[tid] = vote
        if not yes:
            # presumed abort: a no-voter records the abort and may forget
            self.record_outcome(tid, ABORT)
        return vote

    async def on_outcome(self, req: Outcome):
        self.record_outcome(req.tid, req.val)
        return True

    async def on_dreq(self, req: Dreq):
        """Coordinator re-sends a recorded outcome; NONE while undecided
        (the in-doubt participant retries)."""
        return self.outcomes.get(req.tid, NONE)

    # --------------------------------------------------------------- loops

    async def run_coordinator(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[0])
        rpc.add_rpc_handler(self.ep, Dreq, self.on_dreq)
        while True:
            await ms.time.sleep(TXN_GAP / 2 + ms.rand() * TXN_GAP / 2)
            # post-restart recovery / presumed abort of an open txn
            if self.tid_cur >= 0 and self.tid_cur not in self.outcomes:
                self.record_outcome(self.tid_cur, ABORT)
                await self._broadcast_outcome(self.tid_cur, ABORT)
                continue
            tid = self.tid_cur = self.tid_cur + 1

            async def ask(peer, tid=tid):
                try:
                    return await ms.time.timeout(
                        PREPARE_TIMEOUT,
                        rpc.call(self.ep, self.addrs[peer], Prepare(tid)),
                    )
                except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                    return NONE

            tasks = [ms.spawn(ask(p)) for p in range(1, self.n)]
            votes = [await t for t in tasks]
            outcome = COMMIT if all(v == COMMIT for v in votes) else ABORT
            # the commit point: record durably, THEN broadcast
            self.record_outcome(tid, outcome)
            await self._broadcast_outcome(tid, outcome)

    async def _broadcast_outcome(self, tid: int, val: int) -> None:
        async def tell(peer):
            try:
                await ms.time.timeout(
                    RPC_TIMEOUT,
                    rpc.call(self.ep, self.addrs[peer], Outcome(tid, val)),
                )
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                pass  # cooperative termination recovers the laggard

        for t in [ms.spawn(tell(p)) for p in range(1, self.n)]:
            await t

    async def run_participant(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        rpc.add_rpc_handler(self.ep, Prepare, self.on_prepare)
        rpc.add_rpc_handler(self.ep, Outcome, self.on_outcome)
        while True:
            await ms.time.sleep(DOUBT_RETRY)
            # cooperative termination for the OLDEST unresolved yes-vote
            doubt = [
                t for t, v in self.votes.items()
                if v == COMMIT and t not in self.outcomes
            ]
            if not doubt:
                continue
            tid = min(doubt)
            if self.buggy:
                # the canonical WRONG participant: patience ran out =>
                # abort the in-doubt txn locally instead of asking
                self.record_outcome(tid, ABORT)
                continue
            try:
                known = await ms.time.timeout(
                    RPC_TIMEOUT, rpc.call(self.ep, self.addrs[0], Dreq(tid))
                )
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                continue
            if known != NONE:
                self.record_outcome(tid, known)

    async def run(self) -> None:
        if self.node_id == 0:
            await self.run_coordinator()
        else:
            await self.run_participant()


# ------------------------------------------------------------------ harness


def check_invariants(nodes: List[TpcNode]) -> dict:
    """The SAME oracle as the device face (tpu/twopc.py
    check_invariants): atomicity + vote respect, over full recorded
    histories instead of device rings."""
    decided = 0
    for a in nodes:
        for tid, val in a.outcomes.items():
            decided += 1
            for b in nodes:
                other = b.outcomes.get(tid)
                if other is not None and other != val:
                    raise InvariantViolation(
                        f"atomicity: txn {tid} recorded {val} on node "
                        f"{a.node_id} but {other} on node {b.node_id}"
                    )
        for tid, vote in a.votes.items():
            if vote == ABORT and a.outcomes.get(tid) == COMMIT:
                raise InvariantViolation(
                    f"vote respect: node {a.node_id} recorded COMMIT for "
                    f"txn {tid} it voted NO on"
                )
    return {"decided_records": decided}


async def _fuzz_body(
    n_nodes: int, virtual_secs: float, chaos: bool, partitions: bool,
    buggy: bool,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    addrs = [f"10.0.3.{i + 1}:7100" for i in range(n_nodes)]
    tps = [TpcNode(i, n_nodes, addrs, buggy=buggy) for i in range(n_nodes)]
    nodes = []
    for i in range(n_nodes):
        node = handle.create_node().name(f"tpc-{i}").ip(f"10.0.3.{i + 1}").build()
        node.spawn(tps[i].run())
        nodes.append(node)

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.4 + ms.rand() * 1.6)
            victim = ms.randrange(n_nodes)
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.2 + ms.rand() * 0.8)
            old = tps[victim]
            fresh = TpcNode(victim, n_nodes, addrs, buggy=buggy)
            # durable: tid_cur + both rings; volatile: everything else
            fresh.tid_cur = old.tid_cur
            fresh.outcomes = old.outcomes  # shared dict: recorded is recorded
            fresh.votes = old.votes
            tps[victim] = fresh
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos:
        ms.spawn(chaos_task())

    async def partition_task() -> None:
        net = ms.plugin.simulator(NetSim)
        ids = [n.id for n in nodes]
        while True:
            await ms.time.sleep(0.4 + ms.rand() * 1.1)
            side = [ms.rand() < 0.5 for _ in ids]
            group_a = [i for i, s_ in zip(ids, side) if s_]
            group_b = [i for i, s_ in zip(ids, side) if not s_]
            net.partition(group_a, group_b)
            await ms.time.sleep(0.3 + ms.rand() * 0.9)
            net.heal_partition(group_a, group_b)

    if partitions:
        ms.spawn(partition_task())

    t = ms.time.current()
    end = t.elapsed() + virtual_secs
    while t.elapsed() < end:
        await ms.time.sleep(0.05)
    stats = check_invariants(tps)
    stats["events"] = ms.plugin.simulator(NetSim).stat().msg_count
    stats["txns_started"] = tps[0].tid_cur + 1
    return stats


def fuzz_one_seed(
    seed: int,
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    chaos: bool = True,
    partitions: bool = True,
    buggy: bool = False,
) -> dict:
    """One complete fuzzed execution, verified by the exact oracle."""
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    return rt.block_on(
        _fuzz_body(n_nodes, virtual_secs, chaos, partitions, buggy)
    )
