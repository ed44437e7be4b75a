"""Single-decree Paxos on the host runtime: paxos's debuggable twin.

The port's copy of `madsim_tpu/workloads/paxos_host.py`.

Same synod as `madsim_tpu_torch.tpu.paxos` written as host coroutines — every
node is proposer, acceptor and learner; dueling proposers are the steady
state (the reference's debuggable-multi-node-sim pattern,
tonic-example/tests/test.rs:155-278):

  * an undecided node's retry timer starts PREPARE with a fresh unique
    ballot b = round * N + nid; acceptors promise (never regressing) and
    report their highest accepted (ballot, value);
  * on a promise majority the proposer pushes THE HIGHEST-BALLOT ACCEPTED
    VALUE IT DISCOVERED — its own candidate only if phase 1 found none
    (the rule whose omission is the canonical Paxos bug, `buggy=True`);
  * self-votes follow the same acceptor rules as any peer and are
    RECORDED (the phantom-self-vote bug the device fuzz caught as trophy
    #8 — docs/bugs_found.md — is ruled out on both faces the same way);
  * acceptors accept unless promised higher; an ACCEPTED majority decides;
    decided nodes gossip DECIDED so laggards learn.

`fuzz_one_seed(seed)` runs one execution under loss + crash + partition
chaos and verifies AGREEMENT (all decided values equal) — the same
invariant as the device face.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

RETRY_LO, RETRY_HI = 0.150, 0.400
GOSSIP = 0.200
RPC_TIMEOUT = 0.060


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Prep:
    def __init__(self, bal):
        self.bal = bal


@rpc.rpc_request
class Acc:
    def __init__(self, bal, val):
        self.bal, self.val = bal, val


@rpc.rpc_request
class Learn:
    def __init__(self, val):
        self.val = val


@dataclass
class PaxosNode:
    node_id: int
    n: int
    addrs: List[str]
    buggy: bool = False

    # acceptor stable storage (durable — Paxos' one hard requirement)
    promised: int = -1
    acc_bal: int = -1
    acc_val: int = 0
    decided: int = 0
    round: int = 0  # durable: ballots stay unique across restarts

    # ------------------------------------------------------------- handlers

    async def on_prepare(self, req: Prep) -> Tuple[bool, int, int]:
        if req.bal > self.promised:
            self.promised = req.bal
            return (True, self.acc_bal, self.acc_val)
        return (False, -1, 0)

    async def on_accept(self, req: Acc) -> bool:
        if req.bal >= self.promised:
            self.promised = req.bal
            self.acc_bal = req.bal
            self.acc_val = req.val
            return True
        return False

    async def on_learn(self, req: Learn) -> bool:
        if self.decided == 0:
            self.decided = req.val
        return True

    # --------------------------------------------------------------- loops

    async def _quorum(self, make_call) -> List[Optional[object]]:
        """Concurrent fan-out to every peer; None for drops/timeouts."""

        async def one(peer):
            try:
                return await ms.time.timeout(RPC_TIMEOUT, make_call(peer))
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                return None

        tasks = [
            ms.spawn(one(p)) for p in range(self.n) if p != self.node_id
        ]
        return [await t for t in tasks]

    async def propose_once(self) -> None:
        self.round += 1
        bal = self.round * self.n + self.node_id
        my_val = self.node_id * 100_000 + self.round
        # phase 1 — the proposer's own acceptor votes by the same rule,
        # RECORDED (no phantom self-votes), and discovery starts from its
        # own accepted pair
        acks = 0
        best_bal, best_val = self.acc_bal, self.acc_val
        if bal > self.promised:
            self.promised = bal
            acks = 1
        rsp = await self._quorum(
            lambda p: rpc.call(self.ep, self.addrs[p], Prep(bal))
        )
        for r in rsp:
            if r is None or not r[0]:
                continue
            acks += 1
            if r[1] > best_bal:
                best_bal, best_val = r[1], r[2]
        if acks <= self.n // 2 or self.decided:
            return
        # THE rule: push the discovered value when one exists
        if self.buggy:
            push = my_val  # canonical bug: ignore the discovery
        else:
            push = best_val if best_bal >= 0 else my_val
        # phase 2 — self-accept iff our own promise still allows it
        acks = 0
        if bal >= self.promised:
            self.promised = bal
            self.acc_bal, self.acc_val = bal, push
            acks = 1
        rsp = await self._quorum(
            lambda p: rpc.call(self.ep, self.addrs[p], Acc(bal, push))
        )
        acks += sum(1 for r in rsp if r)
        if acks > self.n // 2:
            if self.decided == 0:
                self.decided = push
            await self._quorum(
                lambda p: rpc.call(self.ep, self.addrs[p], Learn(push))
            )

    async def run(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        rpc.add_rpc_handler(self.ep, Prep, self.on_prepare)
        rpc.add_rpc_handler(self.ep, Acc, self.on_accept)
        rpc.add_rpc_handler(self.ep, Learn, self.on_learn)
        while True:
            if self.decided:
                await ms.time.sleep(GOSSIP)
                await self._quorum(
                    lambda p: rpc.call(self.ep, self.addrs[p],
                                       Learn(self.decided))
                )
            else:
                await ms.time.sleep(RETRY_LO + ms.rand() * (RETRY_HI - RETRY_LO))
                await self.propose_once()


# ------------------------------------------------------------------ harness


def check_agreement(nodes: List["PaxosNode"]) -> dict:
    vals = {p.decided for p in nodes if p.decided != 0}
    if len(vals) > 1:
        raise InvariantViolation(
            "agreement violated: decided values "
            + str({p.node_id: p.decided for p in nodes})
        )
    return {
        "decided_nodes": sum(1 for p in nodes if p.decided != 0),
        "value": next(iter(vals)) if vals else 0,
    }


async def _fuzz_body(
    n_nodes: int, virtual_secs: float, chaos: bool, partitions: bool,
    buggy: bool,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    addrs = [f"10.0.4.{i + 1}:7200" for i in range(n_nodes)]
    pxs = [PaxosNode(i, n_nodes, addrs, buggy=buggy) for i in range(n_nodes)]
    nodes = []
    for i in range(n_nodes):
        node = handle.create_node().name(f"px-{i}").ip(f"10.0.4.{i + 1}").build()
        node.spawn(pxs[i].run())
        nodes.append(node)

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.4 + ms.rand() * 1.6)
            victim = ms.randrange(n_nodes)
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.2 + ms.rand() * 0.8)
            old = pxs[victim]
            fresh = PaxosNode(victim, n_nodes, addrs, buggy=buggy)
            # durable: the acceptor's stable storage (+ round uniqueness)
            fresh.promised = old.promised
            fresh.acc_bal = old.acc_bal
            fresh.acc_val = old.acc_val
            fresh.decided = old.decided
            fresh.round = old.round
            pxs[victim] = fresh
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos:
        ms.spawn(chaos_task())

    async def partition_task() -> None:
        net = ms.plugin.simulator(NetSim)
        ids = [n.id for n in nodes]
        while True:
            await ms.time.sleep(0.3 + ms.rand() * 1.2)
            side = [ms.rand() < 0.5 for _ in ids]
            group_a = [i for i, s_ in zip(ids, side) if s_]
            group_b = [i for i, s_ in zip(ids, side) if not s_]
            net.partition(group_a, group_b)
            await ms.time.sleep(0.4 + ms.rand() * 1.1)
            net.heal_partition(group_a, group_b)

    if partitions:
        ms.spawn(partition_task())

    t = ms.time.current()
    end = t.elapsed() + virtual_secs
    while t.elapsed() < end:
        await ms.time.sleep(0.05)
        # agreement is checked CONTINUOUSLY (like the device's per-step
        # invariant), not only at the horizon — a transient split matters
        check_agreement(pxs)
    stats = check_agreement(pxs)
    stats["events"] = ms.plugin.simulator(NetSim).stat().msg_count
    stats["max_round"] = max(p.round for p in pxs)
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
    """One complete fuzzed execution, verified continuously."""
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    return rt.block_on(
        _fuzz_body(n_nodes, virtual_secs, chaos, partitions, buggy)
    )
