"""ISR log replication on the host runtime: isr's debuggable twin.

The port's copy of `madsim_tpu/workloads/isr_host.py`.

Same protocol as `madsim_tpu_torch.tpu.isr` written as host coroutines: a
fixed leader (node 0) with a dynamic In-Sync Replica set, follower
fetch/response replication (an rpc return IS the fetch response, so the
device spec's echo matching is the runtime's request/response pairing
here), eviction of stale fetchers, and a high watermark advanced to the
minimum acked offset across the ISR. The membership axis shows up two
ways: host-native chaos wipes a fraction of restarts (a rejoining
replica restarts from offset 0), and plan mode replays a compiled
FaultPlan — including `reconfig` clauses — through `NemesisDriver`,
whose `on_wipe` hook is what makes a join a FRESH disk.

The ISR catch-up contract is checked at every leader mutation point
(fetch apply, produce/evict tick), not just at the end: the planted
bug's stale admission heals within a fetch round-trip, so an end-only
check would miss it.

`fuzz_one_seed(seed)` runs one execution under loss + crash/wipe chaos
and verifies the same invariants as the device face.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

RPC_TIMEOUT = 0.080
TICK = 0.025
REPL_TIMEOUT = 0.150
PRODUCE_RATE = 0.7
WIPE_FRAC = 0.4  # host-native chaos: fraction of restarts that wipe


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Fetch:
    def __init__(self, src, leo, sent_t):
        self.src, self.leo, self.sent_t = src, leo, sent_t


@dataclass
class IsrNode:
    node_id: int
    n: int
    addrs: List[str]
    buggy: bool = False  # stale ISR re-admission: no catch-up check

    # durable (the log and the leader's replication bookkeeping)
    leo: int = 0
    hw: int = 0
    isr: Set[int] = field(default_factory=set)
    fa: Dict[int, int] = field(default_factory=dict)
    lf_t: Dict[int, float] = field(default_factory=dict)

    def __post_init__(self):
        if not self.isr and not self.fa:
            self.isr = set(range(self.n))
            self.fa = {r: 0 for r in range(self.n)}

    # ------------------------------------------------------- leader internals

    def _advance_hw(self) -> None:
        self.isr.add(0)  # the leader's own membership is pinned
        self.hw = max(self.hw, min(self.fa.get(r, 0) for r in self.isr))

    def _assert_contract(self) -> None:
        if self.hw > self.leo:
            raise InvariantViolation(
                f"watermark sanity: leader hw {self.hw} > leo {self.leo}"
            )
        for r in sorted(self.isr):
            if self.fa.get(r, 0) < self.hw:
                raise InvariantViolation(
                    f"ISR catch-up contract: replica {r} is in the ISR "
                    f"with acked offset {self.fa.get(r, 0)} < hw {self.hw}"
                )

    # ------------------------------------------------------------- handlers

    async def on_fetch(self, req: Fetch):
        # apply only a fetch newer than the last applied from this
        # replica: reorders/duplicates drop, a wipe-join's legitimate
        # offset regression (fresh send time) applies
        if req.sent_t > self.lf_t.get(req.src, 0.0):
            self.lf_t[req.src] = req.sent_t
            ack = min(req.leo, self.leo)
            self.fa[req.src] = ack
            if self.buggy:
                # THE PLANTED BUG: unconditional re-admission
                self.isr.add(req.src)
            elif ack >= self.hw:
                self.isr.add(req.src)
            else:
                self.isr.discard(req.src)
            self._advance_hw()
            self._assert_contract()
        return (self.leo, self.hw)

    # --------------------------------------------------------------- loops

    async def run(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        if self.node_id == 0:
            rpc.add_rpc_handler(self.ep, Fetch, self.on_fetch)
        t = ms.time.current()
        while True:
            await ms.time.sleep(TICK)
            now = t.elapsed()
            if self.node_id == 0:
                if ms.rand() < PRODUCE_RATE:
                    self.leo += 1
                    self.fa[0] = self.leo
                for r in list(self.isr):
                    if r != 0 and now - self.lf_t.get(r, 0.0) > REPL_TIMEOUT:
                        self.isr.discard(r)
                self._advance_hw()
                self._assert_contract()
                continue
            try:
                l_leo, l_hw = await ms.time.timeout(
                    RPC_TIMEOUT,
                    rpc.call(self.ep, self.addrs[0],
                             Fetch(self.node_id, self.leo, now)),
                )
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                continue
            # wholesale adoption of the leader's (leo, hw) — instant
            # catch-up, truncation after a leader wipe falls out free
            self.leo, self.hw = l_leo, l_hw
            if self.hw > self.leo:
                raise InvariantViolation(
                    f"watermark sanity: node {self.node_id} adopted "
                    f"hw {self.hw} > leo {self.leo}"
                )


# ------------------------------------------------------------------ harness


def check_invariants(nodes: List[IsrNode]) -> dict:
    nodes[0]._assert_contract()
    for node in nodes:
        if node.hw > node.leo:
            raise InvariantViolation(
                f"watermark sanity: node {node.node_id} has hw "
                f"{node.hw} > leo {node.leo}"
            )
    return {"hw": nodes[0].hw, "isr_size": len(nodes[0].isr)}


async def _fuzz_body(
    n_nodes: int,
    virtual_secs: float,
    chaos: bool,
    buggy: bool,
    plan=None,
    occ_off=None,
    seed=None,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    addrs = [f"10.0.6.{i + 1}:7400" for i in range(n_nodes)]
    cns: list = [None] * n_nodes

    def make_node(i: int) -> IsrNode:
        """Fresh node; the log and leader bookkeeping carry over from
        the previous incarnation unless wiped."""
        old = cns[i]
        fresh = IsrNode(i, n_nodes, addrs, buggy=buggy)
        if old is not None:
            fresh.leo, fresh.hw = old.leo, old.hw
            fresh.isr = set(old.isr)
            fresh.fa = dict(old.fa)
            fresh.lf_t = dict(old.lf_t)
        cns[i] = fresh
        return fresh

    nodes = []
    if plan is not None:
        def make_init(i: int):
            def _init():
                return make_node(i).run()

            return _init

        for i in range(n_nodes):
            node = (
                handle.create_node()
                .name(f"isr-{i}")
                .ip(f"10.0.6.{i + 1}")
                .init(make_init(i))
                .build()
            )
            nodes.append(node)
    else:
        for i in range(n_nodes):
            node = handle.create_node().name(f"isr-{i}").ip(
                f"10.0.6.{i + 1}"
            ).build()
            node.spawn(make_node(i).run())
            nodes.append(node)

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.5 + ms.rand() * 1.5)
            victim = ms.randrange(n_nodes)
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.3 + ms.rand() * 0.6)
            if ms.rand() < WIPE_FRAC:
                cns[victim] = None  # membership churn: rejoin fresh
            fresh = make_node(victim)
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos and plan is None:
        ms.spawn(chaos_task())

    driver = None
    if plan is not None:
        from madsim_tpu_torch import nemesis as nem

        def on_wipe(i: int) -> None:
            cns[i] = None  # next incarnation starts from init state

        driver = nem.NemesisDriver(
            plan,
            handle,
            node_ids=[n.id for n in nodes],
            horizon_us=int(virtual_secs * 1e6),
            seed=seed,
            on_wipe=on_wipe,
            occ_off=occ_off,
        )
        driver.install()

    t = ms.time.current()
    end = t.elapsed() + virtual_secs
    while t.elapsed() < end:
        await ms.time.sleep(0.05)
    stats = check_invariants(cns)
    stats["events"] = ms.plugin.simulator(NetSim).stat().msg_count
    if driver is not None:
        stats["nemesis"] = {
            "applied": list(driver.applied),
            "occ_fired": dict(driver.occ_fired),
            "node_skew": dict(getattr(handle.time, "node_skew", {}) or {}),
            "node_ids": [n.id for n in nodes],
            "coins": driver.coins,
            "fires": driver.fire_counts(),
            "state": [
                (cn.leo, cn.hw, tuple(sorted(cn.isr)),
                 tuple(sorted(cn.fa.items())))
                for cn in cns
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
    plan=None,
    occ_off=None,
) -> dict:
    """One complete fuzzed execution, verified by the same oracle.

    With `plan=` (a `nemesis.FaultPlan`), chaos — including reconfig
    membership churn — comes from the compiled per-seed schedule via
    `NemesisDriver`; the returned dict then carries a `"nemesis"`
    artifact bundle."""
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    return rt.block_on(
        _fuzz_body(
            n_nodes, virtual_secs, chaos, buggy,
            plan=plan, occ_off=occ_off, seed=seed,
        )
    )
