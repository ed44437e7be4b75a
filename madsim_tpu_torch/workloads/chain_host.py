"""Chain replication on the host runtime: chain's debuggable twin.

The port's copy of `madsim_tpu/workloads/chain_host.py`.

Same protocol as `madsim_tpu_torch.tpu.chain` written as host coroutines: a
fixed chain head -> tail, writes enter at the head, propagate as nested
RPCs (a hop's rpc return IS the hop-ack), commit when the tail applies;
reads are served at the tail. Heavy-tail delays come from the runtime's
own buggify (`ms.buggify.enable()` arms NetSim's 1-5 s straggler tail),
which is what makes the canonical planted bug — a replica missing the
apply-if-newer guard blindly applying late duplicate forwards — roll
stores backwards observably.

`fuzz_one_seed(seed)` runs one execution under loss + crash + tail chaos
and verifies the same invariants as the device face: chain monotonicity,
version coherence, and client-observed version monotonicity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

RPC_TIMEOUT = 0.080
TICK = 0.020


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Fwd:
    def __init__(self, key, val, ver):
        self.key, self.val, self.ver = key, val, ver


@rpc.rpc_request
class WReq:
    def __init__(self, key, val):
        self.key, self.val = key, val


@rpc.rpc_request
class RReq:
    def __init__(self, key):
        self.key = key


@dataclass
class ChainNode:
    node_id: int
    n: int
    addrs: List[str]
    n_keys: int = 4
    buggy: bool = False  # blind apply: no if-newer guard

    # durable
    store: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # k -> (val, ver)
    vnext: Dict[int, int] = field(default_factory=dict)  # head only
    history: List[tuple] = field(default_factory=list)  # (kind, key, ver, tinv, trsp)

    def apply(self, key: int, val: int, ver: int) -> None:
        cur = self.store.get(key)
        if self.buggy or cur is None or ver > cur[1]:
            self.store[key] = (val, ver)

    async def _forward(self, key: int, val: int, ver: int) -> bool:
        """Relay down the chain until the hop-ack; True once acked."""
        nxt = self.addrs[self.node_id + 1]
        for _ in range(40):
            try:
                return bool(await ms.time.timeout(
                    RPC_TIMEOUT, rpc.call(self.ep, nxt, Fwd(key, val, ver))
                ))
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                await ms.time.sleep(TICK)
        return False

    # ------------------------------------------------------------- handlers

    async def on_fwd(self, req: Fwd) -> bool:
        self.apply(req.key, req.val, req.ver)
        if self.node_id == self.n - 1:
            return True  # tail: committed
        # relay; the nested ack unwinds the chain hop by hop
        return await self._forward(req.key, req.val, req.ver)

    async def on_wreq(self, req: WReq):
        """Head: assign a fresh version, apply, push to the tail; the
        reply (the commit ack) carries the committed version."""
        ver = self.vnext.get(req.key, 1)
        self.vnext[req.key] = ver + 1
        self.apply(req.key, req.val, ver)
        ok = await self._forward(req.key, req.val, ver)
        return (ok, ver)

    async def on_rreq(self, req: RReq):
        val, ver = self.store.get(req.key, (0, 0))
        return (val, ver)

    # --------------------------------------------------------------- loops

    async def run(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        rpc.add_rpc_handler(self.ep, Fwd, self.on_fwd)
        if self.node_id == 0:
            rpc.add_rpc_handler(self.ep, WReq, self.on_wreq)
        if self.node_id == self.n - 1:
            rpc.add_rpc_handler(self.ep, RReq, self.on_rreq)
        t = ms.time.current()
        nextval = 1
        while True:
            await ms.time.sleep(TICK)
            if ms.rand() >= 0.6:
                continue
            key = ms.randrange(self.n_keys)
            tinv = t.elapsed()
            try:
                if ms.rand() < 0.5:
                    val = self.node_id * 100_000 + nextval
                    nextval += 1
                    ok, ver = await ms.time.timeout(
                        0.4, rpc.call(self.ep, self.addrs[0], WReq(key, val))
                    )
                    if ok:
                        self.history.append(
                            ("w", key, ver, tinv, t.elapsed())
                        )
                else:
                    _val, ver = await ms.time.timeout(
                        0.4,
                        rpc.call(self.ep, self.addrs[self.n - 1], RReq(key)),
                    )
                    self.history.append(
                        ("r", key, ver, tinv, t.elapsed())
                    )
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                continue


# ------------------------------------------------------------------ harness


def check_invariants(nodes: List[ChainNode]) -> dict:
    # chain monotonicity + version coherence over final stores
    for i in range(len(nodes) - 1):
        up, down = nodes[i].store, nodes[i + 1].store
        for k, (_dv, dver) in down.items():
            uver = up.get(k, (0, 0))[1]
            if uver < dver:
                raise InvariantViolation(
                    f"chain monotonicity: node {i} has ver {uver} for key "
                    f"{k} but downstream node {i + 1} has {dver}"
                )
    seen: Dict[Tuple[int, int], int] = {}
    for node in nodes:
        for k, (val, ver) in node.store.items():
            if ver == 0:
                continue
            if seen.setdefault((k, ver), val) != val:
                raise InvariantViolation(
                    f"coherence: (key {k}, ver {ver}) has two values"
                )
    # client-observed per-key version monotonicity in invocation order
    # real-time check: an op INVOKED after a higher version's ack
    # RESPONDED must not observe a smaller version (ops concurrent with
    # the higher ack are free to see older state)
    ops = sorted(
        (o for node in nodes for o in node.history), key=lambda o: o[3]
    )
    high: Dict[int, Tuple[int, float]] = {}  # key -> (max acked ver, trsp)
    acked = 0
    for kind, key, ver, tinv, trsp in ops:
        acked += 1
        prev = high.get(key)
        if prev is not None and tinv > prev[1] and ver < prev[0]:
            raise InvariantViolation(
                f"observed version regression on key {key}: {ver} after "
                f"{prev[0]} was acked"
            )
        if prev is None or ver > prev[0]:
            high[key] = (ver, trsp)
    return {"acked_ops": acked}


async def _fuzz_body(
    n_nodes: int,
    virtual_secs: float,
    chaos: bool,
    tails: bool,
    buggy: bool,
    plan=None,
    occ_off=None,
    seed=None,
    lineage: bool = False,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    if tails:
        ms.buggify.enable()  # arms NetSim's 1-5 s straggler tail
    addrs = [f"10.0.5.{i + 1}:7300" for i in range(n_nodes)]
    cns: list = [None] * n_nodes

    def make_node(i: int) -> ChainNode:
        """Fresh node; durable store/version counter/history carried over
        from the previous incarnation unless wiped."""
        old = cns[i]
        fresh = ChainNode(i, n_nodes, addrs, buggy=buggy)
        if old is not None:
            fresh.store = dict(old.store)
            fresh.vnext = dict(old.vnext)
            fresh.history = old.history
        cns[i] = fresh
        return fresh

    nodes = []
    if plan is not None:
        # schedule-matched mode: crash/restart come from the compiled
        # FaultPlan stream; `.init(...)` closures let NemesisDriver's
        # handle.restart respawn the protocol node with the same
        # durable-state carry the host-native chaos_task performs
        def make_init(i: int):
            def _init():
                return make_node(i).run()

            return _init

        for i in range(n_nodes):
            node = (
                handle.create_node()
                .name(f"ch-{i}")
                .ip(f"10.0.5.{i + 1}")
                .init(make_init(i))
                .build()
            )
            nodes.append(node)
    else:
        for i in range(n_nodes):
            node = handle.create_node().name(f"ch-{i}").ip(f"10.0.5.{i + 1}").build()
            node.spawn(make_node(i).run())
            nodes.append(node)

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.5 + ms.rand() * 1.5)
            victim = ms.randrange(n_nodes)
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.2 + ms.rand() * 0.8)
            old = cns[victim]
            fresh = ChainNode(victim, n_nodes, addrs, buggy=buggy)
            # durable: store + head's version counter + the histories
            fresh.store = dict(old.store)
            fresh.vnext = dict(old.vnext)
            fresh.history = old.history
            cns[victim] = fresh
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos and plan is None:
        ms.spawn(chaos_task())

    driver = None
    if plan is not None:
        from madsim_tpu_torch import nemesis as nem

        net = ms.plugin.simulator(NetSim)
        if lineage:
            net.lineage.enable()

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
    stats["committed_max_ver"] = max(
        (v for _k, (_x, v) in cns[-1].store.items()), default=0
    )
    if driver is not None:
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
                (
                    tuple(sorted(cn.store.items())),
                    tuple(sorted(cn.vnext.items())),
                    len(cn.history),
                )
                for cn in cns
            ],
        }
    # no buggify.disable() needed: the flag is per-Runtime handle state
    # and dies with this runtime when block_on returns
    return stats


def fuzz_one_seed(
    seed: int,
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    chaos: bool = True,
    tails: bool = False,
    buggy: bool = False,
    plan=None,
    occ_off=None,
    lineage: bool = False,
) -> dict:
    """One complete fuzzed execution, verified by the same oracle.

    With `plan=` (a `nemesis.FaultPlan`), chaos comes from the compiled
    per-seed schedule via `NemesisDriver` (the schedule-matched mode the
    differential oracle replays); the returned dict then carries a
    `"nemesis"` artifact bundle."""
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    return rt.block_on(
        _fuzz_body(
            n_nodes, virtual_secs, chaos, tails, buggy,
            plan=plan, occ_off=occ_off, seed=seed, lineage=lineage,
        )
    )
