"""Lease/watch on the host runtime: lease's debuggable twin.

The port's copy of `madsim_tpu/workloads/lease_host.py`.

Same protocol as `madsim_tpu_torch.tpu.lease` written as host coroutines: a
lease server (node 0) granting time-bound exclusive leases with fenced
tokens, clients renewing by keepalive and releasing after they stop
believing, and a best-effort NOTIFY watch plane. The rpc
request/response pairing plays the device spec's echo-matching role: a
grant for a timed-out acquire is dropped by the runtime, so belief can
only come from a response to the live request.

The membership hook is the durable incarnation nonce: drawn at node
construction, carried across crash/restart, REDRAWN when a wipe-join
builds a fresh node — host-native chaos wipes a fraction of restarts,
and plan mode replays compiled `reconfig` clauses through
`NemesisDriver.on_wipe`. The zombie-lease invariant is checked by a
periodic checker task (the violation persists for the lease lifetime,
unlike isr's transient one) plus at the end.

`fuzz_one_seed(seed)` runs one execution under loss + crash/wipe chaos
and verifies the same invariant as the device face.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

RPC_TIMEOUT = 0.120
TICK = 0.025
TTL = 1.5
KA_INTERVAL = 0.200
ACQUIRE_RATE = 0.5
RELEASE_RATE = 0.04
WIPE_FRAC = 0.5  # host-native chaos: fraction of restarts that wipe


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Acquire:
    def __init__(self, src, inc):
        self.src, self.inc = src, inc


@rpc.rpc_request
class Ka:
    def __init__(self, src, inc):
        self.src, self.inc = src, inc


@rpc.rpc_request
class Release:
    def __init__(self, src, token):
        self.src, self.token = src, token


@rpc.rpc_request
class Notify:
    def __init__(self, token, holder):
        self.token, self.holder = token, holder


@dataclass
class LeaseNode:
    node_id: int
    n: int
    addrs: List[str]
    buggy: bool = False  # zombie lease: renewal matches node id only

    def __post_init__(self):
        # durable client identity: the incarnation nonce rotates ONLY
        # when a wipe-join constructs a fresh node
        self.inc = 1 + ms.randrange(1 << 30)
        # client belief (durable)
        self.held = False
        self.my_token = 0
        self.my_expiry = 0.0
        self.ka_t = 0.0
        self.wseen = 0
        # the lease head (server only; durable)
        self.l_holder = -1
        self.l_inc = 0
        self.l_token = 0
        self.l_expiry = 0.0

    # ------------------------------------------------------ server handlers

    def _match_holder(self, src: int, inc: int) -> bool:
        if self.buggy:
            # THE PLANTED BUG: the incarnation is ignored, so a
            # wipe-joined client's fresh ACQUIRE/KA renews the removed
            # incarnation's live lease
            return self.l_holder == src
        return self.l_holder == src and self.l_inc == inc

    async def on_acquire(self, req: Acquire):
        now = ms.time.current().elapsed()
        free = self.l_holder < 0 or now > self.l_expiry
        if free:
            self.l_token += 1
            self.l_holder, self.l_inc = req.src, req.inc
            self.l_expiry = now + TTL
            return (True, self.l_token, self.l_expiry)
        if self._match_holder(req.src, req.inc):
            self.l_token += 1  # fencing bump on renewal too
            self.l_expiry = now + TTL
            return (True, self.l_token, self.l_expiry)
        return (False, 0, 0.0)

    async def on_ka(self, req: Ka):
        now = ms.time.current().elapsed()
        if now <= self.l_expiry and self._match_holder(req.src, req.inc):
            self.l_token += 1
            self.l_expiry = now + TTL
            return (True, self.l_token, self.l_expiry)
        return (False, 0, 0.0)

    async def on_release(self, req: Release):
        if self.l_holder == req.src and self.l_token == req.token:
            self.l_holder = -1
        return True

    async def on_notify(self, req: Notify):
        self.wseen = max(self.wseen, req.token)
        return True

    # --------------------------------------------------------------- loops

    async def _call(self, msg):
        try:
            return await ms.time.timeout(
                RPC_TIMEOUT, rpc.call(self.ep, self.addrs[0], msg)
            )
        except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
            return None

    async def run(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        if self.node_id == 0:
            rpc.add_rpc_handler(self.ep, Acquire, self.on_acquire)
            rpc.add_rpc_handler(self.ep, Ka, self.on_ka)
            rpc.add_rpc_handler(self.ep, Release, self.on_release)
        else:
            rpc.add_rpc_handler(self.ep, Notify, self.on_notify)
        t = ms.time.current()
        while True:
            await ms.time.sleep(TICK)
            now = t.elapsed()
            if self.node_id == 0:
                # watch plane: tell one random watcher the lease head
                w = 1 + ms.randrange(self.n - 1)
                try:
                    await ms.time.timeout(
                        RPC_TIMEOUT,
                        rpc.call(self.ep, self.addrs[w],
                                 Notify(self.l_token, self.l_holder)),
                    )
                except (ms.time.TimeoutError_, OSError,
                        ms.sync.ChannelClosed):
                    pass
                continue
            if self.held and now > self.my_expiry:
                self.held = False  # local expiry ends belief
            if self.held and ms.rand() < RELEASE_RATE:
                self.held = False  # stop believing BEFORE sending
                await self._call(Release(self.node_id, self.my_token))
            elif self.held and now - self.ka_t > KA_INTERVAL:
                self.ka_t = now
                resp = await self._call(Ka(self.node_id, self.inc))
                if resp and resp[0] and self.held:
                    self.my_token = max(self.my_token, resp[1])
                    self.my_expiry = max(self.my_expiry, resp[2])
                    self.wseen = max(self.wseen, resp[1])
            elif not self.held and ms.rand() < ACQUIRE_RATE:
                resp = await self._call(Acquire(self.node_id, self.inc))
                if resp and resp[0]:
                    self.held = True
                    self.my_token, self.my_expiry = resp[1], resp[2]
                    self.ka_t = t.elapsed()
                    self.wseen = max(self.wseen, resp[1])


# ------------------------------------------------------------------ harness


def check_invariants(cns: List[LeaseNode], now: float) -> dict:
    """The incarnation-identity claim (same as the device face): when
    the server records node i as holder AND i currently believes, the
    recorded incarnation is i's current one. Mutual exclusion across
    holders is out of scope — a server wipe loses the lease log, and no
    server-local fact separates that amnesia from a double-grant."""
    srv = cns[0]
    believers = 0
    for i in range(1, len(cns)):
        c = cns[i]
        if c is None or not c.held or now > c.my_expiry:
            continue
        believers += 1
        if srv is None or srv.l_holder != i:
            continue
        if srv.l_inc != c.inc:
            raise InvariantViolation(
                f"zombie lease: node {i} (inc {c.inc}, token "
                f"{c.my_token}) believes it holds the lease, but the "
                f"server records holder {srv.l_holder} with inc "
                f"{srv.l_inc} (token {srv.l_token})"
            )
    return {"believers": believers}


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

    addrs = [f"10.0.7.{i + 1}:7500" for i in range(n_nodes)]
    cns: list = [None] * n_nodes

    def make_node(i: int) -> LeaseNode:
        """Fresh node; identity + belief + the lease head carry over
        from the previous incarnation unless wiped (a wipe rotates the
        incarnation nonce — that is the membership epoch)."""
        old = cns[i]
        fresh = LeaseNode(i, n_nodes, addrs, buggy=buggy)
        if old is not None:
            fresh.inc = old.inc
            fresh.held = old.held
            fresh.my_token, fresh.my_expiry = old.my_token, old.my_expiry
            fresh.wseen = old.wseen
            fresh.l_holder, fresh.l_inc = old.l_holder, old.l_inc
            fresh.l_token, fresh.l_expiry = old.l_token, old.l_expiry
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
                .name(f"lease-{i}")
                .ip(f"10.0.7.{i + 1}")
                .init(make_init(i))
                .build()
            )
            nodes.append(node)
    else:
        for i in range(n_nodes):
            node = handle.create_node().name(f"lease-{i}").ip(
                f"10.0.7.{i + 1}"
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
                cns[victim] = None  # membership churn: fresh incarnation
            fresh = make_node(victim)
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos and plan is None:
        ms.spawn(chaos_task())

    driver = None
    if plan is not None:
        from madsim_tpu_torch import nemesis as nem

        def on_wipe(i: int) -> None:
            cns[i] = None

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
    stats = {"believers": 0}
    while t.elapsed() < end:
        await ms.time.sleep(0.05)
        # the zombie persists for the lease lifetime; a periodic
        # checker catches it long before the horizon
        got = check_invariants(cns, t.elapsed())
        stats["believers"] = max(stats["believers"], got["believers"])
    stats["final_token"] = cns[0].l_token if cns[0] else 0
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
                (cn.inc, int(cn.held), cn.my_token, cn.l_holder,
                 cn.l_inc, cn.l_token) if cn else None
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
