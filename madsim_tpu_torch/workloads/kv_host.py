"""The replicated KV on the host runtime: kv's debuggable twin.

The port's copy of `madsim_tpu/workloads/kv_host.py`.

Same protocol as `madsim_tpu_torch.tpu.kv` written the way a user of the host
runtime writes distributed code — async tasks, typed RPC over `Endpoint`,
virtual-time timers, chaos via `Handle.kill/restart` and NetSim partitions:

  * primary/backup with epoch claims (epoch = gen * N + node_id); a replica
    missing heartbeats claims a higher epoch and gathers CLAIM acks that
    carry each responder's whole store (merged by highest revision);
  * mandate recovery: a fresh primary re-commits every merged key under its
    own epoch through the normal write quorum before serving anything
    (adopt-then-repropose — the fuzz-found stale-serve bug's fix);
  * quorum writes and read-index reads; replicas reject lower epochs;
  * every ACKED client op is recorded with invoke/response virtual times.

`fuzz_one_seed(seed)` runs one complete execution and verifies the
recorded histories with the SAME exact oracle as the device face: per-key
Wing-Gong linearizability (`tpu/linearize.py`) plus pairwise real-time
revision monotonicity. `buggy=True` plants the canonical stale-read bug
(serve reads locally, no quorum probe) to prove the oracle bites.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, rpc

REPLICA, CLAIMING, PRIMARY = 0, 1, 2
OP_READ, OP_WRITE = 1, 2
REV_STRIDE = 1 << 10

TICK = 0.025
HB_TIMEOUT_LO, HB_TIMEOUT_HI = 0.150, 0.300
RPC_TIMEOUT = 0.120
CLIENT_RATE = 0.7
WRITE_FRAC = 0.5


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Heartbeat:
    def __init__(self, epoch):
        self.epoch = epoch


@rpc.rpc_request
class Claim:
    def __init__(self, epoch):
        self.epoch = epoch


@rpc.rpc_request
class WriteRep:
    def __init__(self, epoch, rev, key, val):
        self.epoch, self.rev, self.key, self.val = epoch, rev, key, val


@rpc.rpc_request
class ReadProbe:
    def __init__(self, epoch):
        self.epoch = epoch


@rpc.rpc_request
class ClientReq:
    def __init__(self, kind, key, val):
        self.kind, self.key, self.val = kind, key, val


@dataclass
class KvNode:
    node_id: int
    n: int
    addrs: List[str]
    n_keys: int = 4
    buggy: bool = False

    epoch: int = 0
    role: int = REPLICA
    last_hb: float = 0.0
    store: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # k -> (val, rev)
    wcount: int = 0
    recover_left: List[int] = field(default_factory=list)
    serving: bool = True  # False while a mandate recovery is in flight
    history: List[tuple] = field(default_factory=list)  # (kind,key,val,rev,tinv,trsp)
    next_val: int = 1

    def believed_primary(self) -> int:
        return self.epoch % self.n

    # ------------------------------------------------------------- handlers

    def adopt(self, epoch: int) -> None:
        if epoch > self.epoch:
            self.epoch = epoch
            self.role = REPLICA
            self.serving = True
        if epoch >= self.epoch:
            self.last_hb = ms.time.current().elapsed()

    async def on_heartbeat(self, req: Heartbeat):
        self.adopt(req.epoch)
        return self.epoch

    async def on_claim(self, req: Claim):
        if req.epoch > self.epoch:
            self.epoch = req.epoch
            self.role = REPLICA  # deposes a primary
            self.last_hb = ms.time.current().elapsed()
            return (True, dict(self.store))
        return (False, {})

    async def on_write_rep(self, req: WriteRep):
        ok = req.epoch >= self.epoch
        self.adopt(req.epoch)
        if ok:
            cur = self.store.get(req.key)
            if cur is None or req.rev > cur[1]:
                self.store[req.key] = (req.val, req.rev)
        return ok

    async def on_read_probe(self, req: ReadProbe):
        ok = req.epoch >= self.epoch
        self.adopt(req.epoch)
        return ok

    async def on_client_req(self, req: ClientReq):
        """Returns (ok, val, rev). Dropped requests return ok=False (the
        client retries) — a primary mid-recovery sheds load exactly like
        the device spec."""
        if self.buggy and req.kind == OP_READ:
            # the planted stale-read bug: ANY node answers a read straight
            # from its local store, no quorum probe
            val, rev = self.store.get(req.key, (0, 0))
            return (True, val, rev)
        if self.role != PRIMARY or not self.serving:
            return (False, 0, 0)
        if req.kind == OP_WRITE:
            rev = await self.quorum_write(req.key, req.val)
            if rev is None:
                return (False, 0, 0)
            return (True, req.val, rev)
        # read-index: serve only after a majority confirms this epoch
        if not await self.quorum_probe():
            return (False, 0, 0)
        val, rev = self.store.get(req.key, (0, 0))
        return (True, val, rev)

    # ------------------------------------------------------- quorum rounds

    async def _gather(self, make_call) -> int:
        """Fan a call to every peer CONCURRENTLY; 1 + positive acks (self
        counts). Serial awaits would stack up to (n-1) x RPC_TIMEOUT of
        pure waiting under a partition — enough to starve client timeouts
        and stretch the heartbeat period past follower patience."""

        async def one(peer):
            try:
                return bool(await make_call(peer))
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                return False

        tasks = [
            ms.spawn(one(peer))
            for peer in range(self.n) if peer != self.node_id
        ]
        acks = 1
        for t in tasks:
            if await t:
                acks += 1
        return acks

    async def quorum_write(self, key: int, val: int) -> Optional[int]:
        epoch = self.epoch
        self.wcount += 1
        rev = epoch * REV_STRIDE + self.wcount

        async def call(peer):
            return await ms.time.timeout(
                RPC_TIMEOUT,
                rpc.call(self.ep, self.addrs[peer], WriteRep(epoch, rev, key, val)),
            )

        acks = await self._gather(call)
        if self.epoch != epoch or acks <= self.n // 2:
            return None
        cur = self.store.get(key)
        if cur is None or rev > cur[1]:
            self.store[key] = (val, rev)
        return rev

    async def quorum_probe(self) -> bool:
        epoch = self.epoch

        async def call(peer):
            return await ms.time.timeout(
                RPC_TIMEOUT, rpc.call(self.ep, self.addrs[peer], ReadProbe(epoch))
            )

        # depose re-check must run AFTER the gather (a mid-probe adopt of
        # a higher epoch invalidates the mandate even with majority acks)
        acks = await self._gather(call)
        return self.epoch == epoch and acks > self.n // 2

    async def try_claim(self) -> None:
        gen = self.epoch // self.n + 1
        new_epoch = gen * self.n + self.node_id
        self.role = CLAIMING
        self.epoch = new_epoch
        merged: Dict[int, Tuple[int, int]] = dict(self.store)
        acks = 1

        for peer in range(self.n):
            if peer == self.node_id:
                continue
            try:
                ok, peer_store = await ms.time.timeout(
                    RPC_TIMEOUT,
                    rpc.call(self.ep, self.addrs[peer], Claim(new_epoch)),
                )
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                continue
            if self.epoch != new_epoch:
                return  # deposed mid-claim
            if ok:
                acks += 1
                for k, (v, r) in peer_store.items():
                    cur = merged.get(k)
                    if cur is None or r > cur[1]:
                        merged[k] = (v, r)
        if self.epoch != new_epoch or acks <= self.n // 2:
            return
        # won: merge, then MANDATE RECOVERY — re-commit every merged key
        # under this epoch before serving anything
        self.store = merged
        self.role = PRIMARY
        self.wcount = 0
        self.serving = False
        for k, (v, _r) in sorted(merged.items()):
            while self.role == PRIMARY and self.epoch == new_epoch:
                if await self.quorum_write(k, v) is not None:
                    break
                await ms.time.sleep(TICK)
        if self.role == PRIMARY and self.epoch == new_epoch:
            self.serving = True

    # ----------------------------------------------------------- main loops

    async def run(self) -> None:
        self.ep = await Endpoint.bind(self.addrs[self.node_id])
        rpc.add_rpc_handler(self.ep, Heartbeat, self.on_heartbeat)
        rpc.add_rpc_handler(self.ep, Claim, self.on_claim)
        rpc.add_rpc_handler(self.ep, WriteRep, self.on_write_rep)
        rpc.add_rpc_handler(self.ep, ReadProbe, self.on_read_probe)
        rpc.add_rpc_handler(self.ep, ClientReq, self.on_client_req)
        self.last_hb = ms.time.current().elapsed()
        ms.spawn(self.client_loop())
        hb_timeout = HB_TIMEOUT_LO + ms.rand() * (HB_TIMEOUT_HI - HB_TIMEOUT_LO)
        while True:
            await ms.time.sleep(TICK)
            now = ms.time.current().elapsed()
            if self.role == PRIMARY:
                # (recovery runs inside try_claim, so this loop only ever
                # heartbeats for a serving primary)
                epoch = self.epoch

                async def hb(peer):
                    return await ms.time.timeout(
                        RPC_TIMEOUT,
                        rpc.call(self.ep, self.addrs[peer], Heartbeat(epoch)),
                    )

                await self._gather(hb)
            elif now - self.last_hb > hb_timeout:
                await self.try_claim()
                hb_timeout = HB_TIMEOUT_LO + ms.rand() * (
                    HB_TIMEOUT_HI - HB_TIMEOUT_LO
                )

    async def client_loop(self) -> None:
        """Every node is also a client issuing ops against its believed
        primary, recording every ACKED op with real invoke/response times."""
        cep = await Endpoint.bind(f"{self.addrs[self.node_id].split(':')[0]}:0")
        while True:
            await ms.time.sleep(TICK)
            if ms.rand() >= CLIENT_RATE:
                continue
            is_write = ms.rand() < WRITE_FRAC
            key = ms.randrange(self.n_keys)
            if is_write:
                val = self.node_id * 100_000 + self.next_val
                self.next_val += 1
                req = ClientReq(OP_WRITE, key, val)
            else:
                req = ClientReq(OP_READ, key, 0)
            target = self.addrs[self.believed_primary()]
            tinv = ms.time.current().elapsed()
            try:
                ok, val, rev = await ms.time.timeout(
                    0.4, rpc.call(cep, target, req)
                )
            except (ms.time.TimeoutError_, OSError, ms.sync.ChannelClosed):
                continue
            if ok:
                trsp = ms.time.current().elapsed()
                self.history.append(
                    (req.kind, key, val, rev, tinv, trsp)
                )


# ------------------------------------------------------------------ harness


def _check_histories(nodes: List[KvNode]) -> dict:
    """The SAME oracle as the device face: per-key Wing-Gong
    linearizability + pairwise real-time revision monotonicity."""
    from madsim_tpu_torch.tpu.linearize import Op, check_key_history

    ops: List[Op] = []
    for node in nodes:
        for kind, key, val, rev, tinv, trsp in node.history:
            ops.append(Op(
                tinv=int(tinv * 1e6), trsp=int(trsp * 1e6),
                is_write=kind == OP_WRITE, key=key, val=val, rev=rev,
                node=node.node_id,
            ))
    # pairwise rev monotonicity (the device's cheap net)
    by_key: Dict[int, List[Op]] = {}
    for o in ops:
        by_key.setdefault(o.key, []).append(o)
    unmatched = 0
    for key_ops in by_key.values():
        for a in key_ops:
            for b in key_ops:
                if b.tinv > a.trsp and b.rev < a.rev:
                    raise InvariantViolation(
                        f"stale revision: {b} observed after {a} completed"
                    )
        ok, ce, um = check_key_history(key_ops)
        unmatched += um
        if not ok:
            tail = "\n  ".join(str(o) for o in (ce or [])[-12:])
            raise InvariantViolation(
                f"history not linearizable on key "
                f"{key_ops[0].key}:\n  {tail}"
            )
    return {"acked_ops": len(ops), "unmatched_reads": unmatched,
            "keys": len(by_key)}


async def _fuzz_body(
    n_nodes: int, virtual_secs: float, chaos: bool, partitions: bool,
    buggy: bool,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    addrs = [f"10.0.2.{i + 1}:7000" for i in range(n_nodes)]
    kvs = [KvNode(i, n_nodes, addrs, buggy=buggy) for i in range(n_nodes)]
    nodes = []
    for i in range(n_nodes):
        node = handle.create_node().name(f"kv-{i}").ip(f"10.0.2.{i + 1}").build()
        node.spawn(kvs[i].run())
        nodes.append(node)

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.8 + ms.rand() * 3.2)
            victim = ms.randrange(n_nodes)
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.3 + ms.rand() * 1.7)
            old = kvs[victim]
            fresh = KvNode(victim, n_nodes, addrs, buggy=buggy)
            # durable: epoch + store + history (oracle memory); volatile:
            # role/round state (mirrors the device spec's on_restart)
            fresh.epoch = old.epoch
            fresh.store = dict(old.store)
            fresh.history = old.history  # shared list: acked is acked
            fresh.next_val = old.next_val
            kvs[victim] = fresh
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos:
        ms.spawn(chaos_task())

    async def partition_task() -> None:
        net = ms.plugin.simulator(NetSim)
        ids = [n.id for n in nodes]
        while True:
            await ms.time.sleep(0.4 + ms.rand() * 1.6)
            side = [ms.rand() < 0.5 for _ in ids]
            group_a = [i for i, s_ in zip(ids, side) if s_]
            group_b = [i for i, s_ in zip(ids, side) if not s_]
            net.partition(group_a, group_b)
            await ms.time.sleep(0.5 + ms.rand() * 1.5)
            net.heal_partition(group_a, group_b)

    if partitions:
        ms.spawn(partition_task())

    t = ms.time.current()
    end = t.elapsed() + virtual_secs
    while t.elapsed() < end:
        await ms.time.sleep(0.05)
    stats = _check_histories(kvs)
    stats["events"] = ms.plugin.simulator(NetSim).stat().msg_count
    stats["max_epoch"] = max(k.epoch for k in kvs)
    return stats


def fuzz_one_seed(
    seed: int,
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.05,
    chaos: bool = False,
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
