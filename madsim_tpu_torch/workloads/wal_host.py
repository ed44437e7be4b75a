"""WAL append service on the host runtime: wal's debuggable twin.

The port's copy of `madsim_tpu/workloads/wal_host.py`.

Same protocol as `madsim_tpu_torch.tpu.wal` written as host coroutines — and
unlike the device face, with REAL bytes: the server appends checksummed
records to an `fs.File`, fsyncs via `sync_all` (which raises EIO inside
a DiskFault degraded window), and recovery RE-READS the file, parsing
the record stream until the first incomplete or checksum-failing record
— the byte-level torn-tail handling the device spec abstracts behind
its watermark. A `disk_crash` power-fails the node's filesystem (the
unsynced tail is lost, or torn to a seed-pure prefix), so the lost-ack
invariant means exactly what it means on the device:

    a client whose last ack was observed under the server's current
    incarnation nonce must never be ahead of the server's log.

The planted bug (`buggy=True`) acks the append the moment the write
lands, syncing only on a periodic group-commit loop; the correct server
fsyncs before acking and refuses the ack when the dying disk's fsync
raises EIO. `fuzz_one_seed(seed)` runs one execution under host-native
durability chaos, or — with `plan=` — replays a compiled DiskFault
schedule through `NemesisDriver` (the twin-test/oracle path).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import madsim_tpu_torch as ms
from madsim_tpu_torch import fs
from madsim_tpu_torch.net import Endpoint, rpc

RPC_TIMEOUT = 0.120
TICK = 0.020
SYNC_INTERVAL = 0.120
APPEND_RATE = 0.7
WAL_PATH = "wal"
MASK = 0xFFFFFFFF
HEADER = 8  # bytes: (nonce, nonce ^ MASK)
REC = 8  # bytes per record: (index, index ^ MASK)


class InvariantViolation(AssertionError):
    pass


@rpc.rpc_request
class Append:
    def __init__(self, src, count):
        self.src, self.count = src, count


def parse_wal(data: bytes) -> "tuple[Optional[int], int]":
    """(nonce, record count) from raw WAL bytes — recovery's only input.

    Records are length-fixed and checksummed, and carry their own
    1-based index: parsing stops at the first incomplete, corrupt, or
    out-of-sequence record, so a TORN tail (a prefix of the last
    unsynced append) is dropped exactly like a missing one. A header
    that fails its checksum means no durable identity at all."""
    if len(data) < HEADER:
        return None, 0
    nonce, chk = struct.unpack_from(">II", data, 0)
    if chk != nonce ^ MASK or nonce == 0:
        return None, 0
    n, off = 0, HEADER
    while off + REC <= len(data):
        idx, ichk = struct.unpack_from(">II", data, off)
        if ichk != idx ^ MASK or idx != n + 1:
            break
        n, off = n + 1, off + REC
    return nonce, n


@dataclass
class WalNode:
    node_id: int
    n: int
    addrs: List[str]
    buggy: bool = False  # ack-before-fsync

    def __post_init__(self):
        # server durable identity/log — None until recovery reads the
        # file (the checker skips a still-recovering server)
        self.nonce: Optional[int] = None
        self.log_len: Optional[int] = None
        # client observation plane (carried across crash/restart like
        # the device's crash-preserve; a wipe constructs a fresh node)
        self.sent = 0
        self.acked = 0
        self.srv_nonce = 0

    # ------------------------------------------------------ server handlers

    async def on_append(self, req: Append):
        if self.log_len is None:
            return (0, 0)  # still recovering
        idx = self.log_len + 1
        rec = struct.pack(">II", idx, idx ^ MASK)
        try:
            await self.f.write_all_at(rec, HEADER + REC * self.log_len)
        except OSError:
            return (0, 0)
        self.log_len = idx
        if not self.buggy:
            # fsync-before-ack: the dying disk's EIO means the append
            # is NOT durable — refuse the ack (the record stays in the
            # page cache; recovery keeps it only if a later sync lands)
            try:
                await self.f.sync_all()
            except OSError:
                return (0, 0)
        # THE PLANTED BUG (buggy=True): this ack leaves now; the bytes
        # reach the disk only at the next group-commit sync
        return (self.nonce, self.log_len)

    # --------------------------------------------------------------- loops

    async def _recover(self) -> None:
        """Rebuild the durable plane from the file — the host analog of
        the device's watermark restore + on_recover."""
        try:
            data = await fs.read(WAL_PATH)
        except FileNotFoundError:
            data = b""
        nonce, count = parse_wal(data)
        if nonce is None:
            # fresh disk (first boot or a wipe): mint an incarnation
            # and make its directory entry + header durable before
            # serving anything — boot is fsynced
            nonce, count = 1 + ms.randrange(1 << 30), 0
            f = await fs.File.create(WAL_PATH)
            await f.write_all_at(struct.pack(">II", nonce, nonce ^ MASK), 0)
            while True:
                try:
                    await f.sync_all()
                    break
                except OSError:
                    await ms.time.sleep(TICK)
            self.f = f
        else:
            self.f = await fs.File.open(WAL_PATH)
            # drop any torn/unsynced garbage past the parsed prefix so
            # new records land contiguously
            await self.f.set_len(HEADER + REC * count)
        self.nonce, self.log_len = nonce, count

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
            await self._recover()
            rpc.add_rpc_handler(self.ep, Append, self.on_append)
            while True:
                # group commit: best-effort — a degraded disk refuses
                # (EIO), a dead one loses whatever never synced
                await ms.time.sleep(SYNC_INTERVAL)
                try:
                    await self.f.sync_all()
                except OSError:
                    pass
            return
        while True:
            await ms.time.sleep(TICK)
            if ms.rand() >= APPEND_RATE:
                continue
            self.sent += 1
            resp = await self._call(Append(self.node_id, self.sent))
            if not resp or not resp[0]:
                continue
            nonce, count = resp
            if nonce == self.srv_nonce:
                self.acked = max(self.acked, count)
            else:
                # a fresh incarnation voids the old observation
                self.srv_nonce, self.acked = nonce, count


# ------------------------------------------------------------------ harness


def check_invariants(cns: List[Optional[WalNode]]) -> dict:
    """The lost-ack claim, host face (same guards as the device's):
    only clients observing the server's CURRENT incarnation count, and
    a still-recovering (or down) server is skipped — its in-memory log
    is the pre-crash maximum, never below an acked count."""
    srv = cns[0]
    stats = {"max_acked": 0}
    if srv is None or srv.log_len is None:
        return stats
    for i in range(1, len(cns)):
        c = cns[i]
        if c is None or c.srv_nonce != srv.nonce:
            continue
        stats["max_acked"] = max(stats["max_acked"], c.acked)
        if c.acked > srv.log_len:
            raise InvariantViolation(
                f"lost ack: node {i} was acked {c.acked} appends under "
                f"nonce {c.srv_nonce}, but the server recovered only "
                f"{srv.log_len} — an acked append never reached the disk"
            )
    return stats


async def _fuzz_body(
    n_nodes: int,
    virtual_secs: float,
    chaos: bool,
    buggy: bool,
    disk: bool,
    plan=None,
    occ_off=None,
    seed=None,
) -> dict:
    handle = ms.Handle.current()
    from madsim_tpu_torch.net import NetSim

    addrs = [f"10.0.8.{i + 1}:7600" for i in range(n_nodes)]
    cns: list = [None] * n_nodes

    def make_node(i: int) -> WalNode:
        """Fresh node. The server carries NOTHING — its state is the
        file, recovery re-reads it (that asymmetry is the protocol).
        Clients carry their observation plane unless wiped."""
        old = cns[i]
        fresh = WalNode(i, n_nodes, addrs, buggy=buggy)
        if old is not None and i != 0:
            fresh.sent = old.sent
            fresh.acked = old.acked
            fresh.srv_nonce = old.srv_nonce
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
                .name(f"wal-{i}")
                .ip(f"10.0.8.{i + 1}")
                .init(make_init(i))
                .build()
            )
            nodes.append(node)
    else:
        for i in range(n_nodes):
            node = handle.create_node().name(f"wal-{i}").ip(
                f"10.0.8.{i + 1}"
            ).build()
            node.spawn(make_node(i).run())
            nodes.append(node)

    async def chaos_task() -> None:
        """Host-native durability chaos, the DiskFault phase shape:
        degrade (slow writes + EIO fsync) -> die (power fail, maybe
        torn) -> recover."""
        fs_sim = ms.plugin.simulator(fs.FsSim)
        while True:
            await ms.time.sleep(0.3 + ms.rand() * 0.9)
            victim = ms.randrange(n_nodes)
            vid = nodes[victim].id
            fs_sim.set_disk_fault(vid, extra_ns=30_000_000)
            await ms.time.sleep(0.08 + ms.rand() * 0.17)
            handle.kill(vid)
            fs_sim.clear_disk_fault(vid)
            torn = ms.rand() < 0.5
            fs_sim.power_fail_node(
                vid,
                torn_extent=(
                    (lambda n: ms.randrange(n + 1)) if torn else None
                ),
            )
            await ms.time.sleep(0.2 + ms.rand() * 0.6)
            fresh = make_node(victim)
            handle.restart(vid)
            nodes[victim].spawn(fresh.run())

    if chaos and disk and plan is None:
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
    stats = {"max_acked": 0}
    while t.elapsed() < end:
        await ms.time.sleep(0.05)
        got = check_invariants(cns)
        stats["max_acked"] = max(stats["max_acked"], got["max_acked"])
    srv = cns[0]
    stats["final_log_len"] = (
        srv.log_len if srv is not None and srv.log_len is not None else -1
    )
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
                (cn.nonce, cn.log_len) if cn and i == 0
                else (cn.srv_nonce, cn.acked) if cn else None
                for i, cn in enumerate(cns)
            ],
        }
    return stats


def fuzz_one_seed(
    seed: int,
    n_nodes: int = 4,
    virtual_secs: float = 8.0,
    loss_rate: float = 0.02,
    chaos: bool = True,
    buggy: bool = False,
    disk: bool = True,
    plan=None,
    occ_off=None,
) -> dict:
    """One complete fuzzed execution, verified by the same oracle.

    `disk=False` is the quiet-disk control: no durability chaos at all
    — the buggy server's early acks are then indistinguishable from
    correct ones, and the run must be clean. With `plan=` (a
    `nemesis.FaultPlan`), chaos comes from the compiled per-seed
    schedule via `NemesisDriver` (torn extents drawn through
    `ScheduleCoins.disk_torn_extent` — the oracle-checked host coin);
    the returned dict then carries a `"nemesis"` artifact bundle."""
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    return rt.block_on(
        _fuzz_body(
            n_nodes, virtual_secs, chaos, buggy, disk,
            plan=plan, occ_off=occ_off, seed=seed,
        )
    )
