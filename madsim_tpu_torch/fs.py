"""Filesystem simulation (reference madsim/src/sim/fs.rs:24-296).

Each node owns an in-memory map of path -> inode. Files support positional
reads/writes (`read_at` / `write_all_at`), truncation, metadata, and fsync.
State survives node restarts (it models a disk, not memory); `power_fail`
models crash-induced loss of unsynced data by restoring every file to its
content as of the last `sync_all` (a snapshot, so unsynced in-place
overwrites of synced ranges are lost too, not just appended bytes).

The reference leaves `power_fail` as a TODO stub (fs.rs:51-53); here it is
implemented, snapshotting synced content per inode. The port's copy of
`madsim_tpu/fs.py`; every `Runtime` registers `FsSim` at construction.
"""

from __future__ import annotations

import errno
from typing import Callable, Dict, Optional

from .core import context
from .core.plugin import Simulator
from .core.task import NodeId


class _INode:
    __slots__ = ("data", "synced", "ever_synced")

    def __init__(self) -> None:
        self.data = bytearray()
        self.synced = b""  # snapshot of content as of the last sync_all
        # whether ANY sync has happened: a file created but never synced
        # has no durable directory entry, so a power failure loses the
        # whole inode — not just its bytes (matching a real filesystem,
        # where the create itself needs a directory fsync to survive)
        self.ever_synced = False


class FsSim(Simulator):
    """Per-node in-memory filesystem."""

    def __init__(self, rng, time, config) -> None:
        super().__init__(rng, time, config)
        self.time = time
        self._fs: Dict[NodeId, Dict[str, _INode]] = {}
        # DiskFault degraded windows (nemesis disk_slow..disk_crash): a
        # faulted node's writes each pay extra_ns of virtual latency and
        # its fsync raises EIO — the dying-disk regime where an app that
        # acks before fsync quietly stops being durable
        self._fault_ns: Dict[NodeId, int] = {}
        # last path with an unsynced APPEND tail per node: the torn-write
        # target (a torn power failure keeps a prefix of the LAST
        # unsynced write, not of every dirty file)
        self._last_write: Dict[NodeId, str] = {}

    def create_node(self, node_id: NodeId) -> None:
        self._fs.setdefault(node_id, {})

    def reset_node(self, node_id: NodeId) -> None:
        # a kill/restart does NOT wipe the disk; it only loses unsynced data
        self.power_fail(node_id)

    # -- chaos / inspection API --

    def power_fail(
        self,
        node_id: NodeId,
        torn_extent: Optional[Callable[[int], int]] = None,
    ) -> None:
        """Lose ALL unsynced data on the node's disk.

        Restores each file to its exact content at the last `sync_all` —
        unsynced in-place overwrites of previously-synced byte ranges are
        rolled back too, not just appended length. Files created since the
        last sync are REMOVED entirely: their directory entry was never
        made durable, so the path must not survive as a present-but-empty
        file (that lie is exactly the bug class power_fail exists to
        expose — recovery code stat()ing a file that a real power loss
        would have erased).

        `torn_extent` (the nemesis DiskFault torn-crash path) is a
        callable drawing how many bytes of the LAST unsynced append
        survive on top of the synced snapshot (`ScheduleCoins.
        disk_torn_extent` — seed-pure, oracle-verified): a torn write is
        a partially-persisted tail, never a resurrected synced-past.
        It is consulted only when that last-written file both survives
        the failure (ever synced) and actually has an unsynced append
        tail — a torn coin with nothing torn to keep is a no-op.
        """
        node_fs = self._fs.get(node_id, {})
        torn_path = self._last_write.pop(node_id, None)
        for path in [p for p, ino in node_fs.items() if not ino.ever_synced]:
            del node_fs[path]
        for path, inode in node_fs.items():
            keep = b""
            if (
                torn_extent is not None
                and path == torn_path
                and len(inode.data) > len(inode.synced)
            ):
                tail = bytes(inode.data[len(inode.synced):])
                keep = tail[: torn_extent(len(tail))]
            inode.data[:] = inode.synced + keep

    def power_fail_node(
        self,
        node_id: NodeId,
        torn_extent: Optional[Callable[[int], int]] = None,
    ) -> None:
        """NemesisDriver-facing alias of `power_fail` (disk_crash apply)."""
        self.power_fail(node_id, torn_extent=torn_extent)

    def set_disk_fault(self, node_id: NodeId, extra_ns: int) -> None:
        """Open a degraded-disk window (nemesis `disk_slow`): every write
        on the node pays `extra_ns` additional virtual latency and fsync
        raises EIO until `clear_disk_fault`."""
        self._fault_ns[node_id] = int(extra_ns)

    def clear_disk_fault(self, node_id: NodeId) -> None:
        """Close the node's degraded-disk window (at `disk_crash`)."""
        self._fault_ns.pop(node_id, None)

    def disk_fault_extra_ns(self, node_id: NodeId) -> int:
        """The node's per-write fault latency in ns (0 = healthy)."""
        return self._fault_ns.get(node_id, 0)

    def wipe_node(self, node_id: NodeId) -> None:
        """Blank the node's disk entirely — the membership-JOIN rule.

        `power_fail` models a crash: synced inodes survive, never-synced
        ones vanish. A node re-entering the cluster after a `reconfig`
        removal is a DIFFERENT machine (a fresh replica receiving state
        transfer), so nothing survives — not even synced inodes. Before
        this existed, a create→remove→rejoin sequence would stat() the
        pre-removal file on the "new" replica: the joining node's rebuild
        resurrected pre-wipe inodes, the exact lie `power_fail`'s
        never-synced rule exists to prevent, extended here to joins
        (NemesisDriver applies it before the join's restart)."""
        self._fs[node_id] = {}
        self._last_write.pop(node_id, None)
        self._fault_ns.pop(node_id, None)

    def get_file_size(self, node_id: NodeId, path: str) -> Optional[int]:
        inode = self._fs.get(node_id, {}).get(str(path))
        return len(inode.data) if inode is not None else None

    def _node_fs(self, node_id: NodeId) -> Dict[str, _INode]:
        return self._fs.setdefault(node_id, {})


def _sim() -> FsSim:
    from .core.plugin import simulator

    return simulator(FsSim)


def _here() -> NodeId:
    return context.current_task().node.id


class Metadata:
    __slots__ = ("_len",)

    def __init__(self, length: int) -> None:
        self._len = length

    def len(self) -> int:
        return self._len

    def is_file(self) -> bool:
        return True


class File:
    """Positional-IO file handle (reference fs.rs:148-229)."""

    def __init__(self, sim: FsSim, node_id: NodeId, path: str, inode: _INode) -> None:
        self._sim = sim
        self._node_id = node_id
        self._path = path
        self._inode = inode

    @staticmethod
    async def open(path: str) -> "File":
        sim, node_id = _sim(), _here()
        inode = sim._node_fs(node_id).get(str(path))
        if inode is None:
            raise FileNotFoundError(f"file not found: {path}")
        return File(sim, node_id, str(path), inode)

    @staticmethod
    async def create(path: str) -> "File":
        sim, node_id = _sim(), _here()
        node_fs = sim._node_fs(node_id)
        inode = node_fs.get(str(path))
        if inode is None:
            inode = _INode()
            node_fs[str(path)] = inode
        else:
            # O_CREAT|O_TRUNC over an EXISTING path truncates the
            # content (an unsynced change like any write), but must not
            # discard the inode's durable history: replacing the inode
            # here used to reset `synced`/`ever_synced`, so a power
            # failure after re-create LOST a path whose directory entry
            # was already durable — recovery saw nothing where a real
            # disk still holds the last-synced content
            del inode.data[:]
        return File(sim, node_id, str(path), inode)

    async def read_at(self, buf_len: int, offset: int) -> bytes:
        if offset < 0 or buf_len < 0:
            raise ValueError("negative offset or length")
        data = self._inode.data
        return bytes(data[offset : offset + buf_len])

    async def read_exact_at(self, buf_len: int, offset: int) -> bytes:
        data = await self.read_at(buf_len, offset)
        if len(data) < buf_len:
            raise EOFError("failed to fill whole buffer")
        return data

    async def read_to_end(self) -> bytes:
        return bytes(self._inode.data)

    async def _pay_fault_latency(self) -> None:
        # DiskFault degraded window: each write on a faulted node pays
        # the clause's extra_us of virtual latency (set_disk_fault)
        extra = self._sim.disk_fault_extra_ns(self._node_id)
        if extra > 0:
            from .core.vtime import Sleep

            time = self._sim.time
            await Sleep(time.now_ns() + extra, time)

    async def write_all_at(self, buf: bytes, offset: int) -> None:
        if offset < 0:
            raise ValueError("negative offset")
        await self._pay_fault_latency()
        data = self._inode.data
        if offset > len(data):
            data.extend(b"\x00" * (offset - len(data)))
        data[offset : offset + len(buf)] = buf
        self._sim._last_write[self._node_id] = self._path

    async def set_len(self, size: int) -> None:
        await self._pay_fault_latency()
        data = self._inode.data
        if size <= len(data):
            del data[size:]
        else:
            data.extend(b"\x00" * (size - len(data)))
        self._sim._last_write[self._node_id] = self._path

    async def sync_all(self) -> None:
        if self._sim.disk_fault_extra_ns(self._node_id) > 0:
            # the dying disk refuses durability: an app that treats this
            # EIO as success (or never looks) is the ack-before-fsync
            # bug class the DiskFault clause exists to surface
            raise OSError(errno.EIO, "fsync failed: injected disk fault")
        self._inode.synced = bytes(self._inode.data)
        self._inode.ever_synced = True

    async def metadata(self) -> Metadata:
        return Metadata(len(self._inode.data))


async def read(path: str) -> bytes:
    f = await File.open(path)
    return await f.read_to_end()


async def write(path: str, data: bytes) -> None:
    f = await File.create(path)
    await f.write_all_at(bytes(data), 0)


async def remove_file(path: str) -> None:
    sim, node_id = _sim(), _here()
    if sim._node_fs(node_id).pop(str(path), None) is None:
        raise FileNotFoundError(f"file not found: {path}")


async def metadata(path: str) -> Metadata:
    f = await File.open(path)
    return await f.metadata()
