"""The network graph: nodes, IPs, sockets, clogs, loss and latency.

Analog of reference madsim/src/sim/net/network.rs:20-313. Pure bookkeeping +
RNG rolls; all *delivery* happens via timers scheduled by `NetSim`.

On the TPU batched backend the same state lives as tensors — link masks
`[lane, node, node]` (SimState.link_ok), per-lane loss/latency draws — see
`madsim_tpu_torch/tpu/engine.py`; this class is the single-lane host semantics.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, Set, Tuple

from ..core.config import NetConfig
from ..core.rng import GlobalRng
from .addr import (
    SocketAddr,
    UNSPECIFIED,
    format_addr,
    is_loopback,
    is_unspecified,
)

NodeId = int
# protocols are plain strings: "udp" | "tcp"
Protocol_ = str


class Socket(Protocol):
    """Receiver side of a bound address (reference network.rs:51-64)."""

    def deliver(self, src: SocketAddr, dst: SocketAddr, msg: object) -> None: ...

    def new_connection(self, src: SocketAddr, dst: SocketAddr, tx, rx) -> None: ...


class Direction:
    IN = "in"
    OUT = "out"
    BOTH = "both"


class Stat:
    """Network statistics (reference network.rs:99-105)."""

    def __init__(self) -> None:
        self.msg_count = 0

    def __repr__(self) -> str:
        return f"Stat(msg_count={self.msg_count})"


class _NetNode:
    __slots__ = ("ip", "sockets")

    def __init__(self) -> None:
        self.ip: Optional[str] = None
        self.sockets: Dict[Tuple[SocketAddr, Protocol_], Socket] = {}


class AddrInUse(OSError):
    pass


class AddrNotAvailable(OSError):
    pass


class ConnectionRefused(ConnectionRefusedError):
    pass


class Network:
    def __init__(self, rng: GlobalRng, config: NetConfig) -> None:
        self.rng = rng
        self.config = config
        self.stat = Stat()
        self.nodes: Dict[NodeId, _NetNode] = {}
        self.addr_to_node: Dict[str, NodeId] = {}
        self.clogged_node_in: Set[NodeId] = set()
        self.clogged_node_out: Set[NodeId] = set()
        self.clogged_link: Set[Tuple[NodeId, NodeId]] = set()

    def update_config(self, config: NetConfig) -> None:
        self.config = config

    def insert_node(self, id: NodeId) -> None:
        self.nodes.setdefault(id, _NetNode())

    def reset_node(self, id: NodeId) -> None:
        node = self.nodes.get(id)
        if node is not None:
            node.sockets.clear()

    def set_ip(self, id: NodeId, ip: str) -> None:
        node = self.nodes[id]
        if node.ip is not None:
            self.addr_to_node.pop(node.ip, None)
        if ip in self.addr_to_node and self.addr_to_node[ip] != id:
            raise ValueError(f"IP conflict: {ip} already assigned to node {self.addr_to_node[ip]}")
        node.ip = ip
        self.addr_to_node[ip] = id

    def get_ip(self, id: NodeId) -> Optional[str]:
        node = self.nodes.get(id)
        return node.ip if node else None

    # -- clogging (partitions) --

    def clog_node(self, id: NodeId, direction: str = Direction.BOTH) -> None:
        assert id in self.nodes, "node not found"
        if direction in (Direction.IN, Direction.BOTH):
            self.clogged_node_in.add(id)
        if direction in (Direction.OUT, Direction.BOTH):
            self.clogged_node_out.add(id)

    def unclog_node(self, id: NodeId, direction: str = Direction.BOTH) -> None:
        assert id in self.nodes, "node not found"
        if direction in (Direction.IN, Direction.BOTH):
            self.clogged_node_in.discard(id)
        if direction in (Direction.OUT, Direction.BOTH):
            self.clogged_node_out.discard(id)

    def clog_link(self, src: NodeId, dst: NodeId) -> None:
        assert src in self.nodes and dst in self.nodes, "node not found"
        self.clogged_link.add((src, dst))

    def unclog_link(self, src: NodeId, dst: NodeId) -> None:
        self.clogged_link.discard((src, dst))

    def link_clogged(self, src: NodeId, dst: NodeId) -> bool:
        return (
            src in self.clogged_node_out
            or dst in self.clogged_node_in
            or (src, dst) in self.clogged_link
        )

    # -- sockets --

    def bind(
        self, node_id: NodeId, addr: SocketAddr, protocol: Protocol_, socket: Socket
    ) -> SocketAddr:
        node = self.nodes[node_id]
        ip, port = addr
        if (
            not is_unspecified(ip)
            and not is_loopback(ip)
            and node.ip is not None
            and ip != node.ip
        ):
            raise AddrNotAvailable(f"invalid address: {format_addr(addr)}")
        if port == 0:
            port = next(
                (
                    p
                    for p in range(1, 65536)
                    if ((ip, p), protocol) not in node.sockets
                ),
                None,
            )
            if port is None:
                raise AddrInUse("no available ephemeral port")
        key = ((ip, port), protocol)
        if key in node.sockets:
            raise AddrInUse(f"address already in use: {ip}:{port}")
        node.sockets[key] = socket
        return (ip, port)

    def close(self, node_id: NodeId, addr: SocketAddr, protocol: Protocol_) -> None:
        node = self.nodes.get(node_id)
        if node is not None:
            node.sockets.pop((addr, protocol), None)

    # -- the rolls --

    def test_link(self, src: NodeId, dst: NodeId) -> Optional[int]:
        """Latency in ns, or None on clog/loss (reference network.rs:261-269).

        Nemesis message-level clauses ride here too: the extra loss coin
        (FaultPlan MsgLoss, counted per fire) and the latency-spike window
        (additive extra latency while a NemesisDriver holds a spike open).
        """
        if self.link_clogged(src, dst):
            return None
        if self.config.packet_loss_rate > 0.0 and self.rng.gen_bool(
            self.config.packet_loss_rate
        ):
            return None
        if self.config.packet_extra_loss_rate > 0.0:
            # schedule-matched when a NemesisDriver installed ScheduleCoins
            hit = (
                self.config.coins.loss(self.config.packet_extra_loss_rate)
                if self.config.coins is not None
                else self.rng.gen_bool(self.config.packet_extra_loss_rate)
            )
            if hit:
                self.config.count_fire("loss")
                return None
        self.stat.msg_count += 1
        lo = round(self.config.send_latency_min * 1e9)
        hi = round(self.config.send_latency_max * 1e9)
        latency = self.rng.randrange(lo, max(hi, lo + 1))
        if self.config.spike_extra_latency > 0.0:
            latency += round(self.config.spike_extra_latency * 1e9)
        return latency

    def resolve_dest_node(
        self, node: NodeId, dst: SocketAddr, protocol: Protocol_
    ) -> Optional[NodeId]:
        node0 = self.nodes[node]
        if is_loopback(dst[0]) or (dst, protocol) in node0.sockets:
            return node
        if node0.ip is None:
            return None
        return self.addr_to_node.get(dst[0])

    def try_send(
        self, node: NodeId, dst: SocketAddr, protocol: Protocol_
    ) -> Optional[Tuple[str, NodeId, Socket, int]]:
        """Resolve + roll; returns (src_ip, dst_node, socket, latency_ns)."""
        dst_node = self.resolve_dest_node(node, dst, protocol)
        if dst_node is None:
            return None
        latency = self.test_link(node, dst_node)
        if latency is None:
            return None
        sockets = self.nodes[dst_node].sockets
        sock = sockets.get((dst, protocol)) or sockets.get(
            ((UNSPECIFIED, dst[1]), protocol)
        )
        if sock is None:
            return None
        src_ip = "127.0.0.1" if is_loopback(dst[0]) else self.nodes[node].ip
        if src_ip is None:
            return None
        return (src_ip, dst_node, sock, latency)
