"""NetSim: the network simulator plugin + chaos API.

Analog of reference madsim/src/sim/net/mod.rs:84-494. Owns the `Network`
graph, DNS records, IPVS table, and RPC drop-hooks. Every message ride is:

    rand_delay (0-5 us, buggify 10% => 1-5 s)
    -> request hook (may drop)
    -> IPVS rewrite
    -> Network.try_send (clog? loss? latency roll)
    -> timer at now+latency fires response hook + socket.deliver

Connections (`connect1`) are paired reliable ordered channels whose receiver
re-tests the link per message with exponential backoff (1 ms doubling to 10 s)
while it is clogged, mirroring net/mod.rs:337-405.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.buggify import buggify_with_prob
from ..core.config import Config
from ..core.plugin import Simulator
from ..core.rng import GlobalRng
from ..core.sync import Channel, ChannelClosed
from ..core.vtime import TimeHandle
from .addr import SocketAddr, format_addr
from .ipvs import Ipvs, ServiceAddr
from .network import Direction, Network, NodeId, Socket, Stat

Payload = Any
# a message hook returns False to drop the message (net/mod.rs:245-284)
Hook = Callable[[Payload], bool]


class PayloadSender:
    """Send half of a reliable ordered connection."""

    __slots__ = ("_test_link", "_chan")

    def __init__(self, test_link: Callable[[], Optional[int]], chan: Channel) -> None:
        self._test_link = test_link
        self._chan = chan

    def send(self, payload: Payload) -> None:
        """Queue a message; raises ChannelClosed if the peer is gone."""
        # roll the link at send time; None = link down at send (receiver
        # will retry with backoff)
        state = self._test_link()
        self._chan.send_nowait((payload, state))

    def is_closed(self) -> bool:
        return self._chan.closed

    def close(self) -> None:
        self._chan.close()


class PayloadReceiver:
    """Receive half of a reliable ordered connection."""

    __slots__ = ("_test_link", "_chan", "_time")

    def __init__(
        self,
        test_link: Callable[[], Optional[int]],
        chan: Channel,
        time: TimeHandle,
    ) -> None:
        self._test_link = test_link
        self._chan = chan
        self._time = time

    async def recv(self) -> Payload:
        """Next message; raises ChannelClosed on disconnect (EOF)."""
        from ..core.vtime import Sleep

        value, arrive_ns = await self._chan.recv()
        backoff_ns = 1_000_000  # 1 ms
        while arrive_ns is None:
            # link was down when sent: retry until it heals
            await Sleep(self._time.now_ns() + backoff_ns, self._time)
            backoff_ns = min(backoff_ns * 2, 10_000_000_000)
            arrive_ns = self._test_link()
        if arrive_ns > self._time.now_ns():
            await Sleep(arrive_ns, self._time)
        return value

    async def try_recv_eof(self) -> Optional[Payload]:
        """Like recv() but returns None on disconnect."""
        try:
            return await self.recv()
        except ChannelClosed:
            return None

    def close(self) -> None:
        self._chan.close()


# bound on retained lineage events/edges: a long soak must not grow host
# memory without bound; overflow is counted, never silent
MAX_LINEAGE_EDGES = 100_000


class HostLineage:
    """The host runtime's Lamport mirror of the device lineage plane
    (madsim_tpu_torch/causal.py, docs/causality.md).

    The device engine attributes a send to its emitting handler EVENT;
    the host runtime has no handler-event notion, so a send is its own
    Lamport event (the classic process model): `on_send` ticks the
    node's clock and allocates the next runtime-global event id,
    `on_deliver` updates `max(local, send event id) + 1` — the SAME
    sender-value vocabulary as the engine's in-jit update (the message
    carries its send EVENT's id), so one law checker
    (`causal.check_host_lineage`) validates both faces. Clocks survive
    node resets (a Lamport clock is observer metadata, not node state —
    the device's `lin.lam` likewise survives crash-with-wipe).

    OPT-IN, like the device plane (`BatchedSim(lineage=True)` costs zero
    when off): call `enable()` BEFORE traffic starts — e.g.
    `Handle.current().metrics().lineage().enable()` at the top of the
    root task. Disabled (the default), the delivery path pays two
    truthiness checks and retains nothing."""

    def __init__(self) -> None:
        self.enabled = False
        self.lam: Dict[NodeId, int] = {}
        self.next_eid = 0
        # (eid, node, lam-after, kind) rows, eid order; bounded
        self.events: List[tuple] = []
        self.edges: List[tuple] = []  # (send_eid, deliver_eid)
        self.dropped = 0

    def enable(self) -> "HostLineage":
        self.enabled = True
        return self

    def on_send(self, node: NodeId) -> int:
        if not self.enabled:
            return -1
        lam = self.lam.get(node, 0) + 1
        self.lam[node] = lam
        eid = self.next_eid
        self.next_eid += 1
        self._record(eid, node, lam, "send")
        return eid

    def on_deliver(self, node: NodeId, send_eid: int) -> int:
        if not self.enabled or send_eid < 0:
            # send_eid < 0: the message was stamped before enable() —
            # skip rather than record a half-history edge
            return -1
        lam = max(self.lam.get(node, 0), send_eid) + 1
        self.lam[node] = lam
        eid = self.next_eid
        self.next_eid += 1
        if len(self.edges) < MAX_LINEAGE_EDGES:
            self.edges.append((send_eid, eid))
        else:
            self.dropped += 1
        self._record(eid, node, lam, "deliver")
        return eid

    def _record(self, eid: int, node: NodeId, lam: int, kind: str) -> None:
        if len(self.events) < 2 * MAX_LINEAGE_EDGES:
            self.events.append((eid, node, lam, kind))
        else:
            self.dropped += 1


class NetSim(Simulator):
    """Network simulator + chaos API (net/mod.rs:126-284)."""

    def __init__(self, rng: GlobalRng, time: TimeHandle, config: Config) -> None:
        super().__init__(rng, time, config)
        self.rng = rng
        self.time = time
        self.network = Network(rng, config.net)
        self.ipvs = Ipvs()
        self._dns: Dict[str, str] = {}
        self._hooks_req: Dict[NodeId, Hook] = {}
        self._hooks_rsp: Dict[NodeId, Hook] = {}
        # channels owned by each node, closed on reset (the analog of task
        # drop closing connection halves on kill)
        self._node_channels: Dict[NodeId, List[Channel]] = {}
        # Lamport mirror over the datagram delivery path (docs/causality.md)
        self.lineage = HostLineage()

    @staticmethod
    def current() -> "NetSim":
        """The current simulation's NetSim (reference `NetSim::current()`)."""
        from ..core.plugin import simulator

        return simulator(NetSim)

    # -- plugin lifecycle --

    def create_node(self, node_id: NodeId) -> None:
        self.network.insert_node(node_id)
        if self.network.get_ip(node_id) is None:
            # auto-assign a unique IP so nodes are reachable without explicit
            # `.ip()` calls (the reference requires explicit IPs; auto-assign
            # from 192.168.0.0/16 is a usability extension — `.ip()` overrides)
            n = node_id
            while True:
                candidate = f"192.168.{(n // 256) % 256}.{n % 256}"
                if candidate not in self.network.addr_to_node:
                    break
                n += 1
            self.network.set_ip(node_id, candidate)

    def reset_node(self, node_id: NodeId) -> None:
        self.network.reset_node(node_id)
        for chan in self._node_channels.pop(node_id, []):
            chan.close()

    # -- chaos API --

    def update_config(self, config) -> None:
        self.network.update_config(config)

    def stat(self) -> Stat:
        return self.network.stat

    def clog_node(self, id: NodeId, direction: str = Direction.BOTH) -> None:
        self.network.clog_node(id, direction)

    def unclog_node(self, id: NodeId, direction: str = Direction.BOTH) -> None:
        self.network.unclog_node(id, direction)

    def clog_link(self, src: NodeId, dst: NodeId) -> None:
        self.network.clog_link(src, dst)

    def unclog_link(self, src: NodeId, dst: NodeId) -> None:
        self.network.unclog_link(src, dst)

    def partition(self, group_a: List[NodeId], group_b: List[NodeId]) -> None:
        """Clog every link between the two groups (both directions)."""
        for a in group_a:
            for b in group_b:
                self.network.clog_link(a, b)
                self.network.clog_link(b, a)

    def heal_partition(self, group_a: List[NodeId], group_b: List[NodeId]) -> None:
        for a in group_a:
            for b in group_b:
                self.network.unclog_link(a, b)
                self.network.unclog_link(b, a)

    def set_ip(self, node_id: NodeId, ip: str) -> None:
        self.network.insert_node(node_id)
        self.network.set_ip(node_id, ip)

    def get_ip(self, node_id: NodeId) -> Optional[str]:
        return self.network.get_ip(node_id)

    # -- DNS (dns.rs:6-26) --

    def add_dns_record(self, name: str, ip: str) -> None:
        self._dns[name] = ip

    def dns_lookup(self, name: str) -> Optional[str]:
        return self._dns.get(name)

    # -- RPC hooks (net/mod.rs:245-284) --

    def hook_rpc_req(self, node: NodeId, hook: Optional[Hook]) -> None:
        """Install a hook on messages *sent by* node; return False to drop."""
        if hook is None:
            self._hooks_req.pop(node, None)
        else:
            self._hooks_req[node] = hook

    def hook_rpc_rsp(self, node: NodeId, hook: Optional[Hook]) -> None:
        """Install a hook on messages *delivered to* node; return False to drop."""
        if hook is None:
            self._hooks_rsp.pop(node, None)
        else:
            self._hooks_rsp[node] = hook

    # -- data path --

    async def rand_delay(self) -> None:
        """0-5 us random delay; 10% buggify => 1-5 s (net/mod.rs:287-295)."""
        from ..core.vtime import Sleep

        delay_ns = self.rng.randrange(0, 5_000)
        if buggify_with_prob(0.1):
            delay_ns = self.rng.randrange(1, 5) * 1_000_000_000
        if delay_ns:
            await Sleep(self.time.now_ns() + delay_ns, self.time)

    def _ipvs_rewrite(self, dst: SocketAddr, protocol: str) -> SocketAddr:
        addr: ServiceAddr = (dst[0], dst[1], protocol)
        server = self.ipvs.get_server(addr)
        if server is not None:
            host, _, port = server.rpartition(":")
            return (host, int(port))
        return dst

    async def send(
        self,
        node: NodeId,
        port: int,
        dst: SocketAddr,
        protocol: str,
        msg: Payload,
    ) -> None:
        """Datagram send: silently dropped on clog/loss (net/mod.rs:298-333).

        Nemesis message-level clauses (FaultPlan → NetConfig knobs):
        duplication re-delivers the datagram once more with an independent
        latency roll, and bounded reordering adds a uniform extra delay in
        [0, reorder_window] so later sends can overtake. Both apply to
        datagrams only — `connect1` channels are reliable ORDERED, the TCP
        face — mirroring the TPU engine's per-candidate dup/reorder rolls.
        """
        await self.rand_delay()
        hook = self._hooks_req.get(node)
        if hook is not None and not hook(msg):
            return
        dst = self._ipvs_rewrite(dst, protocol)
        cfg = self.network.config
        # the dup coin flips BEFORE the original's loss roll (mirroring the
        # engine, which coins every candidate): the copy's fate — its own
        # loss roll, its own latency — is independent of the original's.
        # With a NemesisDriver installed the coin is schedule-matched
        # (ScheduleCoins: pure in (seed, site, index)); otherwise ambient.
        dup = cfg.packet_duplicate_rate > 0.0 and (
            cfg.coins.dup(cfg.packet_duplicate_rate)
            if cfg.coins is not None
            else self.rng.gen_bool(cfg.packet_duplicate_rate)
        )
        if dup:
            cfg.count_fire("dup")
        # Lamport mirror (opt-in; -1 when disabled): the send is an event
        # whether or not any copy survives the link (the device's emitting
        # handler event likewise exists regardless of drops); duplicates
        # share it — one cause, two deliveries, the engine's dup semantics
        send_eid = self.lineage.on_send(node)
        result = self.network.try_send(node, dst, protocol)
        if result is None and not dup:
            return  # dropped, and no copy can survive it
        dst_node = (
            result[1]
            if result is not None
            else self.network.resolve_dest_node(node, dst, protocol)
        )
        rsp_hook = self._hooks_rsp.get(dst_node) if dst_node is not None else None

        def deliver_from(src_ip: str, socket) -> None:
            src = (src_ip, port)
            if rsp_hook is not None and not rsp_hook(msg):
                return
            if dst_node is not None:
                self.lineage.on_deliver(dst_node, send_eid)
            socket.deliver(src, dst, msg)

        def schedule(latency_ns: int, src_ip: str, socket) -> None:
            if cfg.packet_reorder_rate > 0.0 and cfg.packet_reorder_window > 0.0:
                hit = (
                    cfg.coins.reorder(cfg.packet_reorder_rate)
                    if cfg.coins is not None
                    else self.rng.gen_bool(cfg.packet_reorder_rate)
                )
                if hit:
                    cfg.count_fire("reorder")
                    span_ns = max(round(cfg.packet_reorder_window * 1e9), 1)
                    latency_ns += (
                        cfg.coins.reorder_extra(span_ns)
                        if cfg.coins is not None
                        else self.rng.randrange(0, span_ns)
                    )
            # absolute-deadline timers: network latency is wire time, never
            # subject to the sender's nemesis clock skew (vtime.sleep-side)
            self.time.add_timer_at_ns(
                self.time.now_ns() + latency_ns,
                lambda: deliver_from(src_ip, socket),
            )

        if result is not None:
            src_ip, _, socket, latency_ns = result
            schedule(latency_ns, src_ip, socket)
        if dup:
            copy = self.network.try_send(node, dst, protocol)
            if copy is not None:
                src_ip2, _, socket2, latency2 = copy
                schedule(latency2, src_ip2, socket2)

    async def connect1(
        self,
        node: NodeId,
        port: int,
        dst: SocketAddr,
        protocol: str,
    ) -> Tuple[PayloadSender, PayloadReceiver, SocketAddr]:
        """Open a reliable ordered connection (net/mod.rs:337-367).

        Raises ConnectionRefusedError when the peer is unreachable/clogged.
        """
        await self.rand_delay()
        dst = self._ipvs_rewrite(dst, protocol)
        result = self.network.try_send(node, dst, protocol)
        if result is None:
            raise ConnectionRefusedError(f"connection refused: {format_addr(dst)}")
        src_ip, dst_node, socket, _latency = result
        src = (src_ip, port)
        # each half is owned by BOTH endpoint nodes: killing either side
        # closes the connection (sender gets BrokenPipe, receiver gets EOF),
        # matching the reference where task drop closes the mpsc halves
        tx1, rx1 = self.channel(node, dst, protocol, owners=(node, dst_node))
        tx2, rx2 = self.channel(dst_node, src, protocol, owners=(node, dst_node))
        socket.new_connection(src, dst, tx2, rx1)
        return tx1, rx2, src

    def channel(
        self,
        node: NodeId,
        dst: SocketAddr,
        protocol: str,
        owners: Optional[Tuple[NodeId, ...]] = None,
    ) -> Tuple[PayloadSender, PayloadReceiver]:
        """A one-direction reliable channel from `node` toward `dst`
        (net/mod.rs:369-405): each message rolls the link at send time and
        arrives at now+latency; while clogged the receiver retries with
        exponential backoff. Reset of any owner node closes the channel."""
        chan: Channel = Channel()
        for owner in owners if owners is not None else (node,):
            self._node_channels.setdefault(owner, []).append(chan)

        def test_link() -> Optional[int]:
            result = self.network.try_send(node, dst, protocol)
            if result is None:
                return None
            return self.time.now_ns() + result[3]

        return (
            PayloadSender(test_link, chan),
            PayloadReceiver(test_link, chan, self.time),
        )
