"""Endpoint: tag-matched message passing — the substrate every shim rides on.

Analog of reference madsim/src/sim/net/endpoint.rs:13-583. An `Endpoint`
binds an address and exchanges *tagged* messages: `send_to(dst, tag, bytes)` /
`recv_from(tag)` with mailbox tag-matching (endpoint.rs:329-361), raw payload
variants carrying arbitrary Python objects (the `Box<dyn Any>` analog used by
all ecosystem sims), and reliable ordered connections `connect1`/`accept1`.

Since Python has no RAII, `BindGuard` exposes explicit `close()` (also called
from node reset); endpoints are context managers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core import context
from ..core.futures import Future
from ..core.plugin import simulator
from ..core.sync import Channel
from .addr import SocketAddr, ToSocketAddrs, lookup_host
from .netsim import NetSim, Payload, PayloadReceiver, PayloadSender

UDP = "udp"


class _Message:
    __slots__ = ("tag", "data", "from_addr")

    def __init__(self, tag: int, data: Payload, from_addr: SocketAddr) -> None:
        self.tag = tag
        self.data = data
        self.from_addr = from_addr


# Max dead one-shot tags remembered per mailbox; beyond this the oldest are
# evicted (their late responses, if any, park as ordinary messages).
_DEAD_TAG_CAP = 4096


class Mailbox:
    """Tag-matching mailbox (reference endpoint.rs:329-361).

    `forget(tag)` prunes state for one-shot tags nobody will ever read again
    (e.g. the unique response tag of a timed-out rpc call): parked messages
    and registrations are dropped, and a late-arriving message for the tag is
    discarded on delivery instead of parking forever.
    """

    def __init__(self) -> None:
        self.registered: List[Tuple[int, Future[_Message]]] = []
        self.msgs: List[_Message] = []
        self.dead_tags: Dict[int, None] = {}  # insertion-ordered set

    def deliver(self, msg: _Message) -> None:
        for i, (tag, fut) in enumerate(self.registered):
            if tag == msg.tag and fut.try_set_result(msg):
                self.registered.pop(i)
                return
        self.registered = [
            (t, f) for t, f in self.registered if not (f.done() or f.abandoned())
        ]
        if msg.tag in self.dead_tags:
            # a one-shot tag is sent to at most once: drop and forget
            del self.dead_tags[msg.tag]
            return
        self.msgs.append(msg)

    def recv(self, tag: int) -> Future[_Message]:
        fut: Future[_Message] = Future()
        for i, msg in enumerate(self.msgs):
            if msg.tag == tag:
                self.msgs.pop(i)
                fut.set_result(msg)
                return fut
        self.registered.append((tag, fut))
        return fut

    def forget(self, tag: int) -> None:
        self.msgs = [m for m in self.msgs if m.tag != tag]
        self.registered = [(t, f) for t, f in self.registered if t != tag]
        self.dead_tags[tag] = None
        while len(self.dead_tags) > _DEAD_TAG_CAP:
            del self.dead_tags[next(iter(self.dead_tags))]


class EndpointSocket:
    """The `Socket` bound into the network for an Endpoint."""

    def __init__(self) -> None:
        self.mailbox = Mailbox()
        self.conn_chan: Channel = Channel()  # (tx, rx, from_addr)

    def deliver(self, src: SocketAddr, dst: SocketAddr, msg: Payload) -> None:
        tag, data = msg
        self.mailbox.deliver(_Message(tag, data, src))

    def new_connection(
        self, src: SocketAddr, dst: SocketAddr, tx: PayloadSender, rx: PayloadReceiver
    ) -> None:
        try:
            self.conn_chan.send_nowait((tx, rx, src))
        except Exception:
            pass  # endpoint closed: refuse silently (peer sees EOF)


class BindGuard:
    """Holds a bound (node, addr, protocol) registration; explicit close
    (reference net/mod.rs:436-494 uses Drop)."""

    def __init__(self, net: NetSim, node_id: int, addr: SocketAddr, protocol: str) -> None:
        self.net = net
        self.node_id = node_id
        self.addr = addr
        self.protocol = protocol
        self._closed = False

    @staticmethod
    async def bind(
        addr: ToSocketAddrs, protocol: str, socket: Any
    ) -> "BindGuard":
        net = simulator(NetSim)
        node_id = context.current_task().node.id
        resolved = await lookup_host(addr)
        bound = net.network.bind(node_id, resolved, protocol, socket)
        return BindGuard(net, node_id, bound, protocol)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.net.network.close(self.node_id, self.addr, self.protocol)


def _no_production_mode() -> None:
    raise NotImplementedError(
        "Endpoint outside a simulation is production mode (RealEndpoint over "
        "real TCP), which madsim_tpu_torch does not port yet (ROADMAP item "
        "16b)"
    )


class Endpoint:
    """Tag-matched datagrams + reliable connections on a bound address."""

    def __init__(self, guard: BindGuard, socket: EndpointSocket) -> None:
        self._guard = guard
        self._socket = socket
        self._peer: Optional[SocketAddr] = None

    # -- constructors --

    @staticmethod
    async def bind(addr: ToSocketAddrs) -> "Endpoint":
        if context.try_current_handle() is None:
            _no_production_mode()
        socket = EndpointSocket()
        guard = await BindGuard.bind(addr, UDP, socket)
        return Endpoint(guard, socket)

    @staticmethod
    async def connect(addr: ToSocketAddrs) -> "Endpoint":
        if context.try_current_handle() is None:
            _no_production_mode()
        peer = await lookup_host(addr)
        ep = await Endpoint.bind(("0.0.0.0", 0))
        ep._peer = peer
        return ep

    # -- properties --

    def local_addr(self) -> SocketAddr:
        return self._guard.addr

    def peer_addr(self) -> SocketAddr:
        if self._peer is None:
            raise OSError("not connected")
        return self._peer

    @property
    def net(self) -> NetSim:
        return self._guard.net

    @property
    def node_id(self) -> int:
        return self._guard.node_id

    def close(self) -> None:
        self._guard.close()
        self._socket.conn_chan.close()

    def __enter__(self) -> "Endpoint":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    # -- tagged datagrams --

    async def send_to(self, dst: ToSocketAddrs, tag: int, buf: bytes) -> None:
        resolved = await lookup_host(dst)
        await self.send_to_raw(resolved, tag, bytes(buf))

    async def recv_from(self, tag: int) -> Tuple[bytes, SocketAddr]:
        data, from_addr = await self.recv_from_raw(tag)
        if not isinstance(data, (bytes, bytearray)):
            raise TypeError("message is not data")
        return bytes(data), from_addr

    async def send(self, tag: int, buf: bytes) -> None:
        await self.send_to(self.peer_addr(), tag, buf)

    async def recv(self, tag: int) -> bytes:
        peer = self.peer_addr()
        data, from_addr = await self.recv_from(tag)
        if from_addr != peer:
            raise OSError(
                f"received a message from {from_addr}, not from the connected "
                f"address {peer}"
            )
        return data

    # -- raw payloads (used by ecosystem sims) --

    async def send_to_raw(self, dst: SocketAddr, tag: int, data: Payload) -> None:
        await self.net.send(
            self.node_id, self.local_addr()[1], dst, UDP, (tag, data)
        )

    async def recv_from_raw(self, tag: int) -> Tuple[Payload, SocketAddr]:
        msg = await self._socket.mailbox.recv(tag)
        await self.net.rand_delay()
        return msg.data, msg.from_addr

    def forget_tag(self, tag: int) -> None:
        """Drop all mailbox state for a one-shot tag nobody will read again."""
        self._socket.mailbox.forget(tag)

    # -- reliable connections --

    async def connect1(
        self, dst: ToSocketAddrs
    ) -> Tuple[PayloadSender, PayloadReceiver, SocketAddr]:
        resolved = await lookup_host(dst)
        return await self.net.connect1(
            self.node_id, self.local_addr()[1], resolved, UDP
        )

    async def accept1(self) -> Tuple[PayloadSender, PayloadReceiver, SocketAddr]:
        return await self.conn_chan_recv()

    async def conn_chan_recv(self) -> Tuple[PayloadSender, PayloadReceiver, SocketAddr]:
        return await self._socket.conn_chan.recv()
