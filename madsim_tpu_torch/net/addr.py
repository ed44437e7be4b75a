"""Socket addresses + hostname resolution through the simulated DNS.

Analog of reference madsim/src/sim/net/{addr.rs,dns.rs}. Addresses are
`(ip: str, port: int)` tuples; public APIs also accept `"ip:port"` /
`"host:port"` strings, resolving hostnames through the current `NetSim`'s
DNS records (reference addr.rs:241).
"""

from __future__ import annotations

from typing import Tuple, Union

SocketAddr = Tuple[str, int]
ToSocketAddrs = Union[str, SocketAddr]

UNSPECIFIED = "0.0.0.0"
LOCALHOST = "127.0.0.1"


def is_ip_literal(host: str) -> bool:
    parts = host.split(".")
    return len(parts) == 4 and all(p.isdigit() and int(p) <= 255 for p in parts)


def is_unspecified(ip: str) -> bool:
    return ip == UNSPECIFIED


def is_loopback(ip: str) -> bool:
    return ip.startswith("127.")


def split_host_port(addr: str) -> Tuple[str, int]:
    host, sep, port = addr.rpartition(":")
    if not sep:
        raise ValueError(f"invalid socket address: {addr!r} (expected host:port)")
    return host, int(port)


def format_addr(addr: SocketAddr) -> str:
    return f"{addr[0]}:{addr[1]}"


async def lookup_host(addr: ToSocketAddrs) -> SocketAddr:
    """Resolve to a concrete (ip, port); hostnames go through sim DNS."""
    if isinstance(addr, tuple):
        host, port = addr
    else:
        host, port = split_host_port(addr)
    if host == "localhost":
        return (LOCALHOST, port)
    if is_ip_literal(host):
        return (host, port)
    from ..core import context

    if context.try_current_handle() is None:
        raise NotImplementedError(
            "resolving a host name outside a simulation is production mode "
            "(real DNS), which madsim_tpu_torch does not port yet (ROADMAP "
            "item 16b)"
        )
    from .netsim import NetSim
    from ..core.plugin import simulator

    ip = simulator(NetSim).dns_lookup(host)
    if ip is None:
        raise OSError(f"failed to lookup address information: {host!r}")
    return (ip, port)
