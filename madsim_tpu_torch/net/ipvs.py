"""IPVS: virtual-service load balancing (reference madsim/src/sim/net/ipvs.rs:10-105).

A virtual service address (vip:port/protocol) maps to a set of real server
addresses; `NetSim.send`/`connect1` consult it to rewrite destinations
(net/mod.rs:312-317, 345-349). Round-robin is the only scheduler, like the
reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ServiceAddr = Tuple[str, int, str]  # (vip, port, protocol)


class Scheduler:
    ROUND_ROBIN = "rr"


class _Service:
    __slots__ = ("scheduler", "servers", "next_idx")

    def __init__(self, scheduler: str) -> None:
        self.scheduler = scheduler
        self.servers: List[str] = []  # "ip:port" strings
        self.next_idx = 0


class Ipvs:
    def __init__(self) -> None:
        self._services: Dict[ServiceAddr, _Service] = {}

    def add_service(self, addr: ServiceAddr, scheduler: str = Scheduler.ROUND_ROBIN) -> None:
        self._services.setdefault(addr, _Service(scheduler))

    def del_service(self, addr: ServiceAddr) -> None:
        self._services.pop(addr, None)

    def add_server(self, addr: ServiceAddr, server: str) -> None:
        svc = self._services.get(addr)
        if svc is None:
            raise KeyError(f"service not found: {addr}")
        if server not in svc.servers:
            svc.servers.append(server)

    def del_server(self, addr: ServiceAddr, server: str) -> None:
        svc = self._services.get(addr)
        if svc is not None and server in svc.servers:
            svc.servers.remove(server)

    def get_server(self, addr: ServiceAddr) -> Optional[str]:
        svc = self._services.get(addr)
        if svc is None or not svc.servers:
            return None
        server = svc.servers[svc.next_idx % len(svc.servers)]
        svc.next_idx += 1
        return server
