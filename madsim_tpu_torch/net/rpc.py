"""Built-in typed RPC over Endpoint tag-matching (reference net/rpc.rs:73-167).

A request type declares itself with `@rpc_request` (analog of
`#[derive(Request)]`, madsim-macros/src/request.rs:32-68): it gets a stable
64-bit `RPC_ID` derived from its qualified name. `call` sends the request
under `RPC_ID` with a freshly drawn random response tag; the server handler
loop receives requests under `RPC_ID`, spawns one task per request, and sends
the response back under the response tag.
"""

from __future__ import annotations

import hashlib
from typing import Any, Awaitable, Callable, Optional, Tuple, Type

from ..core import context
from ..core import task as task_mod
from ..core.vtime import timeout as time_timeout
from .addr import ToSocketAddrs, lookup_host
from .endpoint import Endpoint


def hash_str(s: str) -> int:
    """Stable 64-bit id from a string (analog of request.rs hash_str)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "little")


def rpc_request(cls: type) -> type:
    """Class decorator assigning a stable RPC_ID (derive(Request) analog)."""
    cls.RPC_ID = hash_str(f"{cls.__module__}::{cls.__qualname__}")
    return cls


def _rpc_id(req_type: type) -> int:
    rpc_id = getattr(req_type, "RPC_ID", None)
    if rpc_id is None:
        raise TypeError(
            f"{req_type.__name__} is not an RPC request type; decorate it with @rpc_request"
        )
    return rpc_id


async def call(ep: Endpoint, dst: ToSocketAddrs, req: Any) -> Any:
    """Send a request and await its typed response (rpc.rs:108-111)."""
    rsp, _data = await call_with_data(ep, dst, req, b"")
    return rsp


async def call_timeout(ep: Endpoint, dst: ToSocketAddrs, req: Any, timeout: float) -> Any:
    return await time_timeout(timeout, call(ep, dst, req))


async def call_with_data(
    ep: Endpoint, dst: ToSocketAddrs, req: Any, data: bytes
) -> Tuple[Any, bytes]:
    """Request + raw data payload; returns (response, response data)."""
    handle = context.try_current_handle()
    if handle is not None:
        rsp_tag = handle.rng.next_u64()
    else:  # production mode: any unique tag works
        import os as _os

        # inside a sim, interpose patches os.urandom onto the seeded
        # GlobalRng; this branch is explicitly production-mode
        rsp_tag = int.from_bytes(_os.urandom(8), "little")  # madsim: allow(ambient-entropy)
    resolved = await lookup_host(dst)
    await ep.send_to_raw(resolved, _rpc_id(type(req)), (rsp_tag, req, bytes(data)))
    try:
        payload, _from = await ep.recv_from_raw(rsp_tag)
    finally:
        # the response tag is single-use: prune mailbox state so a timed-out
        # or cancelled call doesn't park its late response forever
        ep.forget_tag(rsp_tag)
    rsp, rsp_data = payload
    return rsp, rsp_data


def add_rpc_handler(
    ep: Endpoint,
    req_type: Type[Any],
    handler: Callable[[Any], Awaitable[Any]],
) -> None:
    """Serve `req_type` requests: one spawned task per request (rpc.rs:143-166)."""

    async def wrapped(req: Any, _data: bytes) -> Tuple[Any, bytes]:
        return await handler(req), b""

    add_rpc_handler_with_data(ep, req_type, wrapped)


def add_rpc_handler_with_data(
    ep: Endpoint,
    req_type: Type[Any],
    handler: Callable[[Any, bytes], Awaitable[Tuple[Any, bytes]]],
) -> None:
    rpc_id = _rpc_id(req_type)

    async def serve_loop() -> None:
        while True:
            payload, from_addr = await ep.recv_from_raw(rpc_id)
            rsp_tag, req, data = payload

            async def handle_one(rsp_tag=rsp_tag, req=req, data=data, from_addr=from_addr):
                rsp, rsp_data = await handler(req, data)
                await ep.send_to_raw(from_addr, rsp_tag, (rsp, bytes(rsp_data)))

            task_mod.spawn(handle_one(), name=f"rpc-{req_type.__name__}")

    task_mod.spawn(serve_loop(), name=f"rpc-serve-{req_type.__name__}")
