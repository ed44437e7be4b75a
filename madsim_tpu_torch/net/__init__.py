"""Network simulation (reference madsim/src/sim/net/, ~2.5k LoC).

The port's copy of `madsim_tpu/net/`: addresses, the link model, IPVS, the
NetSim plugin with its host lineage, endpoints and typed RPC. The simulated
TCP, UDP and Unix sockets are not ported yet (ROADMAP item 16b): no host
twin of the port uses them.
"""

from .addr import SocketAddr, ToSocketAddrs, lookup_host  # noqa: F401
from .endpoint import Endpoint  # noqa: F401
from .ipvs import Ipvs, Scheduler, ServiceAddr  # noqa: F401
from .netsim import NetSim, PayloadReceiver, PayloadSender  # noqa: F401
from .network import Direction, Network, Stat  # noqa: F401
from .rpc import (  # noqa: F401
    add_rpc_handler,
    add_rpc_handler_with_data,
    call,
    call_timeout,
    call_with_data,
    rpc_request,
)
