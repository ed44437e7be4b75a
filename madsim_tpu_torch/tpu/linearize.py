"""Per-key linearizability checking over recorded KV histories.

A copy of `madsim_tpu/tpu/linearize.py` (numpy only; the port imports
nothing of the JAX package), reading the port's node state: history leaves
may be torch tensors on any device, and only the checked lane's rows are
copied to the host. tests/test_torch_kv.py holds it equal to the original
on the same histories.

The device oracle (tpu/kv.py check_invariants) is a cheap per-step net:
real-time revision monotonicity + same-revision value coherence + max-rev
watermarks. Those are necessary conditions, not linearizability — e.g. a
read that observes a value BEFORE the write that produced it even started
(a "future read") carries a perfectly monotone revision and passes. This
module is the real checker (SURVEY §7 step 5 / BASELINE config #4: "etcd
linearizability under partitions"), run host-side by `run_batch` on
violating lanes plus a sampled clean subset.

Method: linearizability is compositional over keys (Herlihy & Wing) and the
KV's registers are independent, so each key is checked alone as an atomic
register history. Client writes carry globally unique values
(nid * 100_000 + counter), so each read maps to at most one write, and the
Wing-Gong depth-first search with memoization decides the key's history
exactly; the concurrency frontier is bounded by the client count (= N), so
the search is effectively linear in ops.

Honest limits, by construction of the recorded histories:
  * only ACKED ops are recorded, so a read may observe a value whose write
    record was never acked (client timed out but the write committed) or
    was evicted from the bounded history ring. Such reads cannot be placed
    against a witness write and are EXCLUDED from the search (reported as
    `unmatched_reads`); the device-side watermark oracle still covers their
    revision ordering.
  * ops are timestamped with the lane's rebased offsets; all entries shift
    together (kv time_fields), so intervals are mutually consistent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Op:
    tinv: int
    trsp: int
    is_write: bool
    key: int
    val: int
    rev: int
    node: int  # recording node (diagnostics)

    def __str__(self) -> str:
        k = "W" if self.is_write else "R"
        return (
            f"{k}(key={self.key}, val={self.val}, rev={self.rev}) "
            f"@[{self.tinv}, {self.trsp}] node{self.node}"
        )


OP_READ, OP_WRITE = 1, 2  # mirrors tpu/kv.py


def _lane(leaf, lane: int) -> np.ndarray:
    """One lane's rows of a [L, ...] leaf as numpy (a torch tensor is
    indexed on its device first, so only that lane is copied)."""
    if hasattr(leaf, "detach"):
        return leaf[lane].detach().cpu().numpy()
    return np.asarray(leaf)[lane]


def extract_ops(node, lane: int) -> List[Op]:
    """Pull one lane's acked ops out of the KvState history rings.

    `node` is the engine's node pytree (leaves [L, N, ...]); entries with
    kind == 0 are empty ring slots.
    """
    kind = _lane(node.h_kind, lane)  # [N, OPS]
    key = _lane(node.h_key, lane)
    val = _lane(node.h_val, lane)
    rev = _lane(node.h_rev, lane)
    tinv = _lane(node.h_tinv, lane)
    trsp = _lane(node.h_trsp, lane)
    N, OPS = kind.shape
    ops = []
    for n in range(N):
        for i in range(OPS):
            if kind[n, i] > 0:
                ops.append(
                    Op(
                        tinv=int(tinv[n, i]), trsp=int(trsp[n, i]),
                        is_write=int(kind[n, i]) == OP_WRITE,
                        key=int(key[n, i]), val=int(val[n, i]),
                        rev=int(rev[n, i]), node=n,
                    )
                )
    return ops


def check_key_history(ops: List[Op]) -> Tuple[bool, Optional[List[Op]], int]:
    """Wing-Gong linearizability for one key's register history.

    Returns (linearizable, counterexample_suffix_or_None, unmatched_reads).
    The register's initial value is 0 (reads of val 0 with no witness write
    are reads of the initial state).
    """
    writes_by_val: Dict[int, Op] = {}
    for o in ops:
        if o.is_write:
            if o.val in writes_by_val:
                # duplicate write values break read->write matching; the kv
                # spec guarantees uniqueness (nid * 100_000 + counter), so
                # a duplicate is itself a finding — report it as a failed
                # key rather than crash the whole lane_check pass (and
                # unlike an assert, this survives python -O)
                return False, [writes_by_val[o.val], o], 0
            writes_by_val[o.val] = o

    checked: List[Op] = []
    unmatched = 0
    for o in ops:
        if o.is_write or o.val == 0 or o.val in writes_by_val:
            checked.append(o)
        else:
            unmatched += 1  # read of an unacked/evicted write: no witness

    n = len(checked)
    if n == 0:
        return True, None, unmatched
    order = sorted(range(n), key=lambda i: (checked[i].tinv, checked[i].trsp))
    checked = [checked[i] for i in order]

    # Wing-Gong DFS: linearize one op at a time. An op may go next iff no
    # other remaining op RESPONDED before it was invoked (real-time order).
    # State = (remaining-mask, register value); memoize failures.
    full = (1 << n) - 1
    seen = set()

    def dfs(remaining: int, value: int) -> bool:
        if remaining == 0:
            return True
        if (remaining, value) in seen:
            return False
        # the real-time frontier: ops whose invocation precedes every
        # remaining op's response
        min_trsp = min(
            checked[i].trsp for i in range(n) if remaining >> i & 1
        )
        for i in range(n):
            if not (remaining >> i & 1):
                continue
            o = checked[i]
            if o.tinv > min_trsp:
                break  # sorted by tinv: no later op can be minimal either
            if not o.is_write and o.val != value:
                continue  # read must return the current register value
            nxt = value if not o.is_write else o.val
            if dfs(remaining & ~(1 << i), nxt):
                return True
        seen.add((remaining, value))
        return False

    import sys

    limit = sys.getrecursionlimit()
    if n + 50 > limit:
        sys.setrecursionlimit(n + 100)
    try:
        ok = dfs(full, 0)
    finally:
        sys.setrecursionlimit(limit)
    if ok:
        return True, None, unmatched
    return False, checked, unmatched


def check_lane(node, lane: int) -> dict:
    """Full per-key linearizability verdict for one lane's history."""
    ops = extract_ops(node, lane)
    by_key: Dict[int, List[Op]] = {}
    for o in ops:
        by_key.setdefault(o.key, []).append(o)
    failures = []
    unmatched_total = 0
    for k, key_ops in sorted(by_key.items()):
        ok, ce, unmatched = check_key_history(key_ops)
        unmatched_total += unmatched
        if not ok:
            failures.append({
                "key": k,
                "ops": [str(o) for o in ce],
            })
    return {
        "lane": lane,
        "ops_checked": len(ops) - unmatched_total,
        "unmatched_reads": unmatched_total,
        "keys": len(by_key),
        "linearizable": not failures,
        "violations": len(failures),
        "failures": failures,
    }


def check_lanes(node, lanes) -> dict:
    """Aggregate check over several lanes (run_batch's oracle hook)."""
    results = [check_lane(node, int(lane)) for lane in lanes]
    bad = [r for r in results if not r["linearizable"]]
    return {
        "histories_checked": len(results),
        "ops_checked": sum(r["ops_checked"] for r in results),
        "unmatched_reads": sum(r["unmatched_reads"] for r in results),
        "non_linearizable_lanes": [r["lane"] for r in bad],
        "violations": len(bad),
        "failures": [f for r in bad for f in r["failures"]][:8],
    }
