"""Layout-independent trajectory digest, and the pinned reference runs.

`canonical_digest` is the repo's golden-digest function
(`tests/test_state_layout.py:canonical_digest`) over `convert.state_to_numpy`
output: every field widened to int64, packed planes unpacked, so equal
values give equal digests whatever the storage. `PINNED` holds the digests
of two reference runs (64 lanes, seeds 0..63), computed from the JAX engine
on the CPU and asserted against it by tests/test_torch_engine.py; any device
running the port must reproduce them.

`GOLDEN` holds the JAX package's own correctness anchor, copied verbatim
from `tests/test_state_layout.py`: one 16-lane, 1500-step run per workload
under `CHAOS_PLAN` (crash, partition and message-loss clauses lowered by
`compile_plan`). `golden_run(name)` builds the same run for the port.

`PINNED_BUNDLE` holds the `bundle_digest` (sha256 of the canonical JSON) of
the repro bundle the JAX face's shrinker writes for the planted re-stamp
Raft under Crash + Partition (`chip_smoke.triage_workload`, the bug and
plan of tests/test_triage.py), seed 0, `spec_ref`
"chip_smoke:planted_restamp_spec"; tests/test_torch_triage.py holds the
port's CPU shrink and the JAX face's to it.

`PINNED_LINEAGE` holds the `lineage_digest` (sha256 of the lineage leaves,
which `canonical_digest` ignores, as the JAX one does) of the Raft golden
run with `lineage=True`; that run's canonical digest stays `GOLDEN["raft"]`.
`PINNED_CAUSAL` is the causal-slice sha of the planted re-stamp bundle shrunk
with `causal=True`, and `PINNED_BUNDLE_V3` that whole bundle's digest (with
its causal field set to None it is `PINNED_BUNDLE`'s).
tests/test_torch_lineage.py and tests/test_torch_causal.py compute them
from the JAX face.

`PINNED_REFILL` holds the `refill_digest` (sha256 of the per-admission
rows of `engine.refill_results`) of `refill_run()`: the continuous-batching
spread mix (`spread_mix`, after `madsim_tpu/tune.py:499-552`) at 1 virtual
second, 256 admissions over 16 refill lanes, triage and coverage on.
tests/test_torch_refill.py computes it from the JAX face's run.

`PINNED_EXPLORE` is the JAX face's `ExploreReport.fingerprint()` of the
pinned explorer run (`EXPLORE_RUN` for `EXPLORE_GENERATIONS` generations
on `chip_smoke.explore_workload()`), and `PINNED_EXPLORE_CORPUS` its
`explore_corpus_digest` (every corpus field and violation record);
tests/test_torch_explore.py computes both there, and the port must
reproduce them on every dispatch path.

`PINNED_FEDERATION` is the JAX face's `Federation(..., mesh=None)`
fingerprint of the pinned island federation (`FEDERATION_RUN` for
`FEDERATION_GENERATIONS` generations on `chip_smoke.explore_workload(
FEDERATION_H_US)`); tests/test_torch_campaign.py computes it there.

`PINNED_HOSTRT` is the JAX face's `hostrt_digest` of the generated host
twins' result dicts on `HOSTRT_RUNS`; tests/test_torch_speclang_host.py
computes it there, and `hostrt_runs(device)` must reproduce it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict

import numpy as np
import torch

from .. import nemesis
from ..nemesis import FIRE_KINDS, OCC_CLAUSES, RATE_CLAUSES
from .chain import make_chain_spec
from .kv import make_kv_spec
from .nemesis import compile_plan
from .paxos import make_paxos_spec
from .raft import make_raft_spec, raft_bench_config
from .spec import REBASE_US, SimConfig
from .twopc import make_twopc_spec

# the FIRE_KINDS prefix width the golden digests were blessed at: later
# columns enter the digest, named by kind, only where nonzero
R8_FIRE_WIDTH = 11


def _unpack(words: np.ndarray, k: int) -> np.ndarray:
    b = (words[..., :, None] >> np.arange(32, dtype=np.int64)) & 1
    return b.reshape(words.shape[:-1] + (words.shape[-1] * 32,))[..., :k] != 0


def canonical_digest(leaves: Dict[str, np.ndarray]) -> str:
    """sha256 over a state's values (dotted-path numpy leaves)."""
    h = hashlib.sha256()
    n = leaves["timer"].shape[1]
    view = dict(leaves)
    view["alive"] = _unpack(leaves["alive_p"], n)
    view["link_ok"] = _unpack(leaves["link_ok_p"], n)
    for name in ("clock", "epoch", "key", "done", "violated",
                 "violation_step", "steps", "events", "overflow",
                 "dead_drops", "crashed", "partitioned", "timer",
                 "alive", "link_ok"):
        h.update(np.ascontiguousarray(view[name].astype(np.int64)))
    for k, leaf in leaves.items():
        if k.startswith("node."):
            h.update(np.ascontiguousarray(leaf.astype(np.int64)))
    ck = leaves["msgs.deliver"].shape[-1]
    for part in (_unpack(leaves["msgs.valid_p"], ck), leaves["msgs.deliver"],
                 leaves["msgs.kind"], leaves["msgs.payload"]):
        h.update(np.ascontiguousarray(part.astype(np.int64)))
    fires = leaves["fires"].astype(np.int64)
    h.update(np.ascontiguousarray(fires[:, :R8_FIRE_WIDTH]))
    for i in range(R8_FIRE_WIDTH, fires.shape[1]):
        if fires[:, i].any():
            h.update(FIRE_KINDS[i].encode())
            h.update(np.ascontiguousarray(fires[:, i]))
    return h.hexdigest()


# name -> (spec kwargs, config, lanes, max_steps): the headline sweep's
# config, and the repo's single-step entry config run to its horizon
PINNED_RUNS = {
    "raft_bench": (
        dict(n_nodes=5, client_rate=0.1, log_capacity=16),
        raft_bench_config(10.0), 64, 8000,
    ),
    "raft_entry": (
        dict(n_nodes=5),
        SimConfig(
            horizon_us=5_000_000, loss_rate=0.1,
            crash_interval_lo_us=500_000, crash_interval_hi_us=3_000_000,
        ),
        64, 8000,
    ),
}

PINNED: Dict[str, str] = {
    "raft_bench": "1c1edc0a55e25e79ac89764a35682a363c31b33b5c5ff52b4dc38daf1e140300",
    "raft_entry": "c7dfcc2c9c2604f7d20bcc7a8a1ab0e10fa87c95b23d9d8dff5f11607a3b36ff",
}


def pinned_run(name: str):
    """(spec, config, seeds, max_steps) of one pinned reference run."""
    kw, cfg, lanes, max_steps = PINNED_RUNS[name]
    return make_raft_spec(**kw), cfg, list(range(lanes)), max_steps


# the golden runs' fault plan (tests/test_state_layout.py:CHAOS_PLAN)
CHAOS_PLAN = nemesis.FaultPlan(
    name="layout",
    clauses=(
        nemesis.Crash(interval_lo_us=300_000, interval_hi_us=900_000,
                      down_lo_us=200_000, down_hi_us=600_000),
        nemesis.Partition(interval_lo_us=400_000, interval_hi_us=1_200_000,
                          heal_lo_us=300_000, heal_hi_us=900_000),
        nemesis.MsgLoss(rate=0.05),
    ),
)
GOLDEN_LANES = 16
GOLDEN_STEPS = 1500
GOLDEN_SPECS = {
    "raft": make_raft_spec,
    "paxos": make_paxos_spec,
    "kv": make_kv_spec,
    "twopc": make_twopc_spec,
    "chain": make_chain_spec,
}
GOLDEN: Dict[str, str] = {
    "raft": "2a0e81ea9e273a54298b0bc11e44f377ef8861607ad320278695700bf0df861b",
    "paxos": "b32a304d0682bcc183b4b3d1382816bb6187c74d8f145d082e0198dec44efa8b",
    "kv": "2249bd64d3fd1aac94376125169167e7ae6f35fea51dfa06c0db38453ba58c9c",
    "twopc": "38b8eae7cd3944363dcac58cda088791727370d2892a28c8b978ab80c57a1666",
    "chain": "c6e860898bca578503460a96d3fdd9d9a21b7ea7b17313c0e4fd10ab785d1f86",
}


def golden_run(name: str):
    """(spec, config, seeds, max_steps) of one workload's golden run: the
    spec factory's defaults under CHAOS_PLAN compiled onto a 30-virtual-
    second config, seeds 0..15, 1500 steps (every lane still live at the
    end, so the run is exactly 1500 steps)."""
    cfg = compile_plan(CHAOS_PLAN, SimConfig(horizon_us=30_000_000))
    return (GOLDEN_SPECS[name](), cfg, list(range(GOLDEN_LANES)),
            GOLDEN_STEPS)


def bundle_digest(bundle) -> str:
    """sha256 of a ReproBundle's canonical JSON (sorted keys, no spaces):
    equal for field-for-field equal bundles, whichever face wrote them."""
    doc = json.dumps(dataclasses.asdict(bundle), sort_keys=True,
                     separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()


# the planted re-stamp shrink's bundle: (seed, bundle_digest)
PINNED_BUNDLE = (
    0, "73496e75ea62bd1a05db236477dc88caf63c5676b955e4dab411ad748406d741",
)
# the same shrink with causal=True: its causal digest's sha, and the whole
# bundle's digest
PINNED_CAUSAL = "1a4ff0d441498bc0"
PINNED_BUNDLE_V3 = (
    "2c5ca3daf7a4cafa8d8735659fd2f0d6d48c21e3dfc5675c41528aba27b452ba"
)

# the lineage plane's leaves (dotted paths), in the order lineage_digest
# hashes them
LINEAGE_LEAVES = ("lin.lam", "lin.eid", "msgs.sent_eid", "strag.sent_eid")


def lineage_digest(leaves: Dict[str, np.ndarray]) -> str:
    """sha256 over a state's lineage leaves (dotted-path numpy leaves; a
    leaf the state lacks is skipped), each named and widened to int64."""
    h = hashlib.sha256()
    for k in LINEAGE_LEAVES:
        if k in leaves:
            h.update(k.encode())
            h.update(np.ascontiguousarray(np.asarray(leaves[k]).astype(np.int64)))
    return h.hexdigest()


# the Raft golden run with lineage=True
PINNED_LINEAGE = (
    "177fd1ffdfea154ac15aabc066e94bb3b1434e512a221f5260b812fbdb209ae4"
)


def spread_mix(horizon_us: int) -> SimConfig:
    """The continuous-batching headline mix's config
    (`madsim_tpu/tune.py:spread_mix_sim`): Crash(h/6..h/2, down h/8..h/3)
    + MsgLoss(0.05) compiled over SimConfig(horizon_us=h), run on the
    default `make_raft_spec()`."""
    h = int(horizon_us)
    plan = nemesis.FaultPlan(name="tune-mix", clauses=(
        nemesis.Crash(interval_lo_us=h // 6, interval_hi_us=h // 2,
                      down_lo_us=h // 8, down_hi_us=h // 3),
        nemesis.MsgLoss(rate=0.05),
    ))
    return compile_plan(plan, SimConfig(horizon_us=h))


def spread_ctl(horizon_us: int, admissions: int, spread: int = 10,
               long_every: int = 8):
    """Per-admission TriageCtl rows of the spread mix
    (`madsim_tpu/tune.py:spread_ctl_rows`): one admission in `long_every`
    at the full horizon, the rest at horizon / `spread`; every clause on."""
    from .engine import TriageCtl

    h = np.where(np.arange(int(admissions)) % int(long_every) == 0,
                 int(horizon_us), int(horizon_us) // int(spread))
    n = len(h)
    return TriageCtl(
        off=torch.zeros((n,), dtype=torch.int32),
        occ=torch.zeros((n, len(OCC_CLAUSES)), dtype=torch.int32),
        rate_scale=torch.ones((n, len(RATE_CLAUSES)), dtype=torch.float32),
        h_epoch=torch.as_tensor((h // REBASE_US).astype(np.int32)),
        h_off=torch.as_tensor((h % REBASE_US).astype(np.int32)),
    )


# the pinned refill run: (horizon us, admissions, refill lanes, per-
# admission step budget)
REFILL_RUN = (1_000_000, 256, 16, 50_000)


def refill_run():
    """(spec, config, seeds, ctl rows, lanes, max_steps) of the pinned
    refill run; run it on `BatchedSim(spec, cfg, triage=True,
    coverage=True)`."""
    h, admissions, lanes, max_steps = REFILL_RUN
    return (make_raft_spec(), spread_mix(h), list(range(admissions)),
            spread_ctl(h, admissions), lanes, max_steps)


# refill_results rows the refill digest hashes, in this order
REFILL_ROWS = (
    "retired", "violated", "deadlocked", "violation_at", "violation_epoch",
    "violation_step", "steps", "events", "overflow", "dead_drops",
    "nonmember_drops", "unsynced_loss", "clock", "epoch", "fires",
    "occ_fired", "cov_bitmap", "cov_hiwater", "cov_transitions",
)


def refill_digest(res: dict) -> str:
    """sha256 over a refill sweep's per-admission rows (values as int64)
    and its occupancy counters."""
    h = hashlib.sha256()
    for f in REFILL_ROWS:
        if res.get(f) is not None:
            h.update(f.encode())
            h.update(np.ascontiguousarray(np.asarray(res[f]).astype(np.int64)))
    h.update(np.asarray([res["iters"], res["busy_lane_steps"]], np.int64))
    return h.hexdigest()


PINNED_REFILL = "23a65be876412c845f03c8a3df7f902b18f5ddf0eef351556e4c110529a6527d"


# the explorer's pinned run (madsim_tpu_torch/explore.py): `Explorer(
# chip_smoke.explore_workload(), meta_seed=11, lanes=16, chunk=8,
# shrink_violations=False).run(2)` — the planted re-stamp Raft under the
# Crash + Partition plan of tests/test_explore.py at a 2.5-virtual-second
# horizon, loss 0. The value is the JAX face's `ExploreReport.fingerprint()`
# for the same run (tests/test_torch_explore.py computes it there).
EXPLORE_RUN = dict(meta_seed=11, lanes=16, chunk=8, shrink_violations=False)
EXPLORE_GENERATIONS = 2
PINNED_EXPLORE = (
    "11aa29f06073a49aeb33d5d4abf11107a1abc5f8a7eec64737cb4120c5b96227"
)


def explore_corpus_digest(ex) -> str:
    """sha256 of an explorer's whole corpus (every field of every entry:
    genome, new bits, bitmap, high water, transitions, violated,
    generation) and its violation records (bundle paths aside). The
    fingerprint covers only genomes, bitmaps and curves; this covers the
    rest. Either face's Explorer."""
    doc = {
        "corpus": [e.to_dict() for e in ex.corpus],
        "violations": [{k: v for k, v in rec.items() if k != "bundle_path"}
                       for rec in ex.violations],
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


# the JAX face's explore_corpus_digest of the pinned run
PINNED_EXPLORE_CORPUS = (
    "7d2eae373eac4a45f8ed08d5f9b2503c3ee17202a7120136c9e91b3810d7e9fc"
)


# the island federation's pinned run (madsim_tpu_torch/explore.py):
# `Federation(chip_smoke.explore_workload(FEDERATION_H_US),
# **FEDERATION_RUN).run(FEDERATION_GENERATIONS)` — two islands of 8 lanes,
# a coverage exchange after generation 2, on the explorer's planted
# workload cut to a 0.5-virtual-second horizon. The value is the JAX
# face's `Federation(..., mesh=None)` report fingerprint for the same run
# (tests/test_torch_campaign.py computes it there); the port must reach
# it on the host loop and on the device loop.
FEDERATION_RUN = dict(n_islands=2, meta_seed=7, lanes=8, exchange_every=2)
FEDERATION_H_US = 500_000
FEDERATION_GENERATIONS = 3
PINNED_FEDERATION = (
    "bd7390680f45bf3d3f172e926f02e6e8c5daeae7ef71eb775108b205efc9429f"
)


# The differential oracle's pinned lane: `oracle.check_seed("raft5",
# triage.plan_from_config(oracle_config()), ORACLE_SEED, ORACLE_H_US)` — the
# raft twin replayed schedule-matched under all eight clauses (the JAX
# suite's PLAN8, tests/test_oracle.py) compiled onto the raft bench config at
# its 10-virtual-second horizon. The value is the JAX face's
# `OracleReport.digest` for the same lane (tests/test_torch_oracle.py holds
# both faces to it).
ORACLE_PLAN = nemesis.FaultPlan(name="oracle-all8", clauses=(
    nemesis.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                  down_lo_us=200_000, down_hi_us=800_000),
    nemesis.Partition(interval_lo_us=500_000, interval_hi_us=1_800_000,
                      heal_lo_us=300_000, heal_hi_us=1_000_000),
    nemesis.LinkClog(interval_lo_us=600_000, interval_hi_us=2_000_000,
                     heal_lo_us=300_000, heal_hi_us=1_000_000),
    nemesis.LatencySpike(interval_lo_us=500_000, interval_hi_us=2_000_000,
                         duration_lo_us=200_000, duration_hi_us=800_000,
                         extra_us=80_000),
    nemesis.MsgLoss(rate=0.05),
    nemesis.Duplicate(rate=0.05),
    nemesis.Reorder(rate=0.15, window_us=40_000),
    nemesis.ClockSkew(max_ppm=30_000),
))
ORACLE_H_US = 10_000_000
ORACLE_SEED = 7
PINNED_ORACLE = "534dd9df0d602eb6"


def oracle_config() -> SimConfig:
    """The raft bench config with `ORACLE_PLAN` compiled onto it."""
    return compile_plan(ORACLE_PLAN, raft_bench_config(ORACLE_H_US / 1e6))


# The generated host twins' pinned runs (the JAX suite's
# tests/test_host_twins.py:707-755): backup seed 3, lease-gen seed 1 and
# twopc-gen seed 3 under host-native chaos for 6 virtual seconds, and the
# correct backup build on seed 0 under `HOSTRT_PLAN` (Duplicate + Reorder,
# plan mode, no host-native chaos) for 8. Rows are (generated module, seed,
# fuzz_one_seed kwargs); "plan": True stands for `HOSTRT_PLAN`. The buggy
# backup build raises on the plan row. `PINNED_HOSTRT` is the JAX face's
# `hostrt_digest` of the four result dicts (tests/test_torch_speclang_host.py
# computes it there); the port must reproduce it on every device.
HOSTRT_PLAN = nemesis.FaultPlan(name="backup-bug", clauses=(
    nemesis.Duplicate(rate=0.15),
    nemesis.Reorder(rate=0.3, window_us=250_000),
))
HOSTRT_RUNS = (
    ("backup_host", 3, {"virtual_secs": 6.0}),
    ("lease_host", 1, {"virtual_secs": 6.0}),
    ("twopc_host", 3, {"virtual_secs": 6.0}),
    ("backup_host", 0, {"virtual_secs": 8.0, "chaos": False, "plan": True}),
)
PINNED_HOSTRT = (
    "9b5b07ccb1c3806b60aff1de62a884cb30d878f9354b56bd2c58e882123a281e"
)


def hostrt_kwargs(kw: dict, plan) -> dict:
    """A `HOSTRT_RUNS` row's kwargs with `plan` (the face's copy of
    `HOSTRT_PLAN`) in place of the marker."""
    return {k: (plan if k == "plan" else v) for k, v in kw.items()}


def hostrt_result(out: dict) -> dict:
    """The JSON-able part of a generic twin's result dict: checks, events,
    the per-node state digests and, in plan mode, the driver's applied
    stream, fires, occurrence masks and coin draws."""
    doc = {k: out[k] for k in ("checks", "events", "state")}
    nem = out.get("nemesis")
    if nem is not None:
        doc["nemesis"] = {
            "applied": [dataclasses.astuple(e) for e in nem["applied"]],
            "occ_fired": nem["occ_fired"],
            "fires": nem["fires"],
            "draws": [list(d) for d in nem["coins"].draws],
        }
    return json.loads(json.dumps(doc))


def hostrt_digest(results) -> str:
    """sha256 of the `hostrt_result`s of the `HOSTRT_RUNS` dicts, in order."""
    return hashlib.sha256(json.dumps(
        [hostrt_result(r) for r in results], sort_keys=True
    ).encode()).hexdigest()


def hostrt_runs(device="cuda") -> list:
    """The port's generated twins on `HOSTRT_RUNS`, handlers on `device`."""
    import importlib

    out = []
    for mod, seed, kw in HOSTRT_RUNS:
        twin = importlib.import_module(
            f"madsim_tpu_torch.speclang.generated.{mod}")
        out.append(twin.fuzz_one_seed(
            seed, device=device, **hostrt_kwargs(kw, HOSTRT_PLAN)))
    return out
