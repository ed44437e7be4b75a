"""On-card smoke run of the PyTorch/CUDA port (`madsim_tpu_torch`).

Run from the repo root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the 5-node Raft fuzz sweep through
`BatchedSim.run` and `summarize` — and checks it, in five phases:

1. device: needs a CUDA card (exits non-zero without one); prints the
   card's name and power limit as nvidia-smi reports them;
2. parity: 64-lane runs of the headline bench config and the `entry()`
   config on the card and on the CPU, every state leaf and the summary
   equal, and the card's digests equal to the pinned constants (which the
   CPU tests hold against the JAX engine); also the u32 product wrap and
   the argmin tie order on the card;
3. epoch rebase: a mid-run state shifted to just under REBASE_US, stepped
   on the card and on the CPU, leaf-equal;
4. headline sweep: the bench config at 32768 lanes x 5 nodes, 10 virtual
   seconds, max_steps 8000: a warm-up, then the median of 3 fresh-seed
   reps (seeds/s, events/s, step ms), and seeds 0..63 of the warm-up equal
   per seed to phase 2's 64-lane run;
5. profile: torch.profiler over 20 steady steps at 32768 lanes — kernels
   launched per step, device idle share, top device kernels.

The port has no hand-written kernel yet, so the kernel list is empty. The
full measurements are printed as one `report: {...}` line. The last line
is the run's result; any failed check exits non-zero before it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CARD = "cuda"
LANES = 32768
SEEDS_SMALL = 64
MAX_STEPS = 8000
PROFILE_STEPS = 20
PHASE4_BUDGET_S = 300.0


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def leaves_equal(a: dict, b: dict) -> list:
    """Names of the leaves that differ (or exist on one side only)."""
    return sorted(
        k for k in set(a) | set(b)
        if k not in a or k not in b or not np.array_equal(a[k], b[k])
    )


def summaries_equal(a: dict, b: dict) -> list:
    """Keys that differ; float lane means at rtol 1e-6 (summed in another
    order on each device), everything else exactly."""
    bad = []
    for k in set(a) | set(b):
        x, y = a.get(k), b.get(k)
        if isinstance(x, float) and isinstance(y, float):
            if not np.isclose(x, y, rtol=1e-6, atol=0):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return sorted(bad)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from madsim_tpu_torch.tpu import BatchedSim, summarize
    from madsim_tpu_torch.tpu import prng
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import PINNED, canonical_digest, pinned_run
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config
    from madsim_tpu_torch.tpu.spec import (
        INF_GUARD, REBASE_US, expand_to, tree_map,
    )

    torch.use_deterministic_algorithms(True)
    cuda = torch.device(CARD)
    report: dict = {}

    # -- 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    print(card, flush=True)
    phase(1, f"device {kind!r}, count {torch.cuda.device_count()}, "
             f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # -- 2. parity on the card: u32 wrap, tie order, whole runs
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
        rng.integers(0, 2**32, size=1 << 20, dtype=np.uint64).astype(np.uint32),
    ])
    for c in (0x85EBCA6B, 0xC2B2AE35, prng.GOLDEN):
        got = prng._mul32(torch.as_tensor(x.astype(np.int64), device=cuda), c)
        want = (x * np.uint32(c)).astype(np.int64)
        check(np.array_equal(got.cpu().numpy(), want),
              f"u32 product wrap differs on the card (c={c:#x})")
    ties = rng.integers(0, 3, size=(4096, 40)).astype(np.int64)
    check(np.array_equal(torch.as_tensor(ties, device=cuda).argmin(1).cpu()
                         .numpy(), ties.argmin(1)),
          "argmin tie order on the card is not the first minimum")
    small = {}
    for name in ("raft_bench", "raft_entry"):
        spec, cfg, seeds, max_steps = pinned_run(name)
        t0 = time.perf_counter()
        st_gpu = BatchedSim(spec, cfg, device=cuda).run(seeds, max_steps)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        st_cpu = BatchedSim(spec, cfg, device="cpu").run(seeds, max_steps)
        g, c = state_to_numpy(st_gpu), state_to_numpy(st_cpu)
        bad = leaves_equal(g, c)
        check(not bad, f"{name}: card and CPU leaves differ: {bad}")
        sg, sc = summarize(st_gpu, spec), summarize(st_cpu, spec)
        bad = summaries_equal(sg, sc)
        check(not bad, f"{name}: card and CPU summaries differ: {bad}")
        dg = canonical_digest(g)
        check(dg == PINNED[name],
              f"{name}: card digest {dg} != pinned {PINNED[name]}")
        small[name] = g
        report[f"parity_{name}"] = {
            "lanes": len(seeds), "steps": int(g["steps"].max()),
            "card_s": t_gpu, "digest": dg,
        }
        phase(2, f"{name}: {len(seeds)} lanes x {int(g['steps'].max())} "
                 f"steps, {len(g)} leaves equal card/CPU, summary equal, "
                 f"digest {dg[:16]} == pinned")

    # -- 3. epoch rebase on the card
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
    cfg400 = raft_bench_config(400.0)
    sim_g = BatchedSim(make_raft_spec(**kw), cfg400, device=cuda)
    sim_c = BatchedSim(make_raft_spec(**kw), cfg400, device="cpu")
    mid = sim_g.run_steps(sim_g.init(range(SEEDS_SMALL)), 120)
    delta = (REBASE_US - 3_000) - mid.clock

    def shifted(x):  # move live offsets so the clock sits under REBASE_US
        return torch.where(x < INF_GUARD, x + expand_to(delta, x), x)

    mid = mid._replace(
        clock=shifted(mid.clock), timer=shifted(mid.timer),
        chaos_at=shifted(mid.chaos_at), part_at=shifted(mid.part_at),
        msgs=mid.msgs._replace(deliver=shifted(mid.msgs.deliver)),
    )
    g = state_to_numpy(sim_g.run_steps(mid, 60))
    c = state_to_numpy(sim_c.run_steps(tree_map(lambda t: t.cpu(), mid), 60))
    bad = leaves_equal(g, c)
    check(not bad, f"rebase: card and CPU leaves differ: {bad}")
    check(bool((g["epoch"] == 1).all()), "rebase: not every lane rebased")
    phase(3, f"epoch rebase: {SEEDS_SMALL} lanes x 60 steps from a clock "
             f"{REBASE_US - 3000} us state, every lane at epoch 1, "
             f"{len(g)} leaves equal card/CPU")

    # -- 4. headline sweep
    spec = make_raft_spec(**kw)
    virtual_secs = 10.0
    sim = BatchedSim(spec, raft_bench_config(virtual_secs), device=cuda)
    probe = sim.init(range(LANES))
    for _ in range(3):
        probe = sim.step(probe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        probe = sim.step(probe)
    torch.cuda.synchronize()
    probe_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    # a 10 s horizon takes ~1210 steps; 4 sweeps must fit the phase budget
    est_s = 4 * 1210 * probe_ms / 1e3
    cut = ""
    if est_s > PHASE4_BUDGET_S:
        virtual_secs = max(1.0, round(10.0 * PHASE4_BUDGET_S / est_s, 1))
        cut = (f" (cut: virtual_secs 10 -> {virtual_secs}; 4 sweeps at "
               f"{probe_ms:.2f} ms/step were estimated at {est_s:.0f} s)")
        sim = BatchedSim(spec, raft_bench_config(virtual_secs), device=cuda)
    del probe
    t_phase = time.perf_counter()
    warm = sim.run(range(LANES), MAX_STEPS)
    torch.cuda.synchronize()
    warm_np = {k: getattr(warm, k)[:SEEDS_SMALL].cpu().numpy()
               for k in ("violated", "violation_step", "events", "steps",
                         "clock", "epoch")}
    del warm
    torch.cuda.reset_peak_memory_stats()
    walls, states = [], []
    for rep in range(3):
        seeds = np.arange(LANES, dtype=np.int64) + (rep + 1) * LANES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run(seeds, MAX_STEPS)
        done_all = bool(st.done.all())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(done_all, "headline sweep hit max_steps before the horizon")
        states.append(summarize(st, spec) | {
            "steps_run": int(st.steps.max())})
        del st
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    wall = statistics.median(walls)
    s = states[walls.index(wall)]
    head = {
        "lanes": LANES, "nodes": 5, "virtual_secs": virtual_secs,
        "walls_s": walls, "wall_s": wall, "seeds_per_sec": LANES / wall,
        "events_per_sec": s["total_events"] / wall,
        "step_ms": wall / s["steps_run"] * 1e3, "steps_run": s["steps_run"],
        "total_overflow": s["total_overflow"], "violations": s["violations"],
        "log_saturated_lanes": s["log_saturated_lanes"],
        "peak_mem_gib": peak_gib, "probe_step_ms": probe_ms,
        "phase_s": time.perf_counter() - t_phase,
    }
    report["headline"] = head
    check(s["total_overflow"] == 0, f"headline overflow {s['total_overflow']}")
    if virtual_secs == 10.0:
        ref = small["raft_bench"]
        for k, v in warm_np.items():
            check(np.array_equal(v.astype(np.int64), ref[k]),
                  f"batch independence: seeds 0..63 differ in {k!r} between "
                  f"the {LANES}-lane and the 64-lane run")
        indep = "seeds 0..63 equal the 64-lane run"
    else:
        indep = "batch independence not checked (horizon cut)"
    phase(4, f"headline {LANES} lanes x 5 nodes, {virtual_secs} virtual s"
             f"{cut}: {head['seeds_per_sec']:.1f} seeds/s, "
             f"{head['events_per_sec']:.0f} events/s, "
             f"{head['step_ms']:.3f} ms/step x {head['steps_run']} steps "
             f"(median of {[round(w, 3) for w in walls]} s), overflow "
             f"{head['total_overflow']}, violations {head['violations']}, "
             f"log_saturated_lanes {head['log_saturated_lanes']}, peak "
             f"{peak_gib:.2f} GiB; {indep}")

    # -- 5. profile over steady steps
    st = sim.init(range(LANES))
    for _ in range(200):
        st = sim.step(st)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            st = sim.step(st)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev_events = [
        e for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    ]
    kernels = [e for e in dev_events
               if not e.name.startswith(("Memcpy", "Memset"))]
    # host-side launch calls: a count that needs no device trace
    launch_calls = sum(1 for e in prof.events()
                       if e.name.startswith("cudaLaunch"))
    prof_out = {"window_ms": window_us / 1e3, "steps": PROFILE_STEPS,
                "launch_calls_per_step": launch_calls / PROFILE_STEPS}
    if kernels:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in dev_events)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for a, b in spans[1:]:
            if a > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy += cur_e - cur_s
        by_name: dict = {}
        for e in kernels:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + (e.time_range.end - e.time_range.start),
                               n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        busy_ms = busy / PROFILE_STEPS / 1e3
        prof_out |= {
            "kernels_per_step": len(kernels) / PROFILE_STEPS,
            "device_busy_ms_per_step": busy_ms,
            # the profiler slows the host; the unprofiled share compares
            # the same device time with phase 4's step time
            "idle_share": 1.0 - busy / window_us,
            "idle_share_unprofiled": 1.0 - busy_ms / head["step_ms"],
            "top": [{"name": n[:120], "ms_per_step": t / PROFILE_STEPS / 1e3,
                     "count_per_step": c / PROFILE_STEPS}
                    for n, (t, c) in top],
        }
        phase(5, f"profile {PROFILE_STEPS} steps at {LANES} lanes: "
                 f"{prof_out['kernels_per_step']:.0f} kernels/step "
                 f"({prof_out['launch_calls_per_step']:.0f} launch calls), "
                 f"device busy {busy_ms:.3f} ms/step; idle share "
                 f"{prof_out['idle_share']:.3f} of the profiled "
                 f"{window_us / PROFILE_STEPS / 1e3:.3f} ms/step, "
                 f"{prof_out['idle_share_unprofiled']:.3f} of phase 4's "
                 f"{head['step_ms']:.3f} ms/step")
        for i, k in enumerate(prof_out["top"]):
            print(f"  top{i + 1}: {k['ms_per_step']:.4f} ms/step "
                  f"x{k['count_per_step']:.0f} {k['name'][:90]}", flush=True)
    else:
        prof_out["kernels_per_step"] = None
        phase(5, f"profile: torch.profiler recorded no device events; "
                 f"step {window_us / PROFILE_STEPS / 1e3:.3f} ms by host "
                 f"clock, {prof_out['launch_calls_per_step']:.0f} launch "
                 "calls/step; device kernels and idle share not measured")

    # deterministic mode also fills every fresh uninitialized allocation
    # (torch.utils.deterministic.fill_uninitialized_memory); the step
    # writes all of every output it allocates, so the fills change no
    # result: measure the same steps with and without them
    import torch.utils.deterministic as tdet

    def timed(state, fill: bool):
        tdet.fill_uninitialized_memory = fill
        try:
            with profile(activities=[ProfilerActivity.CPU]) as p:
                state = sim.step(state)
            launches = sum(1 for e in p.events()
                           if e.name.startswith("cudaLaunch"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                state = sim.step(state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
        finally:
            tdet.fill_uninitialized_memory = True
        return state_to_numpy(state), launches, ms

    a, launches_fill, ms_fill = timed(st, True)
    b, launches_nofill, ms_nofill = timed(st, False)
    bad = leaves_equal(a, b)
    check(not bad, f"fill_uninitialized_memory changed leaves: {bad}")
    prof_out["fill_on"] = {"launch_calls_per_step": launches_fill,
                           "step_ms": ms_fill}
    prof_out["fill_off"] = {"launch_calls_per_step": launches_nofill,
                            "step_ms": ms_nofill}
    phase(5, f"uninitialized-memory fills on: {launches_fill} launches, "
             f"{ms_fill:.3f} ms/step; off: {launches_nofill} launches, "
             f"{ms_nofill:.3f} ms/step; leaves equal after "
             f"{PROFILE_STEPS + 1} steps")
    report["profile"] = prof_out
    return report


if __name__ == "__main__":
    report = main()
    print("report: " + json.dumps(report), flush=True)
    # no hand-written kernel is on the main path yet
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
