"""Layout stability of the port's state on the CPU.

On a card the captured `_run` refuses a step that changes any leaf's shape
or dtype (`engine._layout`), which is how twopc's int64 deadlines were
found: the differential tests compare values widened to int64, so a dtype
drift passes them. This file holds the same property on the CPU, and on
the paths the capture never sees: every registry row and each planted-bug
variant (isr, lease, wal, lease-gen, backup), 16 lanes, stepped

  * plain (the captured sweep's step);
  * with triage, coverage and lineage on;
  * as a refill sweep (24 admissions over 8 lanes, truncated at 64 steps
    each, so lanes retire and admit inside the window), planes on;
  * traced (`record=True`), planes on — the records keep one layout too;

and after every step the state's layout equals init's.
"""

import pytest
import torch

from madsim_tpu_torch import workloads as reg
from madsim_tpu_torch.tpu import BatchedSim
from madsim_tpu_torch.tpu.engine import _layout

# one torch thread per process, as tests/test_torch_engine.py sets (six
# xdist workers with torch's default pool oversubscribe the cores)
torch.set_num_threads(1)

BUGGY = ("isr", "lease", "wal", "lease-gen", "backup")
ROWS = [(n, False) for n in reg.names()] + [(n, True) for n in BUGGY]
STEPS = {"plain": 160, "planes": 96, "refill": 96, "traced": 48}


def _flat(layout, path=()):
    """(index path, (shape, dtype)) of every leaf of a layout."""
    if layout is None:
        return []
    if isinstance(layout, tuple) and not (
        len(layout) == 2 and isinstance(layout[0], tuple)
        and not isinstance(layout[1], tuple)
    ):
        return [x for i, sub in enumerate(layout)
                for x in _flat(sub, path + (i,))]
    return [(path, layout)]


def _drift(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    return sorted((p, w.get(p), g.get(p)) for p in set(g) | set(w)
                  if g.get(p) != w.get(p))


@pytest.mark.parametrize("mode", list(STEPS))
@pytest.mark.parametrize("name,buggy", ROWS,
                         ids=[f"{n}{'-buggy' if b else ''}" for n, b in ROWS])
def test_state_layout_survives_every_step(name, buggy, mode):
    wl = reg.workload_factory(name)(**({"buggy": True} if buggy else {}))
    planes = mode != "plain"
    sim = BatchedSim(wl.spec, wl.config, triage=planes, coverage=planes,
                     lineage=planes, device="cpu")
    if mode == "refill":
        st = sim.init_refill(range(24), lanes=8, step_cap=64)
    else:
        st = sim.init(range(16))
    want = _layout(st)
    rec_layout = None
    for i in range(STEPS[mode]):
        if mode == "traced":
            st, rec = sim.step(st, record=True)
            rec_layout = rec_layout or _layout(rec)
            assert _layout(rec) == rec_layout, (i, _drift(_layout(rec),
                                                          rec_layout))
        else:
            st = sim.step(st)
        assert _layout(st) == want, (i, _drift(_layout(st), want))
    if mode == "refill":  # lanes retired and admitted inside the window
        assert int(st.refill.cursor) > 8
