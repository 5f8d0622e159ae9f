"""How ``correct`` is decided: the program's ticks against the plain
reference.

Rows are vehicles; a fleet's vehicles are independent of one another. The
check reads two kinds of evidence, both gathered by :class:`Recorder`:

- the start: the program's outputs at its first ``start_ticks`` ticks, for
  a sample of rows. The reference runs those ticks itself from the
  traffic's draw, following its own state, so nothing of the program's
  enters it;
- the window: at ``window_ticks`` ticks drawn from the seed, the program's
  state before the tick and after it, for a sample of rows. The reference
  runs each such tick from the program's state before it (a closed loop of
  thousands of ticks cannot be followed any other way) and is compared with
  the state after it.

Each output of a tick is compared: the plant's next state and the
projection anchor or phase (the glue and the RK4 plant step), the shifted
warm start of states and controls (the linearization, the interior-point
solve and the shift), and the KKT defect. A float32 state in world
coordinates cannot be more exact than float32 arithmetic on those
coordinates allows, and far down a straight arc that floor exceeds what a
lower-precision solve adds near the start. So a row's gap to the float64
reference is measured in units of a plain float32 solve's gap on the same
row (the reference itself, computed in float32 with TF32 off), plus a small
absolute floor per output; the number compared is the worst such ratio.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ocp

# The program's outputs of a tick, by the name of the reference's field,
# and the floor each gap is measured against beside the float32 solve's.
# The floors are float32's resolution of each output at its size: states
# and the KKT defect (a defect of states) of order 1-10, controls in box
# widths of order 0.1-1, phases and arc lengths as states.
PARTS = {"x0": 1e-6, "s0": 1e-6, "theta": 1e-6, "xs": 1e-6, "us": 1e-7, "kkt": 1e-6}


def reference_module(family: str):
    """The reference of a configuration's ``family``."""
    import importlib

    return importlib.import_module(f"benchmark.reference.{family}")


def u_scale(cfg: dict, dtype, device):
    """Each input's box width (1 where unbounded): the unit of a control's
    gap."""
    o = cfg["ocp"]
    lo = o.get("lbu") or [None] * int(o["nu"])
    hi = o.get("ubu") or [None] * int(o["nu"])
    w = [float(h) - float(l) if l is not None and h is not None else 1.0
         for l, h in zip(lo, hi)]
    return torch.as_tensor(w, dtype=dtype, device=device)


def part_gaps(out: dict, kkt, ref: dict, ref_kkt, uw) -> dict:
    """Per row, the largest gap of each output between ``out`` (with its
    ``kkt``) and ``ref``: controls in units of their box width."""
    g = {}
    for k in PARTS:
        if k == "kkt":
            a, b = kkt, ref_kkt
        elif k in out and k in ref:
            a, b = out[k], ref[k]
        else:
            continue
        d = (a.to(torch.float64) - b.to(torch.float64)).abs()
        if k == "us":
            d = d / uw.to(torch.float64)
        g[k] = d.reshape(d.shape[0], -1).amax(1) if d.dim() > 1 else d
    return g


def ratios(prog: dict, f32: dict) -> dict:
    """{output: the worst ratio over rows of the program's gap to the
    float32 solve's gap plus the output's floor}."""
    return {k: float((gp / (f32[k] + PARTS[k])).max()) for k, gp in prog.items()
            if gp.numel()}


class Recorder:
    """Gathers the program's evidence during a run. ``view(carry)`` names
    the program's carry fields as the reference names them; ``rows``, the
    rows it keeps, are drawn from the seed before the run."""

    def __init__(self, view, start_ticks: int, rows: np.ndarray):
        self.view, self.start_ticks = view, start_ticks
        self.rows = torch.as_tensor(rows)
        self.start = []  # per start tick: (outputs, kkt) of the sampled rows
        self.window = []  # per window tick: (state before, outputs, kkt)

    def _take(self, carry):
        v = self.view(carry)
        idx = self.rows.to(next(iter(v.values())).device)
        return {k: t.index_select(0, idx).cpu() for k, t in v.items()}

    def after_start_tick(self, carry, kkt):
        if len(self.start) < self.start_ticks:
            idx = self.rows.to(kkt.device)
            self.start.append((self._take(carry), kkt.index_select(0, idx).cpu()))

    def before_window_tick(self, carry):
        self._before = self._take(carry)

    def after_window_tick(self, carry, kkt):
        idx = self.rows.to(kkt.device)
        self.window.append((self._before, self._take(carry),
                            kkt.index_select(0, idx).cpu()))


def judge(cfg: dict, draw: dict, rec: Recorder, device, block_rows: int = 16384) -> dict:
    """The number compared: the worst ratio over the recorded rows and
    ticks. A window tick's reference takes the program's state before it
    (the fields of :data:`PARTS`) and the row's scenario from the traffic's
    draw. Returns {"gap_ratio", "worst_output", "rows", "ratios": the worst
    ratio of each output at the start and in the window}."""
    mod = reference_module(cfg["family"])
    r64 = mod.Fleet(cfg, device, ocp.REFERENCE)
    r32 = mod.Fleet(cfg, device, ocp.Precision(torch.float32, False))
    uw = u_scale(cfg, torch.float64, device)
    sub = {k: np.asarray(v)[rec.rows.numpy()] for k, v in draw.items()}
    worst = {"start": {}, "window": {}}
    rows = 0

    def account(phase, out, kkt, a64, k64, a32, k32):
        nonlocal rows
        gp = part_gaps(out, kkt.to(device), a64, k64, uw)
        g32 = part_gaps(a32, k32, a64, k64, uw)
        for k, v in ratios(gp, g32).items():
            worst[phase][k] = max(worst[phase].get(k, 0.0), v)
        rows += next(iter(gp.values())).shape[0]

    # The start: the reference follows its own state from the draw.
    s64, s32 = r64.init(sub), r32.init(sub)
    for out, kkt in rec.start:
        s64, k64 = r64.tick(s64)
        s32, k32 = r32.tick(s32)
        account("start", _on(out, device), kkt, s64, k64, s32, k32)
    # The window: each recorded tick from the program's state before it,
    # the recorded ticks' rows side by side.
    if rec.window:
        cat = lambda i: {k: torch.cat([w[i][k] for w in rec.window])
                         for k in rec.window[0][i]}
        before, out = cat(0), cat(1)
        kkt = torch.cat([w[2] for w in rec.window])
        scen_all = {k: np.concatenate([v] * len(rec.window)) for k, v in sub.items()}
        for lo in range(0, kkt.shape[0], block_rows):
            hi = lo + block_rows
            scen = {k: v[lo:hi] for k, v in scen_all.items()}
            dyn = {k: v[lo:hi] for k, v in before.items() if k in PARTS}
            b64 = dict(r64.init(scen), **_on(dyn, device, torch.float64))
            b32 = dict(r32.init(scen), **_on(dyn, device, torch.float32))
            a64, k64 = r64.tick(b64)
            a32, k32 = r32.tick(b32)
            account("window", _on({k: v[lo:hi] for k, v in out.items()}, device), kkt[lo:hi],
                    a64, k64, a32, k32)
    flat = [(v, f"{ph}.{k}") for ph, d in worst.items() for k, v in d.items()]
    top = max(flat) if flat else (0.0, "")
    return {"gap_ratio": top[0], "worst_output": top[1], "rows": rows, "ratios": worst}


def _on(s: dict, device, dtype=torch.float64) -> dict:
    return {k: v.to(device, dtype) for k, v in s.items()}
