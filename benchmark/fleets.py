"""The system under test, as a configuration file names it, and the control
put in its place.

:class:`PortFleet` builds the port's fleet through the entry the
configuration's ``port`` group names (``"module:attr"``; an argument
``"@module:attr"`` is that attribute, ``{"call": "module:attr"}`` its
value when called) and names the fields of its carry by ``port.carry``
(``warm``, the warm start, as ``xs`` and ``us``). :class:`ControlFleet` is
the plain reference computed a precision below the configuration's, with
the same interface, for the readings that set a limit from above.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from benchmark.check import reference_module
from benchmark.reference import ocp


def resolve(ref):
    """An argument of the port's entry: a ``"@module:attr"`` attribute, a
    ``{"call": "module:attr"}`` value, or the value as written."""
    if isinstance(ref, str) and ref.startswith("@"):
        return _attr(ref[1:])
    if isinstance(ref, dict) and set(ref) == {"call"}:
        return _attr(ref["call"])()
    return ref


def _attr(path: str):
    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


class PortFleet:
    """The port's fleet: ``tick(carry) -> (carry, (kkt, ...))`` and
    ``init(batch, seed)``, as the configuration's entry returns them."""

    def __init__(self, cfg: dict, device="cuda", backend="auto"):
        port = cfg["port"]
        kwargs = {k: resolve(v) for k, v in port.get("kwargs", {}).items()}
        args = [resolve(a) for a in port.get("args", [])]
        self.tick_fn, self.init_fn, self.solver, _ = _attr(port["build"])(
            *args, device=device, backend=backend, **kwargs)
        self.names = list(port["carry"])

    def init(self, draw: dict, batch: int, seed: int):
        """The port's first carry from the seed; refuses one whose scenario
        fields differ from the traffic's draw, which the reference gets."""
        carry = self.init_fn(batch, seed=seed)
        v = self.view(carry)
        for k, want in draw.items():
            got = v[k].detach().cpu().numpy()
            if not np.array_equal(got, want):
                raise RuntimeError(f"the port drew another {k!r} than the traffic's "
                                   "generator from this seed")
        return carry

    def tick(self, carry):
        carry, aux = self.tick_fn(carry)
        return carry, aux[0]

    def view(self, carry) -> dict:
        out = {}
        for name, t in zip(self.names, carry):
            if name == "warm":
                out["xs"], out["us"] = t.xs, t.us
            else:
                out[name] = t
        return out

    def launches(self) -> dict:
        s = self.solver
        return {"vde": s.vde.launches, "lq_ipm": s.qp.launches, "rk4": s.rk4.launches}


class ControlFleet:
    """The reference in ``prec`` in the program's place: its state is the
    reference's row state, its tick the reference's."""

    def __init__(self, cfg: dict, device, prec: ocp.Precision = ocp.CONTROL):
        self.ref = reference_module(cfg["family"]).Fleet(cfg, device, prec)

    def init(self, draw: dict, batch: int, seed: int):
        return self.ref.init(draw)

    def tick(self, carry):
        with torch.no_grad():
            return self.ref.tick(carry)

    def view(self, carry) -> dict:
        return carry

    def launches(self) -> dict:
        return {}
