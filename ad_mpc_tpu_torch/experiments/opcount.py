"""Operations of the VDE and RK4 kernels, counted from a dynamics' plain
version: the count behind the operation bound of their rows in
``chip_smoke.py``.

:func:`dyn_counts` runs ``f(x, u, p)`` once on scalar entries under a
``TorchFunctionMode`` and adds up, per element, the operations of the
primal and those of one forward-mode tangent (an FMA counts as two):

- add, sub: 1 primal, 1 per tangent when an operand depends on (x, u);
- mul: 1 primal; per tangent 1 with one such operand, 3 with two
  (a'b + ab': a multiply and an FMA);
- div: 1 primal; per tangent 1 when only the dividend depends on (x, u),
  3 when the divisor does (``(a' - q b') / b``);
- sin, cos, exp: 1 primal (a transcendental counts as one, as
  ``bench.py:522`` counts it), 1 per tangent (times the derivative: the
  other of the sine-cosine pair, or the value itself);
- atan: 3 primal (the value, then 1 / (1 + v^2)), 1 per tangent;
- maximum, minimum, clamp, where: 1 primal, none per tangent (a select);
- sum over k elements: k - 1 adds, primal and per tangent;
- negation, indexing, stacking and reshaping: none.

An operation on the parameters and constants alone is computed once per
scenario, not per stage, and counts nothing; a call repeated on the same
operands (the model's second ``sin(psi)``) counts once, as the kernel
computes it once. An unknown operation on the state raises, so the count
is never silently short.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.overrides import TorchFunctionMode

_ADD = {"add", "__add__", "__radd__", "sub", "__sub__", "__rsub__", "rsub"}
_MUL = {"mul", "__mul__", "__rmul__"}
_DIV = {"div", "__truediv__", "true_divide"}
_RDIV = {"__rtruediv__"}
_TRANS = {"sin": 1, "cos": 1, "exp": 1, "atan": 3}
_SELECT = {"maximum", "minimum", "clamp", "where"}
_FREE = {"neg", "__neg__", "__getitem__", "stack", "reshape", "view", "expand",
         "movedim", "unsqueeze", "squeeze", "__get__", "clone", "contiguous"}
_NEW = {"full_like", "zeros_like", "ones_like", "new_zeros", "new_full",
        "new_ones", "new_tensor", "as_tensor", "tensor"}


class Counts(NamedTuple):
    primal: int  # operations of one evaluation without tangents
    tangent: int  # operations per forward-mode tangent of one evaluation


class _Count(TorchFunctionMode):
    def __init__(self, seeds):
        super().__init__()
        self.keep = list(seeds)  # holds every traced tensor, so ids stay unique
        self.active = {id(t) for t in seeds}
        self.seen = {}  # the first output of each (operation, operands)
        self.primal = self.tangent = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        act = [id(a) in self.active for a in args]
        if isinstance(args[0] if args else None, (list, tuple)):
            act = [id(a) in self.active for a in args[0]]
        if not isinstance(out, torch.Tensor) or not any(act) or name in _NEW:
            return out
        key = (name, tuple(id(a) if isinstance(a, torch.Tensor) else
                           tuple(map(id, a)) if isinstance(a, (list, tuple))
                           else a for a in args))
        if key in self.seen:  # the same value again: the kernel reuses it
            return self.seen[key]
        self.seen[key] = out
        self.keep.append(out)
        self.active.add(id(out))
        if name in _FREE:
            return out
        m = out.numel()
        if name in _ADD:
            p, t = m, m
        elif name in _MUL:
            p, t = m, (3 if sum(act) == 2 else 1) * m
        elif name in _DIV or name in _RDIV:  # a / b, or b.__rtruediv__(a)
            divisor_active = act[0] if name in _RDIV else len(act) > 1 and act[1]
            p, t = m, (3 if divisor_active else 1) * m
        elif name in _TRANS:
            p, t = _TRANS[name] * m, m
        elif name in _SELECT:
            p, t = m, 0
        elif name == "sum":
            k = tensors[0].numel() - m
            p, t = k, k
        else:
            raise NotImplementedError(f"opcount: no cost for {name!r}")
        self.primal += p
        self.tangent += t
        return out


def dyn_counts(f, nx, nu, p) -> Counts:
    """:class:`Counts` of one evaluation of ``f(x, u, p)`` (entries
    leading), p a (p_dim,) tensor of the scenario's parameters."""
    x = torch.zeros(nx)
    x[3] = 8.0  # a moving state, so no guard takes another branch
    u = torch.zeros(nu)
    mode = _Count([x, u])
    with mode:
        f(x, u, p)
    return Counts(mode.primal, mode.tangent)


# Operations of one RK4 step's combination per state, as
# ``csrc/vde.cuh:rk4_map`` does it: three stage points x + h k and two
# accumulations acc + 2k (FMAs), then x + h/6 (acc + k).
RK4_COMBINE = 3 * 2 + 2 * 2 + 3


def rk4_flops(c: Counts, nx):
    """Operations of one RK4 step without tangents: 4 evaluations and the
    combination."""
    return 4 * c.primal + nx * RK4_COMBINE


def sweep_flops(c: Counts, nx, nu):
    """Operations of one stage of the VDE sweep: the RK4 step with its
    nx + nu tangents (each evaluation's primal once, its tangent cost per
    tangent; the combination is linear, so a tangent costs it again) and
    the defect."""
    nt = nx + nu
    return 4 * (c.primal + nt * c.tangent) + nx * RK4_COMBINE * (1 + nt) + nx
