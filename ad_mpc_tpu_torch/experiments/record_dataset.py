"""Dataset recording: aggressive random point-to-point flights.

Port of ``ad_mpc_tpu/experiments/record_dataset.py``: fly the quad from
target to random target under the disturbance suite, with the port's
:class:`QuadMPC` (N=10, ``qp_iters=12``, float32, on ``device``) against
``QuadrotorSim`` at 1 ms sub-steps, and record (state in, input, state
out, nominal prediction, dt) for the residual models. A flight that
diverges (a non-finite state, or 3 box widths from the origin) is reset
before its sample is recorded. The nominal prediction is the RK4 map (4
sub-steps over the control period) of the nominal quad, in float64 on the
host, batched over the samples at the end.

The flights themselves do not repeat another recording beyond its first
few samples: the 12-iteration IPM stops short at the saturated input box,
so u moves with rounding. What is deterministic is each sample's plant
step and nominal prediction from its (x_in, u) (:func:`replay`), and the
recorder's walk through targets, resets and timeouts
(:func:`flight_segments` reads it back from a recording).

    python -m ad_mpc_tpu_torch.experiments.record_dataset [--targets 5] [--device cuda]
    python -m ad_mpc_tpu_torch.experiments.record_dataset --segments DIR [--targets 24 --box 6]
"""

from __future__ import annotations

import numpy as np
import torch

from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams, hover_input, quad_dynamics_lane
from ad_mpc_tpu_torch.ops.integrators import discretize
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig, QuadrotorSim
from ad_mpc_tpu_torch.utils import io


def nominal_prediction(x_in, u, control_period: float,
                       params: QuadrotorParams = QuadrotorParams()):
    """(m, 13) F_nom(x_in, u): the nominal quad's RK4 map over one control
    period in 4 sub-steps, float64."""
    F = discretize(lambda x, uu: quad_dynamics_lane(x, uu, None, params), control_period, 4)
    x = torch.as_tensor(np.asarray(x_in, np.float64)).T
    uu = torch.as_tensor(np.asarray(u, np.float64)).T
    return F(x, uu).T.numpy()


def replay(x_in, u, control_period: float = 0.02,
           disturbances: DisturbanceConfig = DisturbanceConfig(drag=True),
           params: QuadrotorParams = QuadrotorParams()):
    """(x_out, x_pred), each (m, 13): the plant step (``QuadrotorSim`` at 1
    ms sub-steps, as :func:`record_flights` flies it; deterministic modes
    only) and the nominal prediction of every recorded (x_in, u), in
    float64 on the host."""
    sim = QuadrotorSim(params=params, disturbances=disturbances, sim_dt=1e-3)
    x_out = np.stack([
        sim.step(torch.as_tensor(np.asarray(x, np.float64)),
                 torch.as_tensor(np.asarray(uu, np.float64)), control_period).numpy()
        for x, uu in zip(x_in, u)])
    return x_out, nominal_prediction(x_in, u, control_period, params)


def targets(n_targets: int, box: float, seed: int = 0):
    """(n_targets, 3) target positions, drawn by
    ``numpy.random.default_rng(seed)`` as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_targets, 3))
    for k in range(n_targets):
        out[k] = rng.uniform(-box, box, 3)
        out[k, 2] = abs(out[k, 2]) + 0.5
    return out


def flight_segments(arrays, n_targets: int, box: float, seed: int = 0,
                    control_period: float = 0.02):
    """The recorder's walk read back from a recording: one dict per target
    with its first row, its samples, whether it ended at the target (within
    0.15 m), by a reset (a non-finite x_out, or a next x_in that is not
    this x_out: the divergent step went unrecorded) or at the 2 s limit,
    its start distance and its largest speed."""
    x_in, x_out = arrays["x_in"], arrays["x_out"]
    m, limit, i, out = len(x_in), int(2.0 / control_period), 0, []
    for k, tgt in enumerate(targets(n_targets, box, seed)):
        first, end = i, "limit"
        while i < m and i - first < limit:
            i += 1
            xo = x_out[i - 1]
            if not np.all(np.isfinite(xo)) or (
                    i < m and np.abs(x_in[i] - xo).max() > 1e-6):
                end = "reset"
                break
            if np.linalg.norm(xo[:3] - tgt) < 0.15:
                end = "target"
                break
        v = np.linalg.norm(x_in[first:i, 7:10], axis=1)
        out.append({"target": k, "first": first, "samples": i - first, "end": end,
                    "start_m": float(np.linalg.norm(x_in[first, :3] - tgt))
                    if first < m else None,
                    "v_max": float(v.max()) if len(v) else None})
    return out


def record_flights(n_targets: int = 10, box: float = 4.0, control_period: float = 0.02,
                   disturbances: DisturbanceConfig = DisturbanceConfig(drag=True),
                   seed: int = 0, dataset_name: str | None = None, verbose: bool = False,
                   device="cuda", backend: str = "auto", max_steps: int | None = None,
                   return_mpc: bool = False):
    """The recorded arrays ``x_in``, ``u``, ``x_out``, ``x_pred``, ``dt``
    (saved under the port's dataset root as ``dataset_name`` when given).
    Targets are drawn by ``numpy.random.default_rng(seed)`` as the JAX
    package draws them. Each target is flown for at most 2 s, or
    ``max_steps`` control periods when that is fewer. ``return_mpc``:
    return (arrays, the controller), for its solver's launch counts."""
    params = QuadrotorParams()
    spec = quad_spec(n_nodes=10, qp_iters=12)
    mpc = QuadMPC(spec=spec, params=params, dtype=torch.float32, device=device,
                  backend=backend)
    sim = QuadrotorSim(params=params, disturbances=disturbances, sim_dt=1e-3, seed=seed)
    start = np.zeros(13)
    start[3] = 1.0
    x = torch.as_tensor(start)
    rec = {k: [] for k in ("x_in", "u", "x_out", "dt")}
    for tgt_i, pos in enumerate(targets(n_targets, box, seed)):
        target = start.copy()
        target[:3] = pos
        mpc.set_reference(np.tile(target, (spec.n_nodes + 1, 1)),
                          np.tile(hover_input(params), (spec.n_nodes, 1)))
        steps = int(2.0 / control_period)
        for _ in range(steps if max_steps is None else min(steps, max_steps)):
            us, _ = mpc.optimize(x)
            u0 = us[0].cpu()
            x_next = sim.step(x, u0, control_period)
            xn = x_next.numpy()
            # Reset on divergence before the sample is recorded: a
            # non-finite x_out would poison the residual dataset.
            if not np.all(np.isfinite(xn)) or np.linalg.norm(xn[:3]) > 3 * box:
                x = torch.as_tensor(start)
                mpc.reset()
                break
            rec["x_in"].append(x.numpy())
            rec["u"].append(u0.double().numpy())
            rec["x_out"].append(xn)
            rec["dt"].append(control_period)
            x = x_next
            if np.linalg.norm(xn[:3] - target[:3]) < 0.15:
                break
        if verbose:
            print(f"target {tgt_i}: reached "
                  f"{np.linalg.norm(x.numpy()[:3] - target[:3]):.3f} m, "
                  f"{len(rec['dt'])} samples so far")
    arrays = {k: np.asarray(v) for k, v in rec.items()}
    arrays["x_pred"] = nominal_prediction(arrays["x_in"], arrays["u"], control_period, params)
    if dataset_name:
        d = io.dataset_dir(dataset_name, "train",
                           {"disturbances": list(map(bool, disturbances)), "seed": seed},
                           create=True)
        io.save_arrays(d, **arrays)
    return (arrays, mpc) if return_mpc else arrays


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--targets", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--box", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="the controller's device; cpu runs the plain versions")
    ap.add_argument("--segments", metavar="DIR",
                    help="print the flights of the recording DIR/data.npz (made "
                         "with --targets, --box and --seed) and fly nothing")
    args = ap.parse_args(argv)
    if args.segments:
        with np.load(f"{args.segments}/data.npz") as z:
            arrays = dict(z)
        for seg in flight_segments(arrays, args.targets, args.box, args.seed):
            print(seg)
        return
    arrays = record_flights(n_targets=args.targets, box=args.box, seed=args.seed,
                            verbose=True, device=args.device)
    print({k: v.shape for k, v in arrays.items()})


if __name__ == "__main__":
    main()
