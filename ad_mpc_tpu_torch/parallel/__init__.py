"""The fleet split over processes: rank layouts and process groups
(:mod:`.mesh`), the fleet stepper (:mod:`.batch`), the multi-process run
(:mod:`.multihost`) and the scaling measurements (:mod:`.scaling`)."""

from ad_mpc_tpu_torch.parallel.batch import BatchedSolver
from ad_mpc_tpu_torch.parallel.mesh import make_layout, make_layout_2d

__all__ = ["make_layout", "make_layout_2d", "BatchedSolver"]
