// The dual-state GP quadrotor of QuadMPC's ensemble mode with the RDRv
// drag in the VDE sweep and its RK4 map (vde.cuh): GPQuadDualDragDyn
// (vde_gp_quad_dual.cuh).

#include "vde_gp_quad_dual.cuh"

extern "C" {

VDE_ENTRIES(gp_quad_dual_drag, GPQuadDualDragDyn, GPQuadDualParamsC)

// At the library's first load: the kernels may take the largest table
// (prepare_table).
int vde_prepare() { return (int)prepare_table<GPQuadDualDragDyn>(GP_DUAL_TABLE_MAX); }

VDE_ERROR_STRING

}  // extern "C"
