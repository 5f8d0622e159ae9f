// The dual-state GP quadrotor of QuadMPC's ensemble mode with the RDRv
// drag in the VDE sweep and its RK4 map (vde.cuh): GPQuadDualDragDyn
// (vde_gp_quad_dual.cuh).

#include "vde_gp_quad_dual.cuh"

extern "C" {

VDE_TEAM_ENTRIES(gp_quad_dual_drag, GPQuadDualDragDyn, GPQuadDualParamsC)

// At the library's first load: the sweep may take its tile and the largest
// table, the RK4 map the largest table (prepare_team).
int vde_prepare() { return (int)prepare_team<GPQuadDualDragDyn>(GP_DUAL_TABLE_MAX); }

VDE_ERROR_STRING

}  // extern "C"
