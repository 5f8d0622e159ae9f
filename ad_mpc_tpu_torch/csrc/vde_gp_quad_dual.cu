// The dual-state GP quadrotor of QuadMPC's ensemble mode in the VDE sweep
// and its RK4 map (vde.cuh): GPQuadDualDyn (vde_gp_quad_dual.cuh).

#include "vde_gp_quad_dual.cuh"

extern "C" {

VDE_TEAM_ENTRIES(gp_quad_dual, GPQuadDualDyn, GPQuadDualParamsC)

// At the library's first load: the sweep may take its tile and the largest
// table, the RK4 map the largest table (prepare_team).
int vde_prepare() { return (int)prepare_team<GPQuadDualDyn>(GP_DUAL_TABLE_MAX); }

VDE_ERROR_STRING

}  // extern "C"
