// The quadrotor family of the VDE sweep and its RK4 map (vde.cuh): the
// quad of config c5 and QuadMPC's nominal mode (QuadDyn) and QuadMPC's
// RDRv-drag mode (QuadDragDyn).

#ifndef QUAD_ROW_TEAM
#define QUAD_ROW_TEAM 8
#endif
#ifndef QUAD_ROW_WARPS
#define QUAD_ROW_WARPS 4
#endif
#ifndef QUAD_MIN_BLOCKS
#define QUAD_MIN_BLOCKS 4
#endif
#ifndef QUAD_DRAG_TANGENTS_PER_PASS
#define QUAD_DRAG_TANGENTS_PER_PASS 3
#endif
#ifndef QUAD_DRAG_ROW_WARPS
#define QUAD_DRAG_ROW_WARPS 1
#endif

#include "vde_models.cuh"

// The quadrotor; p is not read. A team of ROW_TEAM lanes per row
// (vde.cuh: vde_team), the 17 tangent columns split across them in one
// pass, registers capped for MIN_BLOCKS blocks of ROW_WARPS warps per SM
// (the sweep of experiments/quad_kernels.py).
struct QuadDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int ROW_TEAM = QUAD_ROW_TEAM;
  static constexpr int ROW_WARPS = QUAD_ROW_WARPS;
  static constexpr int MIN_BLOCKS = QUAD_MIN_BLOCKS;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = 0;
  using Ctx = const float*;
  QuadParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float*, T* xd) const {
    quad_xdot(P, x, u, xd);
  }
};

// The RDRv linear drag of ad_mpc_tpu/models/quadrotor.py:90-92 on the
// velocity rows, t = R(q) D R(q)^T v, with D a 3x3 matrix, entrywise in the
// order of models/quadrotor.py:quad_drag_rows: v_b = R^T v, w = D v_b,
// t = R w, every product carried as duals of (q, v). On an H100 at
// B=16384, N=10 (PERF.md section 6) these duals at 3 tangents per pass
// spill nothing; a float-Jacobian lift (as gp_quad_jacobian lifts the GP
// quad's residual) tied with them at 3 per pass (0.4216 against 0.4241 ms)
// and spilled 2,520 B at 6, where the duals spilled 3,244 B.
template <class T>
DI void quad_drag_terms(const float (&D)[3][3], const T* x, T* t) {
  T R[3][3], vb[3], w[3];
  rot_matrix(x + 3, R);
#pragma unroll
  for (int k = 0; k < 3; ++k) vb[k] = R[0][k] * x[7] + R[1][k] * x[8] + R[2][k] * x[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) w[r] = D[r][0] * vb[0] + D[r][1] * vb[1] + D[r][2] * vb[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) t[r] = R[r][0] * w[0] + R[r][1] * w[1] + R[r][2] * w[2];
}

struct QuadDragParamsC {  // by value from the wrapper (models/quadrotor.py)
  QuadParamsC quad;
  float D[3][3];  // the RDRv drag matrix
};

// The quadrotor with the RDRv drag of the QuadMPC's rdrv_d mode
// (ad_mpc_tpu/control/mpc.py:286-290); p is not read.
struct QuadDragDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int TANGENTS_PER_PASS = QUAD_DRAG_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = QUAD_DRAG_ROW_WARPS;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = 0;
  using Ctx = const float*;
  QuadDragParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float*, T* xd) const {
    quad_xdot(P.quad, x, u, xd);
    T t[3];
    quad_drag_terms(P.D, x, t);
#pragma unroll
    for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + t[r];
  }
};

extern "C" {

VDE_TEAM_ENTRIES(quad, QuadDyn, QuadParamsC)
VDE_ENTRIES(quad_drag, QuadDragDyn, QuadDragParamsC)

// The team sweep's block tile.
int vde_prepare() { return (int)prepare_team<QuadDyn>(); }

VDE_ERROR_STRING

}  // extern "C"
