// The quadrotor family of the VDE sweep and its RK4 map (vde.cuh): the
// quad of config c5 and QuadMPC's nominal mode (QuadDyn) and QuadMPC's
// RDRv-drag mode (QuadDragDyn), both team functors.

#ifndef QUAD_ROW_TEAM
#define QUAD_ROW_TEAM 8
#endif
#ifndef QUAD_ROW_WARPS
#define QUAD_ROW_WARPS 4
#endif
#ifndef QUAD_MIN_BLOCKS
#define QUAD_MIN_BLOCKS 4
#endif
#ifndef QUAD_DRAG_ROW_TEAM
#define QUAD_DRAG_ROW_TEAM 4
#endif
#ifndef QUAD_DRAG_ROW_WARPS
#define QUAD_DRAG_ROW_WARPS 4
#endif
#ifndef QUAD_DRAG_MIN_BLOCKS
#define QUAD_DRAG_MIN_BLOCKS 2
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
// t = R w. The RK4 map (T = float) computes it so.
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
// (ad_mpc_tpu/control/mpc.py:286-290); p is not read. A team of ROW_TEAM
// lanes per row, as QuadDyn's. On a lane's duals the drag is a float
// function of the 7 entries (q, v): its value t at the primal, in the
// order of quad_drag_terms, and its Jacobian, that of a GP quad's residual
// R mu(R^T v) with mu = D v_b and G = D (gp_quad_jacobian), lifted to the
// lane's columns by one contraction (gp_lift), so no dual rotation is
// held in registers. The team computes the drag's floats before the
// quad's rows, while the evaluation's outputs hold no registers yet (after
// them it spilled more and ran slower, PERF.md); the RK4 map (T = float)
// keeps the dual-free order of its first design, and its bits.
struct QuadDragDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int ROW_TEAM = QUAD_DRAG_ROW_TEAM;
  static constexpr int ROW_WARPS = QUAD_DRAG_ROW_WARPS;
  static constexpr int MIN_BLOCKS = QUAD_DRAG_MIN_BLOCKS;
  static constexpr bool STAGES = false;
  using Ctx = const float*;
  QuadDragParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float*, T* xd) const {
    if constexpr (std::is_same<T, float>::value) {
      quad_xdot(P.quad, x, u, xd);
      T t[3];
      quad_drag_terms(P.D, x, t);
#pragma unroll
      for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + t[r];
    } else {
      float q[4], v[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = value(x[3 + i]);
#pragma unroll
      for (int i = 0; i < 3; ++i) v[i] = value(x[7 + i]);
      float R[3][3], vb[3], w[3], t[3];
      rot_matrix(q, R);
#pragma unroll
      for (int k = 0; k < 3; ++k) vb[k] = R[0][k] * v[0] + R[1][k] * v[1] + R[2][k] * v[2];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        w[r] = P.D[r][0] * vb[0] + P.D[r][1] * vb[1] + P.D[r][2] * vb[2];
#pragma unroll
      for (int r = 0; r < 3; ++r) t[r] = R[r][0] * w[0] + R[r][1] * w[1] + R[r][2] * w[2];
      float J[3][7];
      gp_quad_jacobian(q, v, R, w, P.D, J);
      quad_xdot(P.quad, x, u, xd);
#pragma unroll
      for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + gp_lift<7>(t[r], J[r], x + 3);
    }
  }
};

extern "C" {

VDE_TEAM_ENTRIES(quad, QuadDyn, QuadParamsC)
VDE_TEAM_ENTRIES(quad_drag, QuadDragDyn, QuadDragParamsC)

// The team sweeps' block tiles.
int vde_prepare() {
  const cudaError_t err = prepare_team<QuadDyn>();
  return (int)(err != cudaSuccess ? err : prepare_team<QuadDragDyn>());
}

VDE_ERROR_STRING

}  // extern "C"
