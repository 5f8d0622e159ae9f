// The dual-state GP quadrotor of QuadMPC's ensemble mode (vde.cuh):
// GPQuadDualDynT<Drag>, every cluster's table in a device buffer staged
// into dynamic shared memory, without the RDRv drag (GPQuadDualDyn) and
// with it (GPQuadDualDragDyn); each built in a source of its own
// (vde_gp_quad_dual.cu, vde_gp_quad_dual_drag.cu), so that the builds run
// in parallel.

#pragma once

#ifndef GP_QUAD_DUAL_ROW_TEAM
#define GP_QUAD_DUAL_ROW_TEAM 4
#endif
#ifndef GP_QUAD_DUAL_ROW_WARPS
#define GP_QUAD_DUAL_ROW_WARPS 4
#endif
#ifndef GP_QUAD_DUAL_MIN_BLOCKS
#define GP_QUAD_DUAL_MIN_BLOCKS 2
#endif

#include "vde_models.cuh"

struct GPQuadDualParamsC {  // by value from the wrapper (models/gp_quad.py)
  QuadParamsC quad;
  const float* table;  // device: X, a, 1/l, y_mean (GPDualTable)
  int clusters, n;     // clusters, points per cluster (padded)
  int d_out;           // D: p = [trigger, mu0 (D), cluster (D)]
  int slot[3];         // the output k in p of body velocity r, or -1
  QuadDragOptC drag;   // the RDRv drag (QuadMPC's rdrv_d with ensemble=)
};

// The layout a launch of GPQuadDualDyn may take: at least one output, a
// p of 1 + 2D entries, a table within capacity, each output in one slot.
static bool params_ok(const GPQuadDualParamsC& P, int pd) {
  if (P.table == nullptr || P.d_out < 1 || P.d_out > 3 || pd != 1 + 2 * P.d_out ||
      P.clusters < 1 || P.clusters > GP_DUAL_CLUSTERS || P.n < 1 ||
      P.clusters * P.n > GP_DUAL_POINTS)
    return false;
  int seen = 0;
  for (int r = 0; r < 3; ++r) {
    if (P.slot[r] < -1 || P.slot[r] >= P.d_out) return false;
    if (P.slot[r] >= 0) seen |= 1 << P.slot[r];
  }
  return seen == (1 << P.d_out) - 1;
}

// The quadrotor plus the dual-state GP of QuadMPC's ensemble mode
// (ad_mpc_tpu/control/mpc.py:264-283): each scenario's p is [trigger,
// mu0 (D), cluster (D)]. With trigger > 0.5 (node 0) the body-frame means
// are the constants mu0, whose derivative in x is 0: the residual's
// Jacobian is (dR/dq) mu0 alone, and no GP mean is computed. Otherwise
// each output's mean comes from the cluster its p names (truncated as
// .astype(int32) truncates, clamped to the table as a JAX gather clamps)
// at the body-frame velocities, lifted as GPQuadDyn lifts it. The table
// of every cluster lies in dynamic shared memory (staged once per block),
// so the scenarios of a block may each read another cluster. The sweep
// runs a team of ROW_TEAM lanes per row, as GPQuadDyn's (vde.cuh:
// vde_team): lanes 0-2 of the team each sum one output dim's mean over
// its cluster's points (team_means); the trigger is uniform within a
// team, not across the teams of a warp, so every lane reaches the
// shuffles and a trigger row takes mu0 after them. The RK4 map (T =
// float) computes the 3 sums itself. With Drag (QuadMPC's rdrv_d beside
// ensemble=), the RDRv drag is added before the GP (gp_quad_rows). The
// drag is a template argument and not a run-time flag, since a branch on
// the flag stops the drag-free rows' products from contracting into one
// FMA and so changes their bits.
template <bool Drag>
struct GPQuadDualDynT {
  static constexpr int NX = 13, NU = 4, NP = 3;  // NP: the least p (D = 1)
  static constexpr int ROW_TEAM = GP_QUAD_DUAL_ROW_TEAM;
  static constexpr int ROW_WARPS = GP_QUAD_DUAL_ROW_WARPS;
  static constexpr int MIN_BLOCKS = GP_QUAD_DUAL_MIN_BLOCKS;
  static constexpr bool STAGES = false;
  struct Ctx {
    const float* tab = nullptr;  // the staged table
    bool trigger = false;
    float mu0[3] = {0.0f, 0.0f, 0.0f};  // by body velocity
    int cl[3] = {0, 0, 0};
  };
  GPQuadDualParamsC P;

  DI Ctx context(const float* p) const {
    Ctx c;
    c.trigger = p[0] > 0.5f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int k = P.slot[r];
      if (k >= 0) {
        c.mu0[r] = p[1 + k];
        c.cl[r] = min(max((int)p[1 + P.d_out + k], 0), P.clusters - 1);
      }
    }
    return c;
  }

  __host__ __device__ int table_floats() const {
    return gp_dual_table_floats(P.clusters, P.n);
  }

  DI void stage_to(float* dst) const {
    const int len = table_floats();
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = P.table[i];
  }

  DI void use_table(Ctx& c, const float* tab) const { c.tab = tab; }

  // Output dim d's mean and gradient at the body velocity z, from its
  // cluster.
  DI float mean(const Ctx& c, int d, const float* z, float* g) const {
    const GPDualTable t(c.tab, P.clusters, P.n);
    const int cl = pick3(c.cl, d);
    return gp_table_mean<GP_QUAD_FEATS>(t.X(d, cl), t.a(d, cl), P.n, t.inv_l(d, cl),
                                        t.y_mean(d, cl), z, g);
  }

  template <class T>
  DI void means(const Ctx& c, const float* z, float* mu, float (*g)[GP_QUAD_FEATS]) const {
    if constexpr (std::is_same<T, float>::value) {
      if (!c.trigger) {
#pragma unroll
        for (int d = 0; d < GP_QUAD_DIMS; ++d) mu[d] = mean(c, d, z, g[d]);
        return;
      }
    } else {
      team_means<ROW_TEAM, GP_QUAD_DIMS, GP_QUAD_FEATS>(
          !c.trigger, [&](int d, float* gd) { return mean(c, d, z, gd); }, mu, g);
      if (!c.trigger) return;
    }
#pragma unroll
    for (int d = 0; d < GP_QUAD_DIMS; ++d) {
      mu[d] = c.mu0[d];
#pragma unroll
      for (int k = 0; k < GP_QUAD_FEATS; ++k) g[d][k] = 0.0f;
    }
  }

  // The team's duals sum the means before the quad's rows, while the
  // evaluation's outputs hold no registers yet; the RK4 map (T = float)
  // keeps the order of its first design, and its bits.
  template <class T>
  DI void operator()(const T* x, const T* u, const Ctx& c, T* xd) const {
    constexpr bool scalar = std::is_same<T, float>::value;
    if constexpr (scalar) quad_xdot(P.quad, x, u, xd);
    float q[4], v[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = value(x[3 + i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = value(x[7 + i]);
    float R[3][3], vb[3];
    rot_matrix(q, R);
#pragma unroll
    for (int r = 0; r < 3; ++r) vb[r] = R[0][r] * v[0] + R[1][r] * v[1] + R[2][r] * v[2];
    float mu[GP_QUAD_DIMS], g[GP_QUAD_DIMS][GP_QUAD_FEATS];
    means<T>(c, vb, mu, g);
    if constexpr (!scalar) quad_xdot(P.quad, x, u, xd);
    if constexpr (Drag) {
      gp_quad_rows(x, q, v, R, vb, mu, g, P.drag, xd);
    } else {
      float res[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) res[r] = R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2];
      if constexpr (scalar) {
#pragma unroll
        for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + res[r];
      } else {
        float J[3][7];
        gp_quad_jacobian(q, v, R, mu, g, J);
#pragma unroll
        for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + gp_lift<7>(res[r], J[r], x + 3);
      }
    }
  }
};

// Named structs, not aliases, so that each kernel's mangled name carries
// its functor's name (_build.functor_resources).
struct GPQuadDualDyn : GPQuadDualDynT<false> {};
struct GPQuadDualDragDyn : GPQuadDualDynT<true> {};
