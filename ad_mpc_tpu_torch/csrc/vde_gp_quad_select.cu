// The clustered GP quadrotor of QuadMPC's quad_residual_fn mode (vde.cuh):
// GPQuadSelectDyn, the nearest centroid picked at every evaluation (or a
// cluster pinned per output) from a table of every cluster, staged from a
// device buffer into dynamic shared memory.

#ifndef GP_QUAD_SELECT_ROW_TEAM
#define GP_QUAD_SELECT_ROW_TEAM 4
#endif
#ifndef GP_QUAD_SELECT_ROW_WARPS
#define GP_QUAD_SELECT_ROW_WARPS 4
#endif
#ifndef GP_QUAD_SELECT_MIN_BLOCKS
#define GP_QUAD_SELECT_MIN_BLOCKS 2
#endif

#include "vde_models.cuh"

// Floats of the largest table: GPQuadDualDyn's, then the centroids.
constexpr int GP_SELECT_TABLE_MAX = GP_DUAL_TABLE_MAX + 9 * GP_DUAL_CLUSTERS + 3;

struct GPQuadSelectParamsC {  // by value from the wrapper (models/gp_quad.py)
  QuadParamsC quad;
  const float* table;  // device: X, a, 1/l, y_mean, centroids (GPDualTable)
  int clusters, n;     // clusters, points per cluster (padded)
  int d_feat;          // the ensemble's features, d
  int feat[3];         // the body velocity of feature j (j < d)
  int pin[3];          // by body velocity: its cluster, or -1: the nearest
  QuadDragOptC drag;   // the RDRv drag (QuadMPC's rdrv_d with residual_fn=)
};

__host__ __device__ constexpr int gp_select_table_floats(int clusters, int n) {
  return gp_dual_table_floats(clusters, n) + 9 * clusters + 3;
}

// The layout a launch of GPQuadSelectDyn may take: a table within
// capacity, 1-3 distinct features on the body velocities, each pin -1 or
// a cluster of the table.
static bool params_ok(const GPQuadSelectParamsC& P, int) {
  if (P.table == nullptr || P.clusters < 1 || P.clusters > GP_DUAL_CLUSTERS ||
      P.n < 1 || P.clusters * P.n > GP_DUAL_POINTS || P.d_feat < 1 || P.d_feat > 3)
    return false;
  int seen = 0;
  for (int j = 0; j < P.d_feat; ++j) {
    if (P.feat[j] < 0 || P.feat[j] > 2 || (seen >> P.feat[j]) & 1) return false;
    seen |= 1 << P.feat[j];
  }
  for (int r = 0; r < 3; ++r)
    if (P.pin[r] < -1 || P.pin[r] >= P.clusters) return false;
  return true;
}

// The nearest of the C centroids cen (C rows of 3, the first d used) to
// the features z: the squared distance summed over the features in their
// order, each product and sum rounded on its own (no contraction into an
// FMA, as an elementwise square and sum round them), and a strict < scan
// in cluster order, so that a tie takes the first, as jnp.argmin and
// torch.argmin do (and a NaN distance never wins: cluster 0).
DI int nearest_cluster(const float* cen, int clusters, int d, const float* z) {
  int best = 0;
  float best_d2 = 0.0f;
  for (int c = 0; c < clusters; ++c) {
    float d2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < d) {
        const float t = __fsub_rn(cen[c * 3 + j], z[j]);
        d2 = __fadd_rn(d2, __fmul_rn(t, t));
      }
    }
    if (c == 0 || d2 < best_d2) {
      best = c;
      best_d2 = d2;
    }
  }
  return best;
}

// The quadrotor plus the clustered body-frame GP residual of QuadMPC's
// quad_residual_fn mode (ad_mpc_tpu/learned/ensemble.py:216-244 through
// predict(..., cluster_idx=None) at :124, or a fixed_cluster): at every
// evaluation the features z are the body-frame velocities v_b = R(q)^T v
// of the primal in the ensemble's order, each output takes its pinned
// cluster or the nearest of its centroids to z (nearest_cluster), and its
// mean and gradient from that cluster, lifted as GPQuadDyn lifts them.
// The choice is a float function of the primal with zero derivative, as
// JAX's jacfwd through an integer index gives it. With the drag on, the
// RDRv drag is added before the residual (gp_quad_rows). The table of
// every cluster lies in dynamic shared memory (staged once per block): C
// centroid distances per output and evaluation, then one cluster's
// points. The sweep runs a team of ROW_TEAM lanes per row, as GPQuadDyn's
// (vde.cuh: vde_team): lane d < 3 of the team picks output d's cluster and
// sums its mean (team_means), so that the 3 outputs' centroid scans and
// sums run at once. The RK4 map (T = float) picks and sums all 3 itself.
struct GPQuadSelectDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int ROW_TEAM = GP_QUAD_SELECT_ROW_TEAM;
  static constexpr int ROW_WARPS = GP_QUAD_SELECT_ROW_WARPS;
  static constexpr int MIN_BLOCKS = GP_QUAD_SELECT_MIN_BLOCKS;
  static constexpr bool STAGES = false;
  struct Ctx {
    const float* tab = nullptr;  // the staged table
  };
  GPQuadSelectParamsC P;

  DI Ctx context(const float*) const { return Ctx(); }

  __host__ __device__ int table_floats() const {
    return gp_select_table_floats(P.clusters, P.n);
  }

  DI void stage_to(float* dst) const {
    const int len = table_floats();
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = P.table[i];
  }

  DI void use_table(Ctx& c, const float* tab) const { c.tab = tab; }

  // Output dim d's mean and gradient at the body velocities vb, from its
  // pinned cluster or the nearest centroid to the features.
  DI float mean(const Ctx& c, int d, const float* vb, float* g) const {
    const GPDualTable t(c.tab, P.clusters, P.n);
    float z[3];  // the features in the ensemble's order (no indexed registers)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      z[j] = P.feat[j] == 0 ? vb[0] : (P.feat[j] == 1 ? vb[1] : vb[2]);
    const int pin = pick3(P.pin, d);
    const int cl = pin >= 0 ? pin : nearest_cluster(t.centroids(d), P.clusters, P.d_feat, z);
    return gp_table_mean<GP_QUAD_FEATS>(t.X(d, cl), t.a(d, cl), P.n, t.inv_l(d, cl),
                                        t.y_mean(d, cl), vb, g);
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
    if constexpr (scalar) {
#pragma unroll
      for (int d = 0; d < GP_QUAD_DIMS; ++d) mu[d] = mean(c, d, vb, g[d]);
    } else {
      team_means<ROW_TEAM, GP_QUAD_DIMS, GP_QUAD_FEATS>(
          true, [&](int d, float* gd) { return mean(c, d, vb, gd); }, mu, g);
      quad_xdot(P.quad, x, u, xd);
    }
    gp_quad_rows(x, q, v, R, vb, mu, g, P.drag, xd);
  }
};

extern "C" {

VDE_TEAM_ENTRIES(gp_quad_select, GPQuadSelectDyn, GPQuadSelectParamsC)

// At the library's first load: the sweep may take its tile and the largest
// table, the RK4 map the largest table (prepare_team).
int vde_prepare() { return (int)prepare_team<GPQuadSelectDyn>(GP_SELECT_TABLE_MAX); }

VDE_ERROR_STRING

}  // extern "C"
