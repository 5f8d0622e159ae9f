// The GP-bicycle family of the VDE sweep and its RK4 map (vde.cuh): the
// bicycle plus the baked GP mean of config c3 (GPBicycleDyn), and the
// bicycle plus a parameter-routed GP (GPRoutedDyn), whose every scenario
// reads its own cluster's GP from its parameter row.

#ifndef GP_BICYCLE_ROW_TEAM
#define GP_BICYCLE_ROW_TEAM 1
#endif
#ifndef GP_BICYCLE_ROW_WARPS
#define GP_BICYCLE_ROW_WARPS 4
#endif
#ifndef GP_BICYCLE_MIN_BLOCKS
#define GP_BICYCLE_MIN_BLOCKS 1
#endif

#include "vde_models.cuh"

// Capacity of the GP-bicycle's training table (models/gp_bicycle.py).
constexpr int GP_POINTS = 32, GP_DIMS = 2, GP_FEATS = 4;

struct GPBicycleParamsC {  // by value from the wrapper (models/gp_bicycle.py)
  BicycleParamsC bike;
  int n;                                    // training points, <= GP_POINTS
  float X[GP_DIMS][GP_POINTS][GP_FEATS];    // training features
  float a[GP_DIMS][GP_POINTS];              // k_inv_y * sigma_f
  float inv_l[GP_DIMS][GP_FEATS];           // 1 / length scale
  float y_mean[GP_DIMS];
};
static_assert(offsetof(GPBicycleParamsC, y_mean) ==
                  offsetof(GPBicycleParamsC, inv_l) + sizeof(float) * GP_DIMS * GP_FEATS,
              "stage() copies inv_l and y_mean as one range");

// The table's features, weights, 1/l and y_mean, copied once per block from
// the kernel's parameters by GPBicycleDyn::stage. The j loop reads them with
// an index the compiler cannot fold; from shared memory every lane of a
// warp that reads the same word gets it at once (a broadcast), where
// indexed reads of the parameter space cost the RK4 kernel 10x its time
// (PERF.md section 6). Each output dim's X and a lie four floats past the
// last dim's (models/gp_bicycle.py:gp_table_layout): a team's lanes 0 and 1
// read the same point of both dims at once, and without the pad the two
// addresses (128 and 32 floats apart) would lie in one bank; four floats,
// not one, keep every block on 16 bytes, so that the point loop reads X's
// rows and a's runs by 16-byte loads (a pad of one cost the thread per row
// 1.7%, PERF.md).
constexpr int GP_PAD = 4;
constexpr int GP_X_DIM = GP_POINTS * GP_FEATS + GP_PAD;
constexpr int GP_A_DIM = GP_POINTS + GP_PAD;
constexpr int GP_X = 0;
constexpr int GP_A = GP_X + GP_DIMS * GP_X_DIM;
constexpr int GP_INV_L = GP_A + GP_DIMS * GP_A_DIM;
constexpr int GP_Y_MEAN = GP_INV_L + GP_DIMS * GP_FEATS;
constexpr int GP_TABLE = GP_Y_MEAN + GP_DIMS;
__shared__ __align__(16) float gp_table[GP_TABLE];

// The dynamic bicycle (switch p[0]) plus the baked cluster-0 GP mean of the
// c3 bench config (bench.py:216-257): features x[3..6], outputs added to
// rows 4 and 5. With ROW_TEAM = 1 (the committed default) the sweep runs a
// thread per row, which sums both means itself and carries all 9 tangents;
// with ROW_TEAM > 1 (the measured variants of experiments/bicycle_kernels.py)
// a team of lanes per row (vde.cuh: vde_team), every lane on the same
// primal: at each evaluation lanes 0 and 1 of the team each sum one output
// dim's mean and gradient over the training points in gp_table_mean's
// order, and the team reads both means and their gradients from them
// (team_means). A dual takes them lifted onto its tangent columns
// (gp_lift). The team lost to the thread per row on the H100: its lanes
// each hold the primal, so a row takes about twice the registers, and
// fewer rows are in flight to hide the means' dependent chain (PERF.md).
// The RK4 map (T = float) computes both sums itself, in the order of its
// first design, and keeps its bits.
struct GPBicycleDyn {
  static constexpr int NX = 7, NU = 2, NP = 1;
  static constexpr int ROW_TEAM = GP_BICYCLE_ROW_TEAM;
  static constexpr int ROW_WARPS = GP_BICYCLE_ROW_WARPS;
  static constexpr int MIN_BLOCKS = GP_BICYCLE_MIN_BLOCKS;
  static constexpr bool STAGES = true;
  using Ctx = const float*;
  GPBicycleParamsC P;

  DI Ctx context(const float* p) const { return p; }

  // The block's threads copy the table to gp_table, each dim's X and a to
  // its padded place (a team's lanes also read 1/l and y_mean there, where
  // a thread per row and the RK4 map read them from the parameters by a
  // constant index); the kernel synchronizes the block after. The loops
  // pick no dim at run time: one loop over the whole range, its index
  // split by dim, cost the RK4 map 3%, these 1% (PERF.md).
  DI void stage() const {
    constexpr int NXD = GP_POINTS * GP_FEATS;  // one dim's X
    for (int i = threadIdx.x; i < NXD; i += blockDim.x) {
#pragma unroll
      for (int d = 0; d < GP_DIMS; ++d) gp_table[GP_X + d * GP_X_DIM + i] = (&P.X[d][0][0])[i];
    }
    for (int i = threadIdx.x; i < GP_POINTS; i += blockDim.x) {
#pragma unroll
      for (int d = 0; d < GP_DIMS; ++d) gp_table[GP_A + d * GP_A_DIM + i] = P.a[d][i];
    }
    if constexpr (ROW_TEAM > 1) {
      constexpr int NL = GP_DIMS * (GP_FEATS + 1);  // 1/l, then y_mean
      if (threadIdx.x < NL) gp_table[GP_INV_L + threadIdx.x] = (&P.inv_l[0][0])[threadIdx.x];
    }
  }

  // Output dim d's mean and gradient at the features z, all from gp_table.
  DI float mean(int d, const float* z, float* g) const {
    return gp_table_mean<GP_FEATS>(gp_table + GP_X + d * GP_X_DIM,
                                   gp_table + GP_A + d * GP_A_DIM, P.n,
                                   gp_table + GP_INV_L + d * GP_FEATS,
                                   gp_table[GP_Y_MEAN + d], z, g);
  }

  template <class T>
  DI void means(const float* z, float* mu, float (*g)[GP_FEATS]) const {
    if constexpr (std::is_same<T, float>::value || ROW_TEAM == 1) {
#pragma unroll
      for (int d = 0; d < GP_DIMS; ++d)
        mu[d] = gp_table_mean<GP_FEATS>(gp_table + GP_X + d * GP_X_DIM,
                                        gp_table + GP_A + d * GP_A_DIM, P.n, P.inv_l[d],
                                        P.y_mean[d], z, g[d]);
    } else {
      team_means<ROW_TEAM, GP_DIMS, GP_FEATS>(
          true, [&](int d, float* gd) { return mean(d, z, gd); }, mu, g);
    }
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const float* p, T* xd) const {
    float z[GP_FEATS], mu[GP_DIMS], g[GP_DIMS][GP_FEATS];
#pragma unroll
    for (int k = 0; k < GP_FEATS; ++k) z[k] = value(x[3 + k]);
    means<T>(z, mu, g);
    bicycle_xdot(P.bike, p[0], x, u, xd);
    xd[4] = xd[4] + gp_lift<GP_FEATS>(mu[0], g[0], x + 3);
    xd[5] = xd[5] + gp_lift<GP_FEATS>(mu[1], g[1], x + 3);
  }
};

// Capacity of GPRoutedDyn: training points per output dim.
constexpr int GP_ROUTED_POINTS = 32, GP_ROUTED_DIMS = 2, GP_ROUTED_FEATS = 4;

struct GPRoutedParamsC {  // by value from the wrapper (models/gp_routed.py)
  BicycleParamsC bike;
  int n;        // training points per output dim, <= GP_ROUTED_POINTS
  int base_pd;  // the bicycle's entries of p, before the GP's
};

// Floats of one output dim's GP in p, in the layout of
// ad_mpc_tpu/learned/lane.py:151-157: X (n x d, row-major), a = k_inv_y
// sigma_f (n), 1 / l (d), sigma_f, y_mean.
__host__ __device__ constexpr int gp_routed_floats(int n, int d) {
  return n * d + n + d + 2;
}

// A launch of GPRoutedDyn takes a p of base_pd + 2 GPs of n points.
static bool params_ok(const GPRoutedParamsC& P, int pd) {
  return P.n >= 1 && P.n <= GP_ROUTED_POINTS && P.base_pd >= 1 &&
         pd == P.base_pd + GP_ROUTED_DIMS * gp_routed_floats(P.n, GP_ROUTED_FEATS);
}

// The bicycle (switch p[0]) plus the parameter-routed GP of
// ad_mpc_tpu/learned/lane.py:200-253 (param_residual_dynamics, the plain
// form) in the layout of GPBicycleDyn: features x[3..6], outputs added to
// rows 4 and 5. Each scenario's GP lies in its own p row behind the
// bicycle's base_pd entries, so the scenarios of one launch may each carry
// another cluster; the kernels copy the block's p rows to shared memory
// (P_ROWS) before any row, and the means read their table there, lifted to
// the duals as GPBicycleDyn lifts them.
struct GPRoutedDyn {
  static constexpr int NX = 7, NU = 2, NP = 1;
  static constexpr int ROW_WARPS = 4;
  static constexpr bool STAGES = false, P_ROWS = true;
  using Ctx = const float*;  // the scenario's p row, in shared memory
  GPRoutedParamsC P;

  DI Ctx context(const float* p) const { return p; }
  __host__ __device__ int p_dim() const {
    return P.base_pd + GP_ROUTED_DIMS * gp_routed_floats(P.n, GP_ROUTED_FEATS);
  }

  // Output dim d's mean at z and its gradient, from the p row.
  DI float mean(const float* p, int d, const float* z, float* g) const {
    const float* gp = p + P.base_pd + d * gp_routed_floats(P.n, GP_ROUTED_FEATS);
    const float* inv_l = gp + P.n * (GP_ROUTED_FEATS + 1);
    return gp_table_mean<GP_ROUTED_FEATS>(gp, gp + P.n * GP_ROUTED_FEATS, P.n, inv_l,
                                          inv_l[GP_ROUTED_FEATS + 1], z, g);
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const float* p, T* xd) const {
    float z[GP_ROUTED_FEATS], g0[GP_ROUTED_FEATS], g1[GP_ROUTED_FEATS];
#pragma unroll
    for (int k = 0; k < GP_ROUTED_FEATS; ++k) z[k] = value(x[3 + k]);
    const float mu0 = mean(p, 0, z, g0);
    const float mu1 = mean(p, 1, z, g1);
    bicycle_xdot(P.bike, p[0], x, u, xd);
    xd[4] = xd[4] + gp_lift<GP_ROUTED_FEATS>(mu0, g0, x + 3);
    xd[5] = xd[5] + gp_lift<GP_ROUTED_FEATS>(mu1, g1, x + 3);
  }
};

extern "C" {

VDE_TEAM_ENTRIES(gp_bicycle, GPBicycleDyn, GPBicycleParamsC)
VDE_ENTRIES(gp_routed, GPRoutedDyn, GPRoutedParamsC)

// At the library's first load: GPBicycleDyn's team sweep its block tile,
// and GPRoutedDyn's kernels the most dynamic shared memory the device
// allows (its blocks' p rows).
int vde_prepare() {
  const cudaError_t err = prepare_team<GPBicycleDyn>();
  if (err != cudaSuccess) return (int)err;
  return (int)prepare_rows<GPRoutedDyn>();
}

VDE_ERROR_STRING

}  // extern "C"
