// The GP-bicycle family of the VDE sweep and its RK4 map (vde.cuh): the
// bicycle plus the baked GP mean of config c3 (GPBicycleDyn), and the
// bicycle plus a parameter-routed GP (GPRoutedDyn), whose every scenario
// reads its own cluster's GP from its parameter row.

#ifndef GP_BICYCLE_TANGENTS_PER_PASS
#define GP_BICYCLE_TANGENTS_PER_PASS 9
#endif
#ifndef GP_BICYCLE_ROW_WARPS
#define GP_BICYCLE_ROW_WARPS 4
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
static_assert(offsetof(GPBicycleParamsC, a) ==
                  offsetof(GPBicycleParamsC, X) + sizeof(float) * GP_DIMS * GP_POINTS * GP_FEATS,
              "stage() copies X and a as one range");

// The table's features and weights (X, then a, as they lie in
// GPBicycleParamsC), copied once per block from the kernel's parameters by
// GPBicycleDyn::stage. The j loop reads them with an index the compiler
// cannot fold; from shared memory every lane of a warp reads the same word
// (a broadcast), where indexed reads of the parameter space cost the RK4
// kernel 10x its time (PERF.md section 6).
constexpr int GP_TABLE = GP_DIMS * GP_POINTS * (GP_FEATS + 1);
__shared__ float gp_table[GP_TABLE];

// c3's mean of output dim d from gp_table.
DI float gp_mean(const GPBicycleParamsC& P, int d, const float* z, float* g) {
  return gp_table_mean<GP_FEATS>(
      gp_table + d * GP_POINTS * GP_FEATS,
      gp_table + GP_DIMS * GP_POINTS * GP_FEATS + d * GP_POINTS, P.n,
      P.inv_l[d], P.y_mean[d], z, g);
}

// The dynamic bicycle (switch p[0]) plus the baked cluster-0 GP mean of the
// c3 bench config (bench.py:216-257): features x[3..6], outputs added to
// rows 4 and 5.
struct GPBicycleDyn {
  static constexpr int NX = 7, NU = 2, NP = 1;
  static constexpr int TANGENTS_PER_PASS = GP_BICYCLE_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = GP_BICYCLE_ROW_WARPS;
  static constexpr bool STAGES = true;
  using Ctx = const float*;
  GPBicycleParamsC P;

  DI Ctx context(const float* p) const { return p; }

  // Every thread of the block copies its share of X and a to gp_table; the
  // kernel synchronizes the block after.
  DI void stage() const {
    const float* src = &P.X[0][0][0];
    for (int i = threadIdx.x; i < GP_TABLE; i += blockDim.x) gp_table[i] = src[i];
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const float* p, T* xd) const {
    float z[GP_FEATS], g0[GP_FEATS], g1[GP_FEATS];
#pragma unroll
    for (int k = 0; k < GP_FEATS; ++k) z[k] = value(x[3 + k]);
    const float mu0 = gp_mean(P, 0, z, g0);
    const float mu1 = gp_mean(P, 1, z, g1);
    bicycle_xdot(P.bike, p[0], x, u, xd);
    xd[4] = xd[4] + gp_lift<GP_FEATS>(mu0, g0, x + 3);
    xd[5] = xd[5] + gp_lift<GP_FEATS>(mu1, g1, x + 3);
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
  static constexpr int TANGENTS_PER_PASS = 9, ROW_WARPS = 4;
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

VDE_ENTRIES(gp_bicycle, GPBicycleDyn, GPBicycleParamsC)
VDE_ENTRIES(gp_routed, GPRoutedDyn, GPRoutedParamsC)

// At the library's first load: GPRoutedDyn's kernels may take the most
// dynamic shared memory the device allows (its blocks' p rows).
int vde_prepare() { return (int)prepare_rows<GPRoutedDyn>(); }

VDE_ERROR_STRING

}  // extern "C"
