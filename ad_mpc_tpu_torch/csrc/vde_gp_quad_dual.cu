// The dual-state GP quadrotor of QuadMPC's ensemble mode (vde.cuh):
// GPQuadDualDyn, every cluster's table in a device buffer staged into
// dynamic shared memory.

#ifndef GP_QUAD_DUAL_TANGENTS_PER_PASS
#define GP_QUAD_DUAL_TANGENTS_PER_PASS 3
#endif
#ifndef GP_QUAD_DUAL_ROW_WARPS
#define GP_QUAD_DUAL_ROW_WARPS 2
#endif

#include "vde_models.cuh"

// Capacity of GPQuadDualDyn's table: clusters x points of each output dim.
constexpr int GP_DUAL_CLUSTERS = 16, GP_DUAL_POINTS = 512;
// Floats of the largest table (gp_dual_table_floats at the capacity).
constexpr int GP_DUAL_TABLE_MAX = 3 * (4 * GP_DUAL_POINTS + 4 * GP_DUAL_CLUSTERS);

struct GPQuadDualParamsC {  // by value from the wrapper (models/gp_quad.py)
  QuadParamsC quad;
  const float* table;  // device: X, a, 1/l, y_mean (gp_dual_table)
  int clusters, n;     // clusters, points per cluster (padded)
  int d_out;           // D: p = [trigger, mu0 (D), cluster (D)]
  int slot[3];         // the output k in p of body velocity r, or -1
};

// The table of GPQuadDualDyn, as the wrapper lays it out in device memory
// and each block copies it to shared memory, padded to the 3 body
// velocities as outputs and features (an unused output has a = 0 and
// y_mean = 0, an unused feature 1/l = 0: exact zeros that leave the used
// dims' arithmetic as it is): X (3, C, n, 3), a = k_inv_y sigma_f
// (3, C, n), 1/l (3, C, 3), y_mean (3, C).
struct GPDualTable {
  const float* base;
  int clusters, n;
  DI const float* X(int d, int c) const { return base + (d * clusters + c) * n * 3; }
  DI const float* a(int d, int c) const {
    return base + 9 * clusters * n + (d * clusters + c) * n;
  }
  DI const float* inv_l(int d, int c) const {
    return base + 12 * clusters * n + (d * clusters + c) * 3;
  }
  DI float y_mean(int d, int c) const {
    return base[12 * clusters * n + 9 * clusters + d * clusters + c];
  }
};
__host__ __device__ constexpr int gp_dual_table_floats(int clusters, int n) {
  return 3 * clusters * (4 * n + 4);
}

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
// Jacobian is (dR/dq) mu0 alone, and no GP mean is computed, stored or
// read. Otherwise each output's mean comes from the cluster its p names
// (truncated as .astype(int32) truncates, clamped to the table as a JAX
// gather clamps) at the body-frame velocities, lifted as GPQuadDyn lifts
// it, its means cached by the first pass for the later ones. The table of
// every cluster lies in dynamic shared memory (staged once per block), so
// the scenarios of a block may each read another cluster.
struct GPQuadDualDyn {
  static constexpr int NX = 13, NU = 4, NP = 3;  // NP: the least p (D = 1)
  static constexpr int TANGENTS_PER_PASS = GP_QUAD_DUAL_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = GP_QUAD_DUAL_ROW_WARPS;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = GP_QUAD_CACHE_EVALS * GP_QUAD_EVAL;
  struct Ctx : GPQuadCache {
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

  DI void use_cache(Ctx& c, float* slot, int evals) const { c.use(slot, evals); }

  DI void means(const Ctx& c, const float* z, float* mu,
                float (*g)[GP_QUAD_FEATS]) const {
    const GPDualTable t{c.tab, P.clusters, P.n};
#pragma unroll
    for (int d = 0; d < 3; ++d)
      mu[d] = gp_table_mean<GP_QUAD_FEATS>(t.X(d, c.cl[d]), t.a(d, c.cl[d]), P.n,
                                           t.inv_l(d, c.cl[d]), t.y_mean(d, c.cl[d]),
                                           z, g[d]);
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const Ctx& c, T* xd) const {
    quad_xdot(P.quad, x, u, xd);
    float q[4], v[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = value(x[3 + i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = value(x[7 + i]);
    float R[3][3];
    rot_matrix(q, R);
    float mu[GP_QUAD_DIMS], g[GP_QUAD_DIMS][GP_QUAD_FEATS];
    if (c.trigger) {
#pragma unroll
      for (int d = 0; d < GP_QUAD_DIMS; ++d) {
        mu[d] = c.mu0[d];
#pragma unroll
        for (int k = 0; k < GP_QUAD_FEATS; ++k) g[d][k] = 0.0f;
      }
    } else {
      float vb[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) vb[r] = R[0][r] * v[0] + R[1][r] * v[1] + R[2][r] * v[2];
      c.means_of<T, ROW_WARPS * WARP>(
          [&](float* m, float (*gm)[GP_QUAD_FEATS]) { means(c, vb, m, gm); }, mu, g);
    }
    float res[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) res[r] = R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + res[r];
    } else {
      float J[3][7];
      gp_quad_jacobian(q, v, R, mu, g, J);
#pragma unroll
      for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + gp_lift<7>(res[r], J[r], x + 3);
    }
  }
};

extern "C" {

VDE_ENTRIES(gp_quad_dual, GPQuadDualDyn, GPQuadDualParamsC)

// At the library's first load: let the kernels of a dyn_table functor take
// the shared memory of its largest table, so that no launch sets an
// attribute and a launch may be captured in a CUDA graph.
int vde_prepare() {
  using Dyn = GPQuadDualDyn;
  constexpr int table = GP_DUAL_TABLE_MAX;
  const int vde_bytes = (int)(sizeof(float) * (Dyn::ROW_WARPS * (vde_tile<Dyn>() +
                                                                 WARP * Dyn::CACHE_FLOATS) +
                                               table));
  cudaError_t err = cudaFuncSetAttribute(
      vde_kernel<Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize, vde_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(rk4_kernel<Dyn>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(sizeof(float) * table));
}

VDE_ERROR_STRING

}  // extern "C"
