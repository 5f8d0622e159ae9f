// The GP quadrotor of config c6 in the VDE sweep and its RK4 map
// (vde.cuh): the quad plus the baked body-frame GP (GPQuadDyn).

#ifndef GP_QUAD_TANGENTS_PER_PASS
#define GP_QUAD_TANGENTS_PER_PASS 3
#endif
#ifndef GP_QUAD_ROW_WARPS
#define GP_QUAD_ROW_WARPS 2
#endif

#include "vde_models.cuh"

// Capacity of the GP-quad's training table (models/gp_quad.py): the bench's
// synthetic 32 points and the fitted gp_flagship_c1 model's 60.
constexpr int GP_QUAD_POINTS = 64;

struct GPQuadParamsC {  // by value from the wrapper (models/gp_quad.py)
  QuadParamsC quad;
  int n;                                                  // <= GP_QUAD_POINTS
  float X[GP_QUAD_DIMS][GP_QUAD_POINTS][GP_QUAD_FEATS];   // training features
  float a[GP_QUAD_DIMS][GP_QUAD_POINTS];                  // k_inv_y * sigma_f
  float inv_l[GP_QUAD_DIMS][GP_QUAD_FEATS];               // 1 / length scale
  float y_mean[GP_QUAD_DIMS];
};
static_assert(offsetof(GPQuadParamsC, a) ==
                  offsetof(GPQuadParamsC, X) +
                      sizeof(float) * GP_QUAD_DIMS * GP_QUAD_POINTS * GP_QUAD_FEATS,
              "stage() copies X and a as one range");

// GPQuadDyn's table (X, then a), as gp_table is GPBicycleDyn's.
constexpr int GP_QUAD_TABLE = GP_QUAD_DIMS * GP_QUAD_POINTS * (GP_QUAD_FEATS + 1);
__shared__ float gp_quad_table[GP_QUAD_TABLE];

// The quadrotor plus the baked cluster-0 GP of bench config c6
// (ad_mpc_tpu/experiments/quad_fleet.py:110-121, learned/lane.py:127-148):
// x_dot[7:10] += R(q) mu(R(q)^T v), mu the body-frame means of the 3
// velocity dims. The residual is a float function of the 7 entries
// (q, v); a dual gets it as its primal value and its Jacobian
// (gp_quad_jacobian) lifted to the tangents by one contraction, so no dual
// rotation is held in registers. The means depend on the primal alone,
// which every pass of a sweep would recompute: the first pass keeps each
// evaluation's means and gradients in the thread's slot of shared memory
// (a column of GP_QUAD_EVAL floats, ROW_WARPS * 32 apart), and the later
// passes read them there.
struct GPQuadDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int TANGENTS_PER_PASS = GP_QUAD_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = GP_QUAD_ROW_WARPS;
  static constexpr bool STAGES = true;
  static constexpr int CACHE_FLOATS = GP_QUAD_CACHE_EVALS * GP_QUAD_EVAL;
  using Ctx = GPQuadCache;
  GPQuadParamsC P;

  DI Ctx context(const float*) const { return Ctx{}; }

  DI void use_cache(Ctx& c, float* slot, int evals) const { c.use(slot, evals); }

  DI void stage() const {
    const float* src = &P.X[0][0][0];
    for (int i = threadIdx.x; i < GP_QUAD_TABLE; i += blockDim.x) gp_quad_table[i] = src[i];
  }

  DI void means(const float* z, float* mu, float (*g)[GP_QUAD_FEATS]) const {
#pragma unroll
    for (int d = 0; d < GP_QUAD_DIMS; ++d)
      mu[d] = gp_table_mean<GP_QUAD_FEATS>(
          gp_quad_table + d * GP_QUAD_POINTS * GP_QUAD_FEATS,
          gp_quad_table + GP_QUAD_DIMS * GP_QUAD_POINTS * GP_QUAD_FEATS +
              d * GP_QUAD_POINTS,
          P.n, P.inv_l[d], P.y_mean[d], z, g[d]);
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
    float vb[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) vb[r] = R[0][r] * v[0] + R[1][r] * v[1] + R[2][r] * v[2];
    float mu[GP_QUAD_DIMS], g[GP_QUAD_DIMS][GP_QUAD_FEATS];
    c.means_of<T, ROW_WARPS * WARP>(
        [&](float* m, float (*gm)[GP_QUAD_FEATS]) { means(vb, m, gm); }, mu, g);
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

VDE_ENTRIES(gp_quad, GPQuadDyn, GPQuadParamsC)

// No functor here has a table in dynamic shared memory: nothing to set.
int vde_prepare() { return 0; }

VDE_ERROR_STRING

}  // extern "C"
