// The GP quadrotor of config c6 in the VDE sweep and its RK4 map
// (vde.cuh): the quad plus the baked body-frame GP (GPQuadDyn).

#ifndef GP_QUAD_ROW_TEAM
#define GP_QUAD_ROW_TEAM 4
#endif
#ifndef GP_QUAD_ROW_WARPS
#define GP_QUAD_ROW_WARPS 4
#endif
#ifndef GP_QUAD_MIN_BLOCKS
#define GP_QUAD_MIN_BLOCKS 2
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
                      sizeof(float) * GP_QUAD_DIMS * GP_QUAD_POINTS * GP_QUAD_FEATS &&
              offsetof(GPQuadParamsC, inv_l) ==
                  offsetof(GPQuadParamsC, a) + sizeof(float) * GP_QUAD_DIMS * GP_QUAD_POINTS &&
              offsetof(GPQuadParamsC, y_mean) ==
                  offsetof(GPQuadParamsC, inv_l) + sizeof(float) * GP_QUAD_DIMS * GP_QUAD_FEATS,
              "stage() copies X, a, inv_l and y_mean as one range");

// GPQuadDyn's table (X, a, 1/l, y_mean), as gp_table is GPBicycleDyn's,
// each output dim's X and a one float past the last dim's: the team's
// lanes 0-2 read the same point of the 3 dims at once, and without the
// pad the 3 addresses (192 and 64 floats apart) would lie in one bank.
constexpr int GP_QUAD_X_DIM = GP_QUAD_POINTS * GP_QUAD_FEATS + 1;
constexpr int GP_QUAD_A_DIM = GP_QUAD_POINTS + 1;
constexpr int GP_QUAD_X = 0;
constexpr int GP_QUAD_A = GP_QUAD_X + GP_QUAD_DIMS * GP_QUAD_X_DIM;
constexpr int GP_QUAD_INV_L = GP_QUAD_A + GP_QUAD_DIMS * GP_QUAD_A_DIM;
constexpr int GP_QUAD_Y_MEAN = GP_QUAD_INV_L + GP_QUAD_DIMS * GP_QUAD_FEATS;
constexpr int GP_QUAD_TABLE = GP_QUAD_Y_MEAN + GP_QUAD_DIMS;
// Floats of the struct's range X .. y_mean that stage() copies.
constexpr int GP_QUAD_PARAMS = GP_QUAD_DIMS * (GP_QUAD_POINTS * (GP_QUAD_FEATS + 1) +
                                               GP_QUAD_FEATS + 1);
__shared__ float gp_quad_table[GP_QUAD_TABLE];

// The quadrotor plus the baked cluster-0 GP of bench config c6
// (ad_mpc_tpu/experiments/quad_fleet.py:110-121, learned/lane.py:127-148):
// x_dot[7:10] += R(q) mu(R(q)^T v), mu the body-frame means of the 3
// velocity dims. The residual is a float function of the 7 entries
// (q, v); a dual gets it as its primal value and its Jacobian
// (gp_quad_jacobian) lifted to the tangents by one contraction, so no dual
// rotation is held in registers. The sweep runs a team of ROW_TEAM lanes
// per row (vde.cuh: vde_team), every lane on the same primal: at each
// evaluation lanes 0-2 of the team each sum one output dim's mean and
// gradient over the training points in gp_table_mean's order, and the
// team reads the 3 means and their 3 x 3 gradients from them
// (team_means). The RK4 map (T = float) computes the 3 sums itself.
struct GPQuadDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int ROW_TEAM = GP_QUAD_ROW_TEAM;
  static constexpr int ROW_WARPS = GP_QUAD_ROW_WARPS;
  static constexpr int MIN_BLOCKS = GP_QUAD_MIN_BLOCKS;
  static constexpr bool STAGES = true;
  using Ctx = const float*;
  GPQuadParamsC P;

  DI Ctx context(const float* p) const { return p; }

  DI void stage() const {
    constexpr int NXF = GP_QUAD_DIMS * GP_QUAD_POINTS * GP_QUAD_FEATS;
    constexpr int NA = GP_QUAD_DIMS * GP_QUAD_POINTS;
    const float* src = &P.X[0][0][0];
    for (int i = threadIdx.x; i < GP_QUAD_PARAMS; i += blockDim.x) {
      const int j = i - NXF;
      const int dst =
          i < NXF  ? GP_QUAD_X + (i / (GP_QUAD_X_DIM - 1)) * GP_QUAD_X_DIM + i % (GP_QUAD_X_DIM - 1)
          : j < NA ? GP_QUAD_A + (j / GP_QUAD_POINTS) * GP_QUAD_A_DIM + j % GP_QUAD_POINTS
                   : GP_QUAD_INV_L + (j - NA);
      gp_quad_table[dst] = src[i];
    }
  }

  // Output dim d's mean and gradient at the body velocity z.
  DI float mean(int d, const float* z, float* g) const {
    return gp_table_mean<GP_QUAD_FEATS>(
        gp_quad_table + GP_QUAD_X + d * GP_QUAD_X_DIM,
        gp_quad_table + GP_QUAD_A + d * GP_QUAD_A_DIM, P.n,
        gp_quad_table + GP_QUAD_INV_L + d * GP_QUAD_FEATS,
        gp_quad_table[GP_QUAD_Y_MEAN + d], z, g);
  }

  template <class T>
  DI void means(const float* z, float* mu, float (*g)[GP_QUAD_FEATS]) const {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int d = 0; d < GP_QUAD_DIMS; ++d)
        mu[d] = gp_table_mean<GP_QUAD_FEATS>(
            gp_quad_table + GP_QUAD_X + d * GP_QUAD_X_DIM,
            gp_quad_table + GP_QUAD_A + d * GP_QUAD_A_DIM, P.n, P.inv_l[d],
            P.y_mean[d], z, g[d]);
    } else {
      team_means<ROW_TEAM, GP_QUAD_DIMS, GP_QUAD_FEATS>(
          true, [&](int d, float* gd) { return mean(d, z, gd); }, mu, g);
    }
  }

  // The team's duals sum the means before the quad's rows, while the
  // evaluation's outputs hold no registers yet; the RK4 map (T = float)
  // keeps the order of its first design, and its bits.
  template <class T>
  DI void operator()(const T* x, const T* u, const Ctx&, T* xd) const {
    constexpr bool scalar = std::is_same<T, float>::value;
    if constexpr (scalar) quad_xdot(P.quad, x, u, xd);
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
    means<T>(vb, mu, g);
    if constexpr (!scalar) quad_xdot(P.quad, x, u, xd);
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
};

extern "C" {

VDE_TEAM_ENTRIES(gp_quad, GPQuadDyn, GPQuadParamsC)

// The team sweep's block tile.
int vde_prepare() { return (int)prepare_team<GPQuadDyn>(); }

VDE_ERROR_STRING

}  // extern "C"
