// The quadrotor plus a parameter-routed body-frame GP in the VDE sweep and
// its RK4 map (vde.cuh): GPQuadRoutedDyn, whose every scenario reads its
// own cluster's GP from its parameter row, so that one launch serves a
// fleet whose scenarios use different clusters.

#ifndef GP_QUAD_ROUTED_ROW_TEAM
#define GP_QUAD_ROUTED_ROW_TEAM 4
#endif
#ifndef GP_QUAD_ROUTED_ROW_WARPS
#define GP_QUAD_ROUTED_ROW_WARPS 4
#endif
#ifndef GP_QUAD_ROUTED_MIN_BLOCKS
#define GP_QUAD_ROUTED_MIN_BLOCKS 2
#endif

#include "vde_models.cuh"

// Capacity of GPQuadRoutedDyn: training points per output dim (the
// synthetic 32-point ensemble takes p_dim 399, a fitted 60-point one 735).
constexpr int GP_QUAD_ROUTED_POINTS = 64;

struct GPQuadRoutedParamsC {  // by value from the wrapper (models/gp_routed.py)
  QuadParamsC quad;
  int n;        // training points per output dim, <= GP_QUAD_ROUTED_POINTS
  int base_pd;  // the quad's entries of p, before the GP's (it reads none)
};

// Floats of one output dim's GP in p (ad_mpc_tpu/learned/lane.py:151-157):
// X (n x 3, row-major), a = k_inv_y sigma_f (n), 1 / l (3), sigma_f, y_mean.
__host__ __device__ constexpr int gp_quad_routed_floats(int n) {
  return n * GP_QUAD_FEATS + n + GP_QUAD_FEATS + 2;
}

// A launch of GPQuadRoutedDyn takes a p of base_pd + 3 GPs of n points.
static bool params_ok(const GPQuadRoutedParamsC& P, int pd) {
  return P.n >= 1 && P.n <= GP_QUAD_ROUTED_POINTS && P.base_pd >= 0 &&
         pd == P.base_pd + GP_QUAD_DIMS * gp_quad_routed_floats(P.n);
}

// The quadrotor plus the parameter-routed body-frame GP of
// ad_mpc_tpu/learned/lane.py:222-240 (param_residual_dynamics with
// quad_frame=True): x_dot[7:10] += R(q) mu(R(q)^T v), where output dim d's
// GP lies in the scenario's own p row behind the base_pd entries, so that
// the scenarios of one launch may each carry another cluster. The sweep
// runs a team of ROW_TEAM lanes per row (vde.cuh: vde_team), as GPQuadDyn's:
// the block's scenarios' p rows staged after its tile (P_ROWS, where a
// scenario owns several rows), lanes 0-2 of each team summing one output
// dim's mean and gradient over the scenario's points in gp_table_mean's
// order (team_means), the residual lifted by its float Jacobian. Lanes 0-2
// read dims gp_quad_routed_floats(n) floats apart (245 at n = 60, 133 at
// n = 32: 21 and 5 banks apart), and the scenarios a warp's rows span lie
// p_dim floats apart (735, 399: 31 and 15 banks apart), so their reads of
// one point fall in distinct banks unpadded
// (tests/test_torch_vde_team.py). The RK4 map (T = float) computes the 3
// sums itself, after the quad's rows, in the order of its first design.
struct GPQuadRoutedDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int ROW_TEAM = GP_QUAD_ROUTED_ROW_TEAM;
  static constexpr int ROW_WARPS = GP_QUAD_ROUTED_ROW_WARPS;
  static constexpr int MIN_BLOCKS = GP_QUAD_ROUTED_MIN_BLOCKS;
  static constexpr bool STAGES = false, P_ROWS = true;
  using Ctx = const float*;  // the scenario's GPs, staged or in global memory
  GPQuadRoutedParamsC P;

  DI Ctx context(const float* p) const { return p + P.base_pd; }
  __host__ __device__ int p_dim() const {
    return P.base_pd + GP_QUAD_DIMS * gp_quad_routed_floats(P.n);
  }

  // Output dim d's mean and gradient at the body velocity z.
  DI float mean(const Ctx& c, int d, const float* z, float* g) const {
    const float* gp = c + d * gp_quad_routed_floats(P.n);
    const float* inv_l = gp + P.n * (GP_QUAD_FEATS + 1);
    return gp_table_mean<GP_QUAD_FEATS>(gp, gp + P.n * GP_QUAD_FEATS, P.n, inv_l,
                                        inv_l[GP_QUAD_FEATS + 1], z, g);
  }

  template <class T>
  DI void means(const Ctx& c, const float* z, float* mu, float (*g)[GP_QUAD_FEATS]) const {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int d = 0; d < GP_QUAD_DIMS; ++d) mu[d] = mean(c, d, z, g[d]);
    } else {
      team_means<ROW_TEAM, GP_QUAD_DIMS, GP_QUAD_FEATS>(
          true, [&](int d, float* gd) { return mean(c, d, z, gd); }, mu, g);
    }
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const Ctx& c, T* xd) const {
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
    means<T>(c, vb, mu, g);
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

VDE_TEAM_ENTRIES(gp_quad_routed, GPQuadRoutedDyn, GPQuadRoutedParamsC)

// At the library's first load: GPQuadRoutedDyn's kernels may take the most
// dynamic shared memory the device allows (the sweep's block tile and its
// scenarios' p rows; the RK4 map's p rows).
int vde_prepare() { return (int)prepare_rows<GPQuadRoutedDyn>(); }

VDE_ERROR_STRING

}  // extern "C"
