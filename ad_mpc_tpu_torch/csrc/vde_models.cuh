// The pieces of the VDE functors that more than one source uses: the
// bicycle's and the quadrotor's x_dot, the GP mean of a table and its lift
// to duals, R(q), a GP quad team's means and its residual's Jacobian.
// Included by the vde_<family>.cu sources after vde.cuh.

#pragma once

#include "vde.cuh"

// ------------------------------------------------------------- dynamics
// A functor evaluates x_dot = f(x, u; p) for any scalar type T with the
// operations of vde.cuh. p is the scenario's parameter row (not
// differentiated).

struct BicycleParamsC {  // by value from the wrapper (models/bicycle.py)
  float mass, l_f, l_r, iz, cf, cr, wheelbase;
};

// The blended kinematic/dynamic bicycle (ad_mpc_tpu/models/bicycle.py:60-114)
// with blend switch s; same order of operations.
template <class T>
DI void bicycle_xdot(const BicycleParamsC& P, float s, const T* x, const T* u,
                     T* xd) {
  const T& psi = x[2];
  const T& v_x = x[3];
  const T& v_y = x[4];
  const T& psi_dot = x[5];
  const T& delta = x[6];
  const T& a = u[0];
  const T& delta_dot = u[1];

  const T v_x_safe = v_x + 1e-6f;
  const T f_fy = (2.0f * P.cf) * (delta - divide(v_y + P.l_f * psi_dot, v_x_safe));
  const T f_ry = divide((2.0f * P.cr) * (P.l_r * psi_dot - v_y), v_x_safe);

  T sps, cps;
  sin_cos(psi, sps, cps);
  xd[0] = v_x * cps - v_y * sps;
  xd[1] = v_x * sps + v_y * cps;
  xd[2] = psi_dot;

  T sd, cd;
  sin_cos(delta, sd, cd);
  const T v_x_dyn = a - divide(f_fy * sd, P.mass) + v_y * psi_dot;
  const T v_y_dyn = divide(f_ry + f_fy * cd, P.mass) - v_x * psi_dot;
  const T kin = delta_dot * v_x + delta * a;
  const T v_y_kin = divide(kin * P.l_r, P.wheelbase);
  const T psi_dd_dyn = divide(P.l_f * f_fy * cd - P.l_r * f_ry, P.iz);
  const T psi_dd_kin = divide(kin, P.wheelbase);

  xd[3] = s * v_x_dyn + (1.0f - s) * a;
  xd[4] = s * v_y_dyn + (1.0f - s) * v_y_kin;
  xd[5] = s * psi_dd_dyn + (1.0f - s) * psi_dd_kin;
  xd[6] = delta_dot;
}

struct QuadParamsC {  // by value from the wrapper (models/quadrotor.py)
  float max_thrust, mass, g, jxx, jyy, jzz, jyy_jzz, jzz_jxx, jxx_jyy;
  float x_f[4], y_f[4], z_l[4];
};

// The entrywise quadrotor (ad_mpc_tpu/models/quadrotor.py:112-167,
// quad_dynamics_lane) with the same order of operations.
template <class T>
DI void quad_xdot(const QuadParamsC& P, const T* x, const T* u, T* xd) {
  const T& qw = x[3];
  const T& qx = x[4];
  const T& qy = x[5];
  const T& qz = x[6];
  const T& wx = x[10];
  const T& wy = x[11];
  const T& wz = x[12];
  const T t0 = u[0] * P.max_thrust;
  const T t1 = u[1] * P.max_thrust;
  const T t2 = u[2] * P.max_thrust;
  const T t3 = u[3] * P.max_thrust;

  xd[0] = x[7];
  xd[1] = x[8];
  xd[2] = x[9];
  // Quaternion kinematics q_dot = 1/2 Omega(w) q, expanded.
  xd[3] = 0.5f * (-qx * wx - qy * wy - qz * wz);
  xd[4] = 0.5f * (qw * wx + qy * wz - qz * wy);
  xd[5] = 0.5f * (qw * wy - qx * wz + qz * wx);
  xd[6] = 0.5f * (qw * wz + qx * wy - qy * wx);
  // Third column of R(q) times the specific thrust, minus gravity.
  const T a = divide(t0 + t1 + t2 + t3, P.mass);
  xd[7] = 2.0f * (qx * qz + qw * qy) * a;
  xd[8] = 2.0f * (qy * qz - qw * qx) * a;
  xd[9] = (1.0f - 2.0f * qx * qx - 2.0f * qy * qy) * a - P.g;
  // Thrust moments and the Euler inertia coupling.
  const T m_x = t0 * P.y_f[0] + t1 * P.y_f[1] + t2 * P.y_f[2] + t3 * P.y_f[3];
  const T m_y = -(t0 * P.x_f[0] + t1 * P.x_f[1] + t2 * P.x_f[2] + t3 * P.x_f[3]);
  const T m_z = t0 * P.z_l[0] + t1 * P.z_l[1] + t2 * P.z_l[2] + t3 * P.z_l[3];
  xd[10] = divide(m_x + P.jyy_jzz * wy * wz, P.jxx);
  xd[11] = divide(m_y + P.jzz_jxx * wz * wx, P.jyy);
  xd[12] = divide(m_z + P.jxx_jyy * wx * wy, P.jzz);
}

// ------------------------------------------------------------- GP pieces

// The posterior mean of one output dim at the features z (F of them), in
// float, by the order of ad_mpc_tpu/learned/lane.py:lane_gp_mean (mu =
// y_mean + sum_j a_j exp(-0.5 sum_k ((z_k - X_jk) / l_k)^2)), and its
// gradient g_k = -sum_j a_j e_j (z_k - X_jk) / l_k^2. X (n rows of F) and a
// lie in shared memory (a staged table, or a routed GP's p row). A row with
// a_j = 0 (padding) adds exactly 0 to both. The j loop is unrolled 4 times
// (1, 2 and 8 were slower, PERF.md).
template <int F>
DI float gp_table_mean(const float* X, const float* a, int n,
                       const float* inv_l, float y_mean, const float* z,
                       float* g) {
  float mu = 0.0f, acc[F];
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float t[F];
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      t[k] = (z[k] - X[j * F + k]) * inv_l[k];
      d2 = d2 + t[k] * t[k];
    }
    const float e = a[j] * expf(-0.5f * d2);
    mu = mu + e;
#pragma unroll
    for (int k = 0; k < F; ++k) acc[k] = acc[k] + e * t[k];
  }
#pragma unroll
  for (int k = 0; k < F; ++k) g[k] = -acc[k] * inv_l[k];
  return mu + y_mean;
}

// A float mean as the scalar type: for a dual, value mu and tangents
// sum_k g_k dz_k, the derivative jax.linearize gives (one contraction, not
// the tangents carried through every point's product and exp).
template <int F>
DI float gp_lift(float mu, const float*, const float*) { return mu; }
template <int F, int NT>
DI Dual<NT> gp_lift(float mu, const float* g, const Dual<NT>* z) {
  Dual<NT> r;
  r.v = mu;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float s = g[0] * z[0].d[i];
#pragma unroll
    for (int k = 1; k < F; ++k) s = s + g[k] * z[k].d[i];
    r.d[i] = s;
  }
  return r;
}

// The GP quads' output dims and features: the three body velocities.
constexpr int GP_QUAD_DIMS = 3, GP_QUAD_FEATS = 3;

// R(q) of the quaternion q = (w, x, y, z), in float or as duals.
template <class T>
DI void rot_matrix(const T* q, T (*R)[3]) {
  const T &qw = q[0], &qx = q[1], &qy = q[2], &qz = q[3];
  R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  R[0][1] = 2.0f * (qx * qy - qw * qz);
  R[0][2] = 2.0f * (qx * qz + qw * qy);
  R[1][0] = 2.0f * (qx * qy + qw * qz);
  R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  R[1][2] = 2.0f * (qy * qz - qw * qx);
  R[2][0] = 2.0f * (qx * qz - qw * qy);
  R[2][1] = 2.0f * (qy * qz + qw * qx);
  R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
}

// The DIMS means and their gradients (FEATS features) of a GP team
// (vde.cuh: vde_team) at one evaluation: lane d < DIMS of each team of
// TEAM lanes computes output d's, mean(d, g), where `busy` (the whole sum
// in gp_table_mean's order: one sum is never split across lanes, since the
// fitted models' terms reach 3,657 and cancel to under 6), and every lane
// reads all DIMS from lanes 0 .. DIMS-1 by __shfl_sync. The GP quads take
// (3, 3), the GP bicycle (2, 4). Every lane of the warp reaches the
// shuffles, whatever its team's `busy` (a full-warp __shfl_sync inside a
// branch that another team of the warp skips is undefined).
template <int TEAM, int DIMS, int FEATS, class Mean>
DI void team_means(bool busy, const Mean& mean, float* mu, float (*g)[FEATS]) {
  static_assert(TEAM >= DIMS, "a lane of the team per output dim");
  const int d = threadIdx.x % TEAM;
  float m = 0.0f, gd[FEATS] = {};
  if (busy && d < DIMS) m = mean(d, gd);
#pragma unroll
  for (int e = 0; e < DIMS; ++e) {
    mu[e] = __shfl_sync(0xffffffffu, m, e, TEAM);
#pragma unroll
    for (int k = 0; k < FEATS; ++k) g[e][k] = __shfl_sync(0xffffffffu, gd[k], e, TEAM);
  }
}

// Entry d of a 3-array in registers, without indexing it (an indexed array
// would live in local memory).
template <class V>
DI V pick3(const V* v, int d) {
  return d == 0 ? v[0] : (d == 1 ? v[1] : v[2]);
}

// The residual r = R(q) mu(v_b), v_b = R(q)^T v, of the GP quad at the
// primal, and its Jacobian J (3 x 7) with respect to (q_w, q_x, q_y, q_z,
// v_x, v_y, v_z), in float, from R, the means mu and their gradients G
// (G[d][k] = d mu_d / d v_b,k): with H = R G, d r / d v = H R^T and
// d r / d q_i = (dR/dq_i) mu + H (dR/dq_i)^T v. With mu = D v_b and G = D
// it is the Jacobian of the RDRv drag R D R^T v (QuadDragDyn).
DI void gp_quad_jacobian(const float* q, const float* v, const float (*R)[3],
                         const float* mu, const float (*G)[GP_QUAD_FEATS],
                         float (*J)[7]) {
  float H[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      H[r][k] = R[r][0] * G[0][k] + R[r][1] * G[1][k] + R[r][2] * G[2][k];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      J[r][4 + c] = H[r][0] * R[c][0] + H[r][1] * R[c][1] + H[r][2] * R[c][2];
  const float w2 = 2.0f * q[0], x2 = 2.0f * q[1], y2 = 2.0f * q[2], z2 = 2.0f * q[3];
  const float dR[4][3][3] = {  // dR / dq_w, dq_x, dq_y, dq_z
      {{0.0f, -z2, y2}, {z2, 0.0f, -x2}, {-y2, x2, 0.0f}},
      {{0.0f, y2, z2}, {y2, -2.0f * x2, -w2}, {z2, w2, -2.0f * x2}},
      {{-2.0f * y2, x2, w2}, {x2, 0.0f, z2}, {-w2, z2, -2.0f * y2}},
      {{-2.0f * z2, -w2, x2}, {w2, -2.0f * z2, y2}, {x2, y2, 0.0f}}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float dvb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dvb[k] = dR[i][0][k] * v[0] + dR[i][1][k] * v[1] + dR[i][2][k] * v[2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      J[r][i] = dR[i][r][0] * mu[0] + dR[i][r][1] * mu[1] + dR[i][r][2] * mu[2] +
                (H[r][0] * dvb[0] + H[r][1] * dvb[1] + H[r][2] * dvb[2]);
  }
}

// ------------------------------------------------------------- GP quads' tables

// Capacity of the table of every cluster that GPQuadDualDyn and
// GPQuadSelectDyn stage into dynamic shared memory: clusters, and clusters
// x points of each output dim.
constexpr int GP_DUAL_CLUSTERS = 16, GP_DUAL_POINTS = 512;

// m floats padded to the least count that is 1 modulo the 32 banks of
// shared memory.
__host__ __device__ constexpr int bank_pad(int m) { return m + (33 - m % 32) % 32; }

// The table of GPQuadDualDyn, as the wrapper lays it out in device memory
// (models/gp_quad.py:gp_quad_table) and each block copies it to shared
// memory, padded to the 3 body velocities as outputs and features (an
// unused output has a = 0 and y_mean = 0, an unused feature 1/l = 0: exact
// zeros that leave the used dims' arithmetic as it is): X (3, C, n, 3), a =
// k_inv_y sigma_f (3, C, n), 1/l (3, C, 3), y_mean (3, C), each (output,
// cluster) block of X and of a padded to bank_pad floats. The lanes of a
// warp read one point of the clusters their rows took for output dims 0-2
// at once; blocks of 3n and n floats would lie in one bank for n = 32, and
// so would the 3 dims of one cluster. Padded, the 3C blocks start in 3C
// distinct banks (C <= 10). GPQuadSelectDyn's table appends the centroids
// (3, C, 3), each output dim's 3C floats padded by one.
struct GPDualTable {
  const float* base;
  int clusters, n, x_block, a_block;
  DI GPDualTable(const float* b, int c, int points)
      : base(b), clusters(c), n(points), x_block(bank_pad(3 * points)),
        a_block(bank_pad(points)) {}
  DI const float* X(int d, int c) const { return base + (d * clusters + c) * x_block; }
  DI const float* a(int d, int c) const {
    return base + 3 * clusters * x_block + (d * clusters + c) * a_block;
  }
  DI const float* inv_l(int d, int c) const {
    return base + 3 * clusters * (x_block + a_block) + (d * clusters + c) * 3;
  }
  DI float y_mean(int d, int c) const {
    return base[3 * clusters * (x_block + a_block + 3) + d * clusters + c];
  }
  DI const float* centroids(int d) const {
    return base + 3 * clusters * (x_block + a_block + 4) + d * (3 * clusters + 1);
  }
};
__host__ __device__ constexpr int gp_dual_table_floats(int clusters, int n) {
  return 3 * clusters * (bank_pad(3 * n) + bank_pad(n) + 4);
}
// Floats of the largest such table: at most 31 floats of padding per block.
constexpr int GP_DUAL_TABLE_MAX = 3 * (4 * GP_DUAL_POINTS + 66 * GP_DUAL_CLUSTERS);

// The RDRv drag beside a GP quad's residual (QuadMPC with rdrv_d and a GP
// mode), by value in the functor's struct: on, and the 3x3 matrix D.
struct QuadDragOptC {
  int on;
  float D[3][3];
};

// A GP quad's velocity rows: x_dot[7:10] plus, where the drag is on, the
// RDRv drag t = R D v_b (w = D v_b, t = R w: the order of
// models/quadrotor.py:quad_drag_rows), then the residual res = R mu, the
// order of ad_mpc_tpu/control/mpc.py (quad_dynamics(rdrv_d=D), then the
// residual). Both are float functions of (q, v) with values at the primal;
// a dual takes their values and the Jacobian of their sum, the Jacobian
// being linear in (mu, G): one gp_quad_jacobian of (mu + D v_b, G + D),
// lifted by one contraction. vb = R^T v at the primal.
template <class T>
DI void gp_quad_rows(const T* x, const float* q, const float* v, float (*R)[3],
                     const float* vb, const float* mu, float (*g)[GP_QUAD_FEATS],
                     const QuadDragOptC& drag, T* xd) {
  float res[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) res[r] = R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2];
  float m[3], G[3][GP_QUAD_FEATS];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    m[d] = mu[d];
#pragma unroll
    for (int k = 0; k < GP_QUAD_FEATS; ++k) G[d][k] = g[d][k];
  }
  if (drag.on) {
    float w[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      w[r] = drag.D[r][0] * vb[0] + drag.D[r][1] * vb[1] + drag.D[r][2] * vb[2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      xd[7 + r] = xd[7 + r] + (R[r][0] * w[0] + R[r][1] * w[1] + R[r][2] * w[2]);
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        m[d] = m[d] + w[d];
#pragma unroll
        for (int k = 0; k < GP_QUAD_FEATS; ++k) G[d][k] = G[d][k] + drag.D[d][k];
      }
    }
  }
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + res[r];
  } else {
    float J[3][7];
    gp_quad_jacobian(q, v, R, m, G, J);
#pragma unroll
    for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + gp_lift<7>(res[r], J[r], x + 3);
  }
}
