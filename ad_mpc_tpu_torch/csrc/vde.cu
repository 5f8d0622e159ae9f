// Fused RK4 + forward-sensitivity (VDE) sweep for Hopper (sm_90a), and the
// same RK4 map without tangents.
//
// Replaces: ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel (built by make_vde).
// For every (scenario b, stage k) vde_kernel integrates one RK4 interval
// F(x_k, u_k; p_b), its exact forward sensitivities A_k = dF/dx and
// B_k = dF/du, and the multiple-shooting defect c_k = F(x_k, u_k) - x_{k+1}.
// rk4_kernel runs the same functor and RK4 map with T = float: the solver's
// KKT defect (ad_mpc_tpu/ocp/solver.py:464) and the fleet's plant step
// (bench.py:159), which XLA fuses into the jitted tick.
//
// What bounds it on the H100: at c2 (B=16384, N=30, nx=7, nu=2) the sweep
// moves ~156 MB (A, Bm, c out: 137.6 MB; ~47 us at 3.35 TB/s) and does
// ~1.9 GFLOP of forward-mode arithmetic (counted from the plain version,
// experiments/opcount.py; ~28 us at 67 TFLOP/s FP32): the bytes. So do
// the Pacejka bicycle (c4, ~1.8 GFLOP) and the quad at c5 (165 MB against
// ~2.0 GFLOP). The GP bicycle (c3) adds 2 means of 32 points per
// evaluation: ~5.0 GFLOP (~74 us), the operations; the GP quad (c6) 3
// means of 32 points and the residual's rotations: ~4.4 GFLOP (~66 us;
// the fitted model's 60 points ~5.3 GFLOP), the operations. Measured on an
// H100 (PERF.md), the first design lost most of its time elsewhere: its
// stores were strided (a thread's 70 outputs lie 280 B from its
// neighbour's, so each warp store touched 32 partly written sectors; 83%
// of the time once the compute was lean), and each of its 336 IEEE
// divisions per thread called a slow-path subroutine behind a branch.
//
// Design:
//   - One thread per (b, k), thread index b*N + k, reading and writing the
//     solver's batch-first layout (no transposes or padding around the
//     launch). The 32 rows of a warp own contiguous ranges of A, Bm and c:
//     each thread writes its outputs into the warp's tile in dynamic shared
//     memory (bicycle row strides 49, 14 and 7 words, quad 169, 52 and 13:
//     the odd ones are free of bank conflicts), and after __syncwarp the
//     warp copies the tile out with 16-byte stores. A ragged last warp
//     computes a clamped duplicate of the last row and copies only its own
//     rows. ROW_WARPS, the warps of a block, is a functor trait: the quad's
//     tile is 29,952 B per warp, so a block of 4 warps would hold one block
//     per SM; one warp per block holds 7.
//   - Forward-mode duals: Dual<NT> carries a value and NT tangents, x_j and
//     u_j are seeded with one-hot tangents. TANGENTS_PER_PASS, a functor
//     trait, splits the nx+nu tangents into passes (vde_passes), each of
//     which recomputes the primal. The bicycle runs all 9 in one pass: 255
//     registers and no spill once the divisions are branch-free, 8 warps
//     per SM; 3 passes of 3 and 2 of 5 + 4 took 8% and 4% longer, and a
//     warp per pass 60-80% (PERF.md). The quad's 17 tangents cannot share
//     one pass without spilling; its width was measured (PERF.md,
//     experiments/quad_kernels.py). The GP quad runs 3 per pass (no spill),
//     each pass after the first reading the GP means from the functor's
//     cache (0.65 ms against 1.08 recomputing them), in blocks of 2 warps
//     (6 resident per SM by shared memory, against 5 with one: 0.59 ms;
//     PERF.md).
//   - A dual division computes its value once with the bits of IEEE '/'
//     (fdiv_rcp of ieee_div.cuh, branch-free) and multiplies the tangents by
//     the reciprocal it refined; one sincosf per angle; a dual atan takes
//     its derivative from the same refined reciprocal. No --use_fast_math:
//     the 2e-5 parity assumes IEEE-accurate sinf/cosf/atanf/expf.
//   - The GP bicycle's mean and its gradient are float functions of the 4
//     features; a dual gets them by one contraction of the gradient with
//     the features' tangents, not by carrying the tangents through every
//     training point's product and exp. The GP quad's residual
//     R(q) mu(R(q)^T v) is lifted the same way, by its float Jacobian in
//     (q, v). The means depend on the primal alone, which every pass
//     recomputes: a functor with CACHE_FLOATS keeps what its first pass
//     computed in a per-thread slot of shared memory after the tiles, and
//     its later passes read it there (the GP quad's 3 means and 9 gradient
//     entries per evaluation).
// The dynamics is a __device__ functor templated on the scalar type, with
// one pair of C entries per functor (vde_<model>, rk4_<model>): the blended
// bicycle, the quadrotor, the Pacejka bicycle, the GP-augmented bicycle, the
// GP-augmented quadrotor, the quadrotor with the RDRv drag and the
// dual-state GP quadrotor of QuadMPC (its GP table in a device buffer whose
// pointer rides in the struct, staged into dynamic shared memory once per
// block: more than one cluster does not fit the 4 KB of kernel parameters).
// A functor states NX, NU, NP (parameter entries it reads; a launch with
// fewer is refused, and NP = 0 never reads ps), TANGENTS_PER_PASS and
// ROW_WARPS, and a per-thread context Ctx built once from the scenario's
// parameter row (context(p)), before any pass: what depends on p alone is
// computed there in float, not as duals. The functor rides in the kernel's
// parameter space (__grid_constant__, never copied to local memory). A
// functor with STAGES copies a table from there into shared memory once
// per block before any row (the GP models' training points, which every
// lane of a warp then reads at the same address).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE sinf/cosf/atanf/expf and
//        division). -D<MODEL>_TANGENTS_PER_PASS=n and -D<MODEL>_ROW_WARPS=n
//        (MODEL: QUAD, PACEJKA, GP_BICYCLE, GP_QUAD, QUAD_DRAG, GP_QUAD_DUAL)
//        override a functor's traits (the measurements of
//        experiments/quad_kernels.py and experiments/bicycle_kernels.py).

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "ieee_div.cuh"

#define DI __device__ __forceinline__

#ifndef QUAD_TANGENTS_PER_PASS
#define QUAD_TANGENTS_PER_PASS 6
#endif
#ifndef QUAD_ROW_WARPS
#define QUAD_ROW_WARPS 1
#endif
#ifndef PACEJKA_TANGENTS_PER_PASS
#define PACEJKA_TANGENTS_PER_PASS 9
#endif
#ifndef PACEJKA_ROW_WARPS
#define PACEJKA_ROW_WARPS 4
#endif
#ifndef GP_BICYCLE_TANGENTS_PER_PASS
#define GP_BICYCLE_TANGENTS_PER_PASS 9
#endif
#ifndef GP_BICYCLE_ROW_WARPS
#define GP_BICYCLE_ROW_WARPS 4
#endif
#ifndef GP_QUAD_TANGENTS_PER_PASS
#define GP_QUAD_TANGENTS_PER_PASS 3
#endif
#ifndef GP_QUAD_ROW_WARPS
#define GP_QUAD_ROW_WARPS 2
#endif
#ifndef QUAD_DRAG_TANGENTS_PER_PASS
#define QUAD_DRAG_TANGENTS_PER_PASS 3
#endif
#ifndef QUAD_DRAG_ROW_WARPS
#define QUAD_DRAG_ROW_WARPS 1
#endif
#ifndef GP_QUAD_DUAL_TANGENTS_PER_PASS
#define GP_QUAD_DUAL_TANGENTS_PER_PASS 3
#endif
#ifndef GP_QUAD_DUAL_ROW_WARPS
#define GP_QUAD_DUAL_ROW_WARPS 2
#endif

constexpr int WARP = 32;
constexpr int RK4_ROW_WARPS = 4;  // warps of rows per block of rk4_kernel

template <int NT>
struct Dual {
  float v;
  float d[NT];
};

template <int NT>
DI Dual<NT> operator+(const Dual<NT>& a, const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int NT>
DI Dual<NT> operator+(const Dual<NT>& a, float b) {
  Dual<NT> r = a;
  r.v = a.v + b;
  return r;
}
template <int NT>
DI Dual<NT> operator+(float a, const Dual<NT>& b) { return b + a; }

template <int NT>
DI Dual<NT> operator-(const Dual<NT>& a) {
  Dual<NT> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int NT>
DI Dual<NT> operator-(const Dual<NT>& a, const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int NT>
DI Dual<NT> operator-(const Dual<NT>& a, float b) {
  Dual<NT> r = a;
  r.v = a.v - b;
  return r;
}
template <int NT>
DI Dual<NT> operator-(float a, const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = -b.d[i];
  return r;
}

template <int NT>
DI Dual<NT> operator*(const Dual<NT>& a, const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int NT>
DI Dual<NT> operator*(const Dual<NT>& a, float b) {
  Dual<NT> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int NT>
DI Dual<NT> operator*(float a, const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a * b.d[i];
  return r;
}

// Division and sin/cos for both scalar types. A functor writes divide(a, b)
// and sin_cos(a, s, c) so that T = float takes them too.
DI float divide(float a, float b) { return fdiv(a, b); }
template <int NT>
DI Dual<NT> divide(const Dual<NT>& a, const Dual<NT>& b) {
  Dual<NT> r;
  float rb;
  r.v = fdiv_rcp(a.v, b.v, rb);
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * rb;
  return r;
}
template <int NT>
DI Dual<NT> divide(const Dual<NT>& a, float b) {
  Dual<NT> r;
  float rb;
  r.v = fdiv_rcp(a.v, b, rb);
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * rb;
  return r;
}

DI void sin_cos(float a, float& s, float& c) { sincosf(a, &s, &c); }
template <int NT>
DI void sin_cos(const Dual<NT>& a, Dual<NT>& s, Dual<NT>& c) {
  sincosf(a.v, &s.v, &c.v);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    s.d[i] = c.v * a.d[i];
    c.d[i] = -s.v * a.d[i];
  }
}

// atan: atanf for the value, tangent d / (1 + v^2) by the refined
// reciprocal of fdiv_rcp.
DI float atan_(float a) { return atanf(a); }
template <int NT>
DI Dual<NT> atan_(const Dual<NT>& a) {
  Dual<NT> r;
  float rb;
  r.v = atanf(a.v);
  fdiv_rcp(1.0f, 1.0f + a.v * a.v, rb);
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * rb;
  return r;
}

// max(a, b) against a constant floor b; the tangent is the branch's: a's
// when a > b, else 0. At a tie jnp.maximum (and torch.maximum) give half
// of each operand's tangent; a float draw lands on the floor with
// probability zero.
DI float max_(float a, float b) { return a > b ? a : b; }
template <int NT>
DI Dual<NT> max_(const Dual<NT>& a, float b) {
  const bool take = a.v > b;
  Dual<NT> r;
  r.v = take ? a.v : b;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = take ? a.d[i] : 0.0f;
  return r;
}

DI float value(float a) { return a; }
template <int NT>
DI float value(const Dual<NT>& a) { return a.v; }

// ------------------------------------------------------------- dynamics
// A functor evaluates x_dot = f(x, u; p) for any scalar type T with the
// operations above. p is the scenario's parameter row (not differentiated).

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

// The bicycle with the blend switch taken from p[0].
struct BicycleDyn {
  static constexpr int NX = 7, NU = 2, NP = 1;
  static constexpr int TANGENTS_PER_PASS = 9, ROW_WARPS = 4;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = 0;
  using Ctx = const float*;
  BicycleParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float* p, T* xd) const {
    bicycle_xdot(P, p[0], x, u, xd);
  }
};

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

// The quadrotor; p is not read.
struct QuadDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int TANGENTS_PER_PASS = QUAD_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = QUAD_ROW_WARPS;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = 0;
  using Ctx = const float*;
  QuadParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float*, T* xd) const {
    quad_xdot(P, x, u, xd);
  }
};

struct PacejkaParamsC {  // by value from the wrapper (models/pacejka.py)
  float mass, l_f, l_r, iz, b_f, c_f, d_f, b_r, c_r, d_r, g, wheelbase;
};

// The Pacejka magic-formula bicycle with road topography
// (ad_mpc_tpu/models/pacejka.py:38-116, pacejka_dynamics_p with the 5-entry
// p = [mu, pitch, roll, B scale, D scale]), same order of operations, atanf
// where the reference has atan_mosaic. What depends on p alone (the normal
// loads, the magic formula's B and mu F_z D, the gravity feed-through) is
// computed once per thread in float.
struct PacejkaDyn {
  static constexpr int NX = 7, NU = 2, NP = 5;
  static constexpr int TANGENTS_PER_PASS = PACEJKA_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = PACEJKA_ROW_WARPS;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = 0;
  struct Ctx {
    float b_f, b_r;      // B front and rear
    float k_f, k_r;      // (mu F_z) D front and rear
    float a_grav_x, a_grav_y;
  };
  PacejkaParamsC P;

  DI Ctx context(const float* p) const {
    const float mu = p[0];
    float s_pitch, c_pitch, s_roll, c_roll;
    sincosf(p[1], &s_pitch, &c_pitch);
    sincosf(p[2], &s_roll, &c_roll);
    const float g_eff = P.g * c_pitch * c_roll;
    const float fz_f = divide(P.mass * g_eff * P.l_r, P.wheelbase);
    const float fz_r = divide(P.mass * g_eff * P.l_f, P.wheelbase);
    Ctx c;
    c.b_f = P.b_f * p[3];
    c.b_r = P.b_r * p[3];
    c.k_f = mu * fz_f * (P.d_f * p[4]);
    c.k_r = mu * fz_r * (P.d_r * p[4]);
    c.a_grav_x = -P.g * s_pitch;
    c.a_grav_y = P.g * s_roll;
    return c;
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const Ctx& c, T* xd) const {
    const T& psi = x[2];
    const T& v_x = x[3];
    const T& v_y = x[4];
    const T& psi_dot = x[5];
    const T& delta = x[6];
    const T& a_cmd = u[0];
    const T& delta_dot = u[1];

    const T v_x_safe = max_(v_x, 0.5f);
    const T alpha_f = delta - atan_(divide(v_y + P.l_f * psi_dot, v_x_safe));
    const T alpha_r = -atan_(divide(v_y - P.l_r * psi_dot, v_x_safe));
    T mf, mr, unused;
    sin_cos(P.c_f * atan_(c.b_f * alpha_f), mf, unused);
    sin_cos(P.c_r * atan_(c.b_r * alpha_r), mr, unused);
    const T f_fy = c.k_f * mf;
    const T f_ry = c.k_r * mr;

    T sps, cps;
    sin_cos(psi, sps, cps);
    xd[0] = v_x * cps - v_y * sps;
    xd[1] = v_x * sps + v_y * cps;
    xd[2] = psi_dot;

    T sd, cd;
    sin_cos(delta, sd, cd);
    xd[3] = a_cmd + c.a_grav_x - divide(f_fy * sd, P.mass) + v_y * psi_dot;
    xd[4] = divide(f_ry + f_fy * cd, P.mass) + c.a_grav_y - v_x * psi_dot;
    xd[5] = divide(P.l_f * f_fy * cd - P.l_r * f_ry, P.iz);
    xd[6] = delta_dot;
  }
};

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
// kernel 10x its time (PERF.md section 6). The loop is unrolled 4 times
// (1, 2 and 8 were slower, PERF.md).
constexpr int GP_TABLE = GP_DIMS * GP_POINTS * (GP_FEATS + 1);
__shared__ float gp_table[GP_TABLE];

// The posterior mean of one output dim at the features z (F of them), in
// float, by the order of ad_mpc_tpu/learned/lane.py:lane_gp_mean (mu =
// y_mean + sum_j a_j exp(-0.5 sum_k ((z_k - X_jk) / l_k)^2)), and its
// gradient g_k = -sum_j a_j e_j (z_k - X_jk) / l_k^2. X (n rows of F) and a
// lie in a table in shared memory. A row with a_j = 0 (padding) adds
// exactly 0 to both.
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

// c3's mean of output dim d from gp_table.
DI float gp_mean(const GPBicycleParamsC& P, int d, const float* z, float* g) {
  return gp_table_mean<GP_FEATS>(
      gp_table + d * GP_POINTS * GP_FEATS,
      gp_table + GP_DIMS * GP_POINTS * GP_FEATS + d * GP_POINTS, P.n,
      P.inv_l[d], P.y_mean[d], z, g);
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

// The dynamic bicycle (switch p[0]) plus the baked cluster-0 GP mean of the
// c3 bench config (bench.py:216-257): features x[3..6], outputs added to
// rows 4 and 5.
struct GPBicycleDyn {
  static constexpr int NX = 7, NU = 2, NP = 1;
  static constexpr int TANGENTS_PER_PASS = GP_BICYCLE_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = GP_BICYCLE_ROW_WARPS;
  static constexpr bool STAGES = true;
  static constexpr int CACHE_FLOATS = 0;
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

// Capacity of the GP-quad's training table (models/gp_quad.py): the bench's
// synthetic 32 points and the fitted gp_flagship_c1 model's 60.
constexpr int GP_QUAD_POINTS = 64, GP_QUAD_DIMS = 3, GP_QUAD_FEATS = 3;

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

// What one evaluation's GP gives the lift: 3 means and their gradients.
constexpr int GP_QUAD_EVAL = GP_QUAD_DIMS * (1 + GP_QUAD_FEATS);
// Evaluations a sweep's cache holds: one RK4 step.
constexpr int GP_QUAD_CACHE_EVALS = 4;

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

// The means cache of a GP quad's sweep (GPQuadDyn, GPQuadDualDyn): the
// thread's slot of shared memory, a column of GP_QUAD_EVAL floats per
// evaluation (STRIDE apart), which the first pass fills and the later
// passes read, since the means depend on the primal alone.
struct GPQuadCache {
  float* cache = nullptr;  // the thread's slot, or none
  int evals = 0;           // evaluations per pass
  mutable int calls = 0;   // evaluations so far

  // The slot, when a pass's evaluations fit it.
  DI void use(float* slot, int n) {
    if (n <= GP_QUAD_CACHE_EVALS) {
      cache = slot;
      evals = n;
    }
  }

  // The means and gradients that means(mu, g) computes: computed, or, in a
  // sweep's later passes, read from the slot.
  template <class T, int STRIDE, class Means>
  DI void means_of(const Means& means, float* mu, float (*g)[GP_QUAD_FEATS]) const {
    if (std::is_same<T, float>::value || cache == nullptr) {
      means(mu, g);
      return;
    }
    const int e = calls++;
    float* slot = cache + (e % evals) * GP_QUAD_EVAL * STRIDE;
    if (e < evals) {
      means(mu, g);
#pragma unroll
      for (int d = 0; d < GP_QUAD_DIMS; ++d) {
        slot[d * STRIDE] = mu[d];
#pragma unroll
        for (int k = 0; k < GP_QUAD_FEATS; ++k)
          slot[(GP_QUAD_DIMS + d * GP_QUAD_FEATS + k) * STRIDE] = g[d][k];
      }
    } else {
#pragma unroll
      for (int d = 0; d < GP_QUAD_DIMS; ++d) {
        mu[d] = slot[d * STRIDE];
#pragma unroll
        for (int k = 0; k < GP_QUAD_FEATS; ++k)
          g[d][k] = slot[(GP_QUAD_DIMS + d * GP_QUAD_FEATS + k) * STRIDE];
      }
    }
  }
};

// The residual r = R(q) mu(v_b), v_b = R(q)^T v, of the GP quad at the
// primal, and its Jacobian J (3 x 7) with respect to (q_w, q_x, q_y, q_z,
// v_x, v_y, v_z), in float, from R, the means mu and their gradients G
// (G[d][k] = d mu_d / d v_b,k): with H = R G, d r / d v = H R^T and
// d r / d q_i = (dR/dq_i) mu + H (dR/dq_i)^T v.
DI void gp_quad_jacobian(const float* q, const float* v, float (*R)[3],
                         const float* mu, float (*G)[GP_QUAD_FEATS],
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

// The RDRv linear drag of ad_mpc_tpu/models/quadrotor.py:90-92 on the
// velocity rows, t = R(q) D R(q)^T v, with D a 3x3 matrix, entrywise in the
// order of models/quadrotor.py:quad_drag_rows: v_b = R^T v, w = D v_b,
// t = R w, every product carried as duals of (q, v). On an H100 at
// B=16384, N=10 (PERF.md section 6) these duals at 3 tangents per pass
// spill nothing; a float-Jacobian lift (as gp_quad_jacobian lifts the GP
// quad's residual) tied with them at 3 per pass (0.4216 against 0.4241 ms)
// and spilled 2,520 B at 6, where the duals spilled 3,244 B.
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
// (ad_mpc_tpu/control/mpc.py:286-290); p is not read.
struct QuadDragDyn {
  static constexpr int NX = 13, NU = 4, NP = 0;
  static constexpr int TANGENTS_PER_PASS = QUAD_DRAG_TANGENTS_PER_PASS;
  static constexpr int ROW_WARPS = QUAD_DRAG_ROW_WARPS;
  static constexpr bool STAGES = false;
  static constexpr int CACHE_FLOATS = 0;
  using Ctx = const float*;
  QuadDragParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float*, T* xd) const {
    quad_xdot(P.quad, x, u, xd);
    T t[3];
    quad_drag_terms(P.D, x, t);
#pragma unroll
    for (int r = 0; r < 3; ++r) xd[7 + r] = xd[7 + r] + t[r];
  }
};

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
template <class ParamsC>
static bool params_ok(const ParamsC&, int) { return true; }

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

// A functor with a table in dynamic shared memory (GPQuadDualDyn): the
// kernels stage it after their own shared memory and hand each thread's
// context its address.
template <class Dyn, class = void>
struct dyn_table : std::false_type {};
template <class Dyn>
struct dyn_table<Dyn, std::void_t<decltype(&Dyn::table_floats)>> : std::true_type {};

// ------------------------------------------------------------- kernels

// RK4 sub-step sizes, rounded once from double on the host (the JAX map and
// the plain version round them likewise).
struct Steps {
  int n;
  float h, hh, h6;
};

// One RK4 map x <- F(x, u) in place, with the order of operations of
// pallas_vde.py:128-135: x + (h/6) * (((k1 + 2 k2) + 2 k3) + k4).
template <class T, class Dyn>
DI void rk4_map(T* x, const T* u, const typename Dyn::Ctx& p, const Dyn& f,
                Steps st) {
  constexpr int NX = Dyn::NX;
  for (int s = 0; s < st.n; ++s) {
    T k[NX], xt[NX], acc[NX];
    f(x, u, p, k);  // k1
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = k[i];
      xt[i] = x[i] + st.hh * k[i];
    }
    f(xt, u, p, k);  // k2
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xt[i] = x[i] + st.hh * k[i];
    }
    f(xt, u, p, k);  // k3
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xt[i] = x[i] + st.h * k[i];
    }
    f(xt, u, p, k);  // k4
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + st.h6 * (acc[i] + k[i]);
  }
}

// The warp copies rows [row0, row0 + rows) of an output with w floats per
// row from their tile in shared memory: 16-byte stores, then the ragged
// tail. row0 is a multiple of 32 and dst 16-byte aligned, so the range
// starts on 16 bytes; the tile does too.
DI void store_rows(float* __restrict__ dst, const float* tile, int w,
                   long long row0, int rows, int lane) {
  float* out = dst + row0 * w;
  const int len = rows * w, len4 = len / 4;
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = lane; i < len4; i += WARP) o4[i] = t4[i];
  for (int i = 4 * len4 + lane; i < len; i += WARP) out[i] = tile[i];
}

// One pass: tangent columns J0 .. J0+NT-1 of [A | Bm] of the thread's row,
// into its rows of the tiles (and, on the first pass, c).
template <int J0, int NT, class Dyn>
DI void vde_pass(const float* x0, const float* u0, const float* xn,
                 const typename Dyn::Ctx& p, const Dyn& f, Steps st, float* tA,
                 float* tB, float* tc) {
  constexpr int NX = Dyn::NX;
  constexpr int NU = Dyn::NU;
  Dual<NT> x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i].v = x0[i];
#pragma unroll
    for (int t = 0; t < NT; ++t) x[i].d[t] = (i == J0 + t) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i].v = u0[i];
#pragma unroll
    for (int t = 0; t < NT; ++t) u[i].d[t] = (NX + i == J0 + t) ? 1.0f : 0.0f;
  }

  rk4_map(x, u, p, f, st);

  // a[i*nx + j] = dF_i/dx_j, b[i*nu + j] = dF_i/du_j.
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = J0 + t;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (col < NX) tA[i * NX + col] = x[i].d[t];
      else tB[i * NU + (col - NX)] = x[i].d[t];
    }
  }
  if constexpr (J0 == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) tc[i] = x[i].v - xn[i];
  }
}

// The passes from column J0 on.
template <int J0, class Dyn>
DI void vde_passes(const float* x0, const float* u0, const float* xn,
                   const typename Dyn::Ctx& p, const Dyn& f, Steps st,
                   float* tA, float* tB, float* tc) {
  constexpr int NV = Dyn::NX + Dyn::NU;
  constexpr int TP = Dyn::TANGENTS_PER_PASS;
  constexpr int NT = TP < NV - J0 ? TP : NV - J0;
  vde_pass<J0, NT>(x0, u0, xn, p, f, st, tA, tB, tc);
  if constexpr (J0 + NT < NV)
    vde_passes<J0 + NT>(x0, u0, xn, p, f, st, tA, tB, tc);
}

// A warp's tile of vde_kernel in floats: its 32 rows of A, then of Bm, then
// of c.
template <class Dyn>
__host__ __device__ constexpr int vde_tile() {
  return WARP * Dyn::NX * (Dyn::NX + Dyn::NU + 1);
}

template <class Dyn>
__global__ void __launch_bounds__(Dyn::ROW_WARPS * WARP)
vde_kernel(const float* __restrict__ xs, const float* __restrict__ us,
           const float* __restrict__ ps, float* __restrict__ A,
           float* __restrict__ Bm, float* __restrict__ c, int batch, int N,
           int pd, Steps st, const __grid_constant__ Dyn f) {
  constexpr int NX = Dyn::NX;
  constexpr int NU = Dyn::NU;
  constexpr int ROW_WARPS = Dyn::ROW_WARPS;
  constexpr int TILE_B = WARP * NX * NX;
  constexpr int TILE_C = TILE_B + WARP * NX * NU;
  constexpr int TILE = vde_tile<Dyn>();
  static_assert(TILE % 4 == 0, "tiles start on 16 bytes");
  // ROW_WARPS tiles, then the functor's cache, then its table (dyn_table)
  extern __shared__ float4 smem[];
  float* const table =
      reinterpret_cast<float*>(smem) + ROW_WARPS * (TILE + WARP * Dyn::CACHE_FLOATS);
  if constexpr (Dyn::STAGES) {
    f.stage();
    __syncthreads();
  }
  if constexpr (dyn_table<Dyn>::value) {
    f.stage_to(table);
    __syncthreads();
  }

  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  float* tile = reinterpret_cast<float*>(smem) + warp * TILE;
  const long long rows = (long long)batch * N;
  const long long row0 = ((long long)blockIdx.x * ROW_WARPS + warp) * WARP;
  const long long row = min(row0 + lane, rows - 1);
  const long long b = row / N;

  const float* xk = xs + (row + b) * NX;  // (b*(N+1) + k) * NX
  float x0[NX], u0[NU], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x0[i] = xk[i];
    xn[i] = xk[NX + i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) u0[i] = us[row * NU + i];

  typename Dyn::Ctx ctx = f.context(ps + b * pd);
  if constexpr (dyn_table<Dyn>::value) f.use_table(ctx, table);
  if constexpr (Dyn::CACHE_FLOATS > 0)
    f.use_cache(ctx, reinterpret_cast<float*>(smem) + ROW_WARPS * TILE + threadIdx.x,
                4 * st.n);
  vde_passes<0>(x0, u0, xn, ctx, f, st, tile + lane * NX * NX,
                tile + TILE_B + lane * NX * NU, tile + TILE_C + lane * NX);

  __syncwarp();
  if (row0 < rows) {
    const int n = (int)min((long long)WARP, rows - row0);
    store_rows(A, tile, NX * NX, row0, n, lane);
    store_rows(Bm, tile + TILE_B, NX * NU, row0, n, lane);
    store_rows(c, tile + TILE_C, NX, row0, n, lane);
  }
}

// The RK4 map alone, row r = b*N + k: out[r] = F(x_{b,k}, u_{b,k}; p_b),
// minus x_{b,k+1} when `defect`. x rows are NX apart within a scenario.
template <class Dyn>
__global__ void __launch_bounds__(RK4_ROW_WARPS * WARP)
rk4_kernel(const float* __restrict__ xs, long long xs_b,
           const float* __restrict__ us, long long us_b, long long us_k,
           const float* __restrict__ ps, long long ps_b,
           float* __restrict__ out, int batch, int N, int defect, Steps st,
           const __grid_constant__ Dyn f) {
  constexpr int NX = Dyn::NX;
  constexpr int NU = Dyn::NU;
  __shared__ float4 smem[RK4_ROW_WARPS * WARP * NX / 4];
  extern __shared__ float4 rk4_table[];  // a dyn_table functor's table
  if constexpr (Dyn::STAGES) {
    f.stage();
    __syncthreads();
  }
  if constexpr (dyn_table<Dyn>::value) {
    f.stage_to(reinterpret_cast<float*>(rk4_table));
    __syncthreads();
  }

  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  float* tile = reinterpret_cast<float*>(smem) + warp * WARP * NX;
  const long long rows = (long long)batch * N;
  const long long row0 = ((long long)blockIdx.x * RK4_ROW_WARPS + warp) * WARP;
  const long long row = min(row0 + lane, rows - 1);
  const long long b = row / N;
  const long long k = row - b * N;

  const float* xk = xs + b * xs_b + k * NX;
  const float* uk = us + b * us_b + k * us_k;
  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xk[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = uk[i];

  typename Dyn::Ctx ctx = f.context(ps + b * ps_b);
  if constexpr (dyn_table<Dyn>::value)
    f.use_table(ctx, reinterpret_cast<const float*>(rk4_table));
  rk4_map(x, u, ctx, f, st);

#pragma unroll
  for (int i = 0; i < NX; ++i) tile[lane * NX + i] = defect ? x[i] - xk[NX + i] : x[i];
  __syncwarp();
  if (row0 < rows)
    store_rows(out, tile, NX, row0, (int)min((long long)WARP, rows - row0), lane);
}

static Steps steps_of(double dt, int n) {
  const double hd = dt / n;
  return Steps{n, (float)hd, (float)(0.5 * hd), (float)(hd / 6.0)};
}

// The launch's shape against the functor's: nx, nu as the wrapper states
// them, and at least NP parameter entries.
template <class Dyn>
static bool shape_ok(int nx, int nu, int pd, int steps) {
  return nx == Dyn::NX && nu == Dyn::NU && pd >= Dyn::NP && steps >= 1;
}

template <class Dyn>
static cudaError_t launch_vde(const float* xs, const float* us, const float* ps,
                              float* A, float* Bm, float* c, int batch, int N,
                              int nx, int nu, int pd, double dt, int steps,
                              Dyn f, void* stream) {
  if (!shape_ok<Dyn>(nx, nu, pd, steps)) return cudaErrorInvalidValue;
  const long long rows = (long long)batch * N;
  if (rows == 0) return cudaSuccess;
  constexpr int RW = Dyn::ROW_WARPS;
  // A tile per warp, then CACHE_FLOATS per thread for the functor, then its
  // table (a dyn_table functor's limit is set once, by vde_prepare).
  size_t bytes = sizeof(float) * RW * (vde_tile<Dyn>() + WARP * Dyn::CACHE_FLOATS);
  if constexpr (dyn_table<Dyn>::value) {
    bytes += sizeof(float) * f.table_floats();
  } else if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vde_kernel<Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const long long grid = (rows + RW * WARP - 1) / (RW * WARP);
  vde_kernel<Dyn><<<(unsigned)grid, RW * WARP, bytes, (cudaStream_t)stream>>>(
      xs, us, ps, A, Bm, c, batch, N, pd, steps_of(dt, steps), f);
  return cudaGetLastError();
}

template <class Dyn>
static cudaError_t launch_rk4(const float* xs, long long xs_b, const float* us,
                              long long us_b, long long us_k, const float* ps,
                              long long ps_b, float* out, int batch, int N,
                              int nx, int nu, int pd, int defect, double dt,
                              int steps, Dyn f, void* stream) {
  if (!shape_ok<Dyn>(nx, nu, pd, steps)) return cudaErrorInvalidValue;
  const long long rows = (long long)batch * N;
  if (rows == 0) return cudaSuccess;
  const long long grid = (rows + RK4_ROW_WARPS * WARP - 1) / (RK4_ROW_WARPS * WARP);
  size_t bytes = 0;
  if constexpr (dyn_table<Dyn>::value) bytes = sizeof(float) * f.table_floats();
  rk4_kernel<Dyn><<<(unsigned)grid, RK4_ROW_WARPS * WARP, bytes, (cudaStream_t)stream>>>(
      xs, xs_b, us, us_b, us_k, ps, ps_b, out, batch, N, defect,
      steps_of(dt, steps), f);
  return cudaGetLastError();
}

// One pair of C entries per dynamics functor, with these signatures apart
// from the by-value parameter struct. All tensors float32 on the device;
// outputs contiguous and 16-byte aligned. Each returns a cudaError_t, and
// refuses (cudaErrorInvalidValue) an nx, nu other than the functor's or
// fewer than its NP parameter entries.
//
// vde_<model>: xs (batch, N+1, nx), us (batch, N, nu), ps (batch, pd), all
// contiguous, in; A (batch, N, nx, nx), Bm (batch, N, nx, nu),
// c (batch, N, nx) out.
//
// rk4_<model>: out (batch, N, nx) = F(x_{b,k}, u_{b,k}; p_b), minus
// x_{b,k+1} when defect != 0. Strides in floats: x_{b,k} at
// xs + b*xs_b + nx*k, u_{b,k} at us + b*us_b + k*us_k, p_b at ps + b*ps_b;
// each row's entries adjacent. The step mode is N = 1. A parameter struct
// that params_ok refuses (GPQuadDualDyn's layout) is refused likewise.
#define VDE_ENTRIES(model, Dyn, ParamsC)                                      \
  int vde_##model(const float* xs, const float* us, const float* ps,         \
                  float* A, float* Bm, float* c, int batch, int N, int nx,   \
                  int nu, int pd, double dt, int rk4_steps, ParamsC params,  \
                  void* stream) {                                            \
    if (!params_ok(params, pd)) return (int)cudaErrorInvalidValue;           \
    return (int)launch_vde(xs, us, ps, A, Bm, c, batch, N, nx, nu, pd, dt,   \
                           rk4_steps, Dyn{params}, stream);                  \
  }                                                                          \
  int rk4_##model(const float* xs, long long xs_b, const float* us,          \
                  long long us_b, long long us_k, const float* ps,           \
                  long long ps_b, float* out, int batch, int N, int nx,      \
                  int nu, int pd, int defect, double dt, int rk4_steps,      \
                  ParamsC params, void* stream) {                            \
    if (!params_ok(params, pd)) return (int)cudaErrorInvalidValue;           \
    return (int)launch_rk4(xs, xs_b, us, us_b, us_k, ps, ps_b, out, batch,   \
                           N, nx, nu, pd, defect, dt, rk4_steps, Dyn{params}, \
                           stream);                                          \
  }

extern "C" {

VDE_ENTRIES(bicycle, BicycleDyn, BicycleParamsC)
VDE_ENTRIES(quad, QuadDyn, QuadParamsC)
VDE_ENTRIES(pacejka, PacejkaDyn, PacejkaParamsC)
VDE_ENTRIES(gp_bicycle, GPBicycleDyn, GPBicycleParamsC)
VDE_ENTRIES(gp_quad, GPQuadDyn, GPQuadParamsC)
VDE_ENTRIES(quad_drag, QuadDragDyn, QuadDragParamsC)
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

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
