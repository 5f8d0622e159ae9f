// Fused RK4 + forward-sensitivity (VDE) sweep for Hopper (sm_90a).
//
// Replaces: ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel (built by make_vde).
// For every (scenario b, stage k) it integrates one RK4 interval
// F(x_k, u_k; p_b), its exact forward sensitivities A_k = dF/dx and
// B_k = dF/du, and the multiple-shooting defect c_k = F(x_k, u_k) - x_{k+1}.
//
// What bounds it on the H100: at c2 (B=16384, N=30, nx=7, nu=2) the kernel
// moves ~156 MB (xs, us in; A, Bm, c out: ~47 us at 3.35 TB/s) and does
// ~4.3 GFLOP (primal RK4 plus nx+nu tangent sweeps: ~64 us at 67 TFLOP/s
// FP32), so it sits near the ridge, slightly on the operations side.
//
// Design: one thread per (b, k), thread index b*N + k, reading and writing
// the solver's batch-first layout directly (no transposes or padding around
// the launch). A CUDA kernel has no AD, so derivatives are forward-mode dual
// numbers: Dual<NT> carries a value and NT tangents, and x_j / u_j are
// seeded with one-hot tangents. The nx+nu = 9 tangents run in passes of
// TANGENTS_PER_PASS = 3, each recomputing the (cheap) primal: all 9 at once
// need 255 registers and spill, one at a time triples the primal work, and
// 3 was the fastest of the three on an H100 (PERF.md). The dynamics is a
// __device__ functor templated on the scalar type, with one C entry per
// functor (vde_<model>); this file has one, the blended bicycle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE sinf/cosf/division).

#include <cuda_runtime.h>

#define DI __device__ __forceinline__

constexpr int TANGENTS_PER_PASS = 3;

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

template <int NT>
DI Dual<NT> operator/(const Dual<NT>& a, const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <int NT>
DI Dual<NT> operator/(const Dual<NT>& a, float b) {
  Dual<NT> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] / b;
  return r;
}

template <int NT>
DI Dual<NT> sin(const Dual<NT>& a) {
  float s, c;
  sincosf(a.v, &s, &c);
  Dual<NT> r;
  r.v = s;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = c * a.d[i];
  return r;
}
template <int NT>
DI Dual<NT> cos(const Dual<NT>& a) {
  float s, c;
  sincosf(a.v, &s, &c);
  Dual<NT> r;
  r.v = c;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.d[i] = -s * a.d[i];
  return r;
}

// ------------------------------------------------------------- dynamics
// A functor evaluates x_dot = f(x, u; p) for any scalar type T with the
// operators above. p is the scenario's parameter row (not differentiated).

struct BicycleParamsC {  // by value from the wrapper (models/bicycle.py)
  float mass, l_f, l_r, iz, cf, cr, wheelbase;
};

// The blended kinematic/dynamic bicycle (ad_mpc_tpu/models/bicycle.py:60-114)
// with the blend switch taken from p[0]; same order of operations.
struct BicycleDyn {
  static constexpr int NX = 7;
  static constexpr int NU = 2;
  BicycleParamsC P;

  template <class T>
  DI void operator()(const T* x, const T* u, const float* p, T* xd) const {
    const float s = p[0];
    const T& psi = x[2];
    const T& v_x = x[3];
    const T& v_y = x[4];
    const T& psi_dot = x[5];
    const T& delta = x[6];
    const T& a = u[0];
    const T& delta_dot = u[1];

    const T v_x_safe = v_x + 1e-6f;
    const T f_fy = (2.0f * P.cf) * (delta - (v_y + P.l_f * psi_dot) / v_x_safe);
    const T f_ry = (2.0f * P.cr) * (P.l_r * psi_dot - v_y) / v_x_safe;

    const T sps = sin(psi), cps = cos(psi);
    xd[0] = v_x * cps - v_y * sps;
    xd[1] = v_x * sps + v_y * cps;
    xd[2] = psi_dot;

    const T sd = sin(delta), cd = cos(delta);
    const T v_x_dyn = a - (f_fy * sd) / P.mass + v_y * psi_dot;
    const T v_y_dyn = (f_ry + f_fy * cd) / P.mass - v_x * psi_dot;
    const T kin = delta_dot * v_x + delta * a;
    const T v_y_kin = kin * P.l_r / P.wheelbase;
    const T psi_dd_dyn = (P.l_f * f_fy * cd - P.l_r * f_ry) / P.iz;
    const T psi_dd_kin = kin / P.wheelbase;

    xd[3] = s * v_x_dyn + (1.0f - s) * a;
    xd[4] = s * v_y_dyn + (1.0f - s) * v_y_kin;
    xd[5] = s * psi_dd_dyn + (1.0f - s) * psi_dd_kin;
    xd[6] = delta_dot;
  }
};

// ------------------------------------------------------------- kernel

// One RK4 map x <- F(x, u) in place, with the order of operations of
// pallas_vde.py:128-135: x + (h/6) * (((k1 + 2 k2) + 2 k3) + k4).
template <class T, class Dyn>
DI void rk4_map(T* x, const T* u, const float* p, const Dyn& f, int steps,
                float h, float hh, float h6) {
  constexpr int NX = Dyn::NX;
  for (int s = 0; s < steps; ++s) {
    T k[NX], xt[NX], acc[NX];
    f(x, u, p, k);  // k1
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = k[i];
      xt[i] = x[i] + hh * k[i];
    }
    f(xt, u, p, k);  // k2
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xt[i] = x[i] + hh * k[i];
    }
    f(xt, u, p, k);  // k3
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xt[i] = x[i] + h * k[i];
    }
    f(xt, u, p, k);  // k4
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x[i] + h6 * (acc[i] + k[i]);
  }
}

template <class Dyn>
__global__ void __launch_bounds__(128)
vde_kernel(const float* __restrict__ xs, const float* __restrict__ us,
           const float* __restrict__ ps, float* __restrict__ A,
           float* __restrict__ Bm, float* __restrict__ c, int batch, int N,
           int pd, double dt, int steps, Dyn f) {
  constexpr int NX = Dyn::NX;
  constexpr int NU = Dyn::NU;
  constexpr int NV = NX + NU;
  constexpr int NT = TANGENTS_PER_PASS;
  constexpr int PASSES = (NV + NT - 1) / NT;

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)batch * N) return;
  const long long b = tid / N;
  const long long k = tid - b * N;

  // Step sizes in double, rounded once (the JAX map rounds them likewise).
  const double hd = dt / steps;
  const float h = (float)hd, hh = (float)(0.5 * hd), h6 = (float)(hd / 6.0);

  const float* xk = xs + (b * (N + 1) + k) * NX;
  const float* uk = us + tid * NU;
  const float* p = ps + b * pd;
  float* Ak = A + tid * (NX * NX);
  float* Bk = Bm + tid * (NX * NU);
  float* ck = c + tid * NX;

  float x0[NX], u0[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = xk[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u0[i] = uk[i];

#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int j0 = pass * NT;  // first tangent column of this pass
    Dual<NT> x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i].v = x0[i];
#pragma unroll
      for (int t = 0; t < NT; ++t) x[i].d[t] = (i == j0 + t) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      u[i].v = u0[i];
#pragma unroll
      for (int t = 0; t < NT; ++t) u[i].d[t] = (NX + i == j0 + t) ? 1.0f : 0.0f;
    }

    rk4_map(x, u, p, f, steps, h, hh, h6);

    // a[i*nx + j] = dF_i/dx_j, b[i*nu + j] = dF_i/du_j.
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = j0 + t;
      if (col < NX) {
#pragma unroll
        for (int i = 0; i < NX; ++i) Ak[i * NX + col] = x[i].d[t];
      } else if (col < NV) {
#pragma unroll
        for (int i = 0; i < NX; ++i) Bk[i * NU + (col - NX)] = x[i].d[t];
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i) ck[i] = x[i].v - xk[NX + i];
    }
  }
}

template <class Dyn>
static cudaError_t launch(const float* xs, const float* us, const float* ps,
                          float* A, float* Bm, float* c, int batch, int N,
                          int pd, double dt, int steps, Dyn f, void* stream) {
  if (pd < 1 || steps < 1) return cudaErrorInvalidValue;
  const long long n = (long long)batch * N;
  if (n == 0) return cudaSuccess;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  vde_kernel<Dyn><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      xs, us, ps, A, Bm, c, batch, N, pd, dt, steps, f);
  return cudaGetLastError();
}

extern "C" {

// One entry per dynamics functor, all with this signature apart from the
// by-value parameter struct: xs (batch, N+1, 7), us (batch, N, 2),
// ps (batch, pd) in; A (batch, N, 7, 7), Bm (batch, N, 7, 2), c (batch, N, 7)
// out; all float32, contiguous, on the device. Returns a cudaError_t.
int vde_bicycle(const float* xs, const float* us, const float* ps, float* A,
                float* Bm, float* c, int batch, int N, int pd, double dt,
                int rk4_steps, BicycleParamsC params, void* stream) {
  return (int)launch(xs, us, ps, A, Bm, c, batch, N, pd, dt, rk4_steps,
                     BicycleDyn{params}, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
