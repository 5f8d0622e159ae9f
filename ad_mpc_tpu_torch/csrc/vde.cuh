// Fused RK4 + forward-sensitivity (VDE) sweep for Hopper (sm_90a), and the
// same RK4 map without tangents: the kernels, shared by the functor sources
// vde_<family>.cu.
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
// ~2.0 GFLOP). The GP models add their means: the operations (PERF.md).
// Measured on an H100 (PERF.md), the first design lost most of its time
// elsewhere: its stores were strided (a thread's 70 outputs lie 280 B from
// its neighbour's, so each warp store touched 32 partly written sectors;
// 83% of the time once the compute was lean), and each of its 336 IEEE
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
//     u_j are seeded with one-hot tangents. The thread-per-row path
//     (BicycleDyn, GPRoutedDyn) carries all nx+nu tangents in one pass
//     (vde_row): the bicycle's 9 take 255 registers and no spill once the
//     divisions are branch-free, 8 warps per SM; passes of 3 x 3 and 5 + 4,
//     each recomputing the primal, took 8% and 4% longer, and a warp per
//     pass 60-80% (PERF.md).
//   - The quads (QuadDyn, QuadMPC's QuadDragDyn, GPQuadDyn, QuadMPC's
//     GPQuadDualDyn, GPQuadDualDragDyn and GPQuadSelectDyn, whose table of
//     every cluster the block stages after its tile, and the routed
//     GPQuadRoutedDyn, whose scenarios' p rows the block stages there) run
//     a team of lanes per row instead
//     (ROW_TEAM, vde_team). In the thread-per-row design their 17 tangents
//     took 3 passes of 6 (the quad: 255 registers, 456 B spilled, a 29,952
//     B tile per warp, so 7 warps per SM) or 6 of 3 (the GP quad, whose
//     first pass summed 3 means over every training point in one thread,
//     6 warps per SM): each thread a long dependent chain with too few
//     warps to hide its latency, and at B=1 (QuadMPC) the whole chain was
//     the latency. A team of ROW_TEAM consecutive lanes of a warp shares
//     one row: lane r takes columns [r COLS, (r+1) COLS) as Dual<COLS>, all
//     in one pass, and carries the primal in lockstep (the same float
//     arithmetic in every lane, so no pass recomputes it). Fewer live
//     floats per lane let MIN_BLOCKS, a trait, cap the registers through
//     __launch_bounds__ for more warps per SM; a GP quad's 3 output dims
//     (the GP bicycle's 2) sum their means in 3 (2) lanes of the team at
//     once and broadcast them by __shfl_sync, each sum in the order of the
//     points. A block's
//     rows lie in one tile, which one thread copies out by three
//     cp.async.bulk copies (VDE_BULK_STORE; the block's 16-byte stores are
//     the measured alternative). The Pacejka (PacejkaDyn) and the GP
//     bicycle (GPBicycleDyn) state team traits with ROW_TEAM = 1, the
//     thread-per-row path launched through the team entry: with 9 columns
//     a team's repeated primal (the Pacejka's transcendentals, the GP
//     bicycle's registers per row) cost more than its lanes bought.
//     Tensor cores (wgmma, mma) do not apply: the
//     largest product is 13 x 17 per row, each step a dependent chain of
//     elementwise dual arithmetic, and a row's tiles cannot share
//     operands with another's. Widths measured in
//     experiments/quad_kernels.py and experiments/bicycle_kernels.py
//     (PERF.md).
//   - A dual division computes its value once with the bits of IEEE '/'
//     (fdiv_rcp of ieee_div.cuh, branch-free) and multiplies the tangents by
//     the reciprocal it refined; one sincosf per angle; a dual atan takes
//     its derivative from the same refined reciprocal. No --use_fast_math:
//     the 2e-5 parity assumes IEEE-accurate sinf/cosf/atanf/expf.
//   - The GP models' means and their gradients are float functions of the
//     features; a dual gets them by one contraction of the gradient with
//     the features' tangents (vde_models.cuh: gp_lift), not by carrying the
//     tangents through every training point's product and exp; so is the
//     RDRv drag R D R^T v of (q, v) on a team's duals.
// The dynamics is a __device__ functor templated on the scalar type, with
// one pair of C entries per functor (vde_<model>, rk4_<model>; VDE_ENTRIES,
// or VDE_TEAM_ENTRIES for a team functor).
// A functor states NX, NU, NP (parameter entries it reads; a launch with
// fewer is refused, and NP = 0 never reads ps), ROW_WARPS (and, a team
// functor, ROW_TEAM and MIN_BLOCKS), and a per-thread context Ctx
// built once from the scenario's
// parameter row (context(p)), before any pass: what depends on p alone is
// computed there in float, not as duals. The functor rides in the kernel's
// parameter space (__grid_constant__, never copied to local memory). Where
// a functor reads a table, the kernels put it in shared memory once per
// block before any row, since every lane of a warp then reads it at the
// same address (indexed reads of the parameter space cost the RK4 kernel
// 10x its time, PERF.md): a functor with STAGES copies its table from its
// parameters (stage()); one with table_floats() from a device buffer into
// dynamic shared memory (dyn_table: a team functor's, after the block's
// tile; the RK4 map's, alone); one with P_ROWS (the parameter-routed
// GPs, whose table is the scenario's own parameter row) has the p rows of
// the block's scenarios copied there (dyn_rows; a team functor's after the
// block's tile) where a scenario owns several rows (rows_staged), and its
// context points at its scenario's copy.
//
// The functors lie in one source per family, each built into a library of
// its own (ops/_build.py compiles them in parallel): vde_bicycle.cu
// (BicycleDyn, PacejkaDyn), vde_gp_bicycle.cu (GPBicycleDyn, GPRoutedDyn),
// vde_quad.cu (QuadDyn, QuadDragDyn), vde_gp_quad.cu (GPQuadDyn),
// vde_gp_quad_routed.cu (GPQuadRoutedDyn), vde_gp_quad_dual.cu
// (GPQuadDualDyn), vde_gp_quad_dual_drag.cu (GPQuadDualDragDyn) and
// vde_gp_quad_select.cu (GPQuadSelectDyn).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC vde_<family>.cu (no --use_fast_math: IEEE
//        sinf/cosf/atanf/expf and division). -D<MODEL>_ROW_TEAM=n,
//        -D<MODEL>_MIN_BLOCKS=n and -D<MODEL>_ROW_WARPS=n override a team
//        functor's traits (the sweeps of experiments/quad_kernels.py and
//        experiments/bicycle_kernels.py).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "ieee_div.cuh"

#define DI __device__ __forceinline__

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

// ------------------------------------------------------------- functor traits

// A functor with a table in dynamic shared memory (GPQuadDualDyn,
// GPQuadSelectDyn; team functors): the kernels stage it after their own
// shared memory and hand each thread's context its address.
template <class Dyn, class = void>
struct dyn_table : std::false_type {};
template <class Dyn>
struct dyn_table<Dyn, std::void_t<decltype(&Dyn::table_floats)>> : std::true_type {};

// A functor that reads its scenario's parameter row from shared memory
// (P_ROWS, the parameter-routed GPs): the kernels copy the p rows of the
// block's scenarios there after their own shared memory, and build each
// thread's context from its scenario's copy.
template <class Dyn, class = void>
struct dyn_rows : std::false_type {};
template <class Dyn>
struct dyn_rows<Dyn, std::void_t<decltype(Dyn::P_ROWS)>> : std::true_type {};

// A functor's team: ROW_TEAM consecutive lanes of a warp share one (b, k)
// row and split its tangent columns (vde_team); 1 (stated, or where the
// functor states none), the thread-per-row path. MIN_BLOCKS, the
// blocks per SM that vde_kernel's registers are capped for
// (__launch_bounds__), is 1 where it states none.
template <class Dyn, class = void>
struct row_team : std::integral_constant<int, 1> {};
template <class Dyn>
struct row_team<Dyn, std::void_t<decltype(Dyn::ROW_TEAM)>>
    : std::integral_constant<int, Dyn::ROW_TEAM> {};
template <class Dyn, class = void>
struct min_blocks : std::integral_constant<int, 1> {};
template <class Dyn>
struct min_blocks<Dyn, std::void_t<decltype(Dyn::MIN_BLOCKS)>>
    : std::integral_constant<int, Dyn::MIN_BLOCKS> {};

// A launch's parameter struct that its functor cannot take: none, unless a
// source declares an overload for its struct (GPQuadDualDyn's table layout,
// the routed GPs' p_dim).
template <class ParamsC>
static bool params_ok(const ParamsC&, int) { return true; }

// Whether the kernels stage a dyn_rows functor's p rows in shared memory:
// when each scenario owns N > 1 rows, so that a block reads each row N
// times. With N = 1 (the plant step, one-stage scenarios) every row is its
// own scenario's and staging would buy no reuse, only shared memory that
// caps the resident warps (a routed GP quad's 2.9 KB row per thread holds
// 2 warps per SM): the functor then reads its row from global memory.
__host__ __device__ inline bool rows_staged(int N) { return N > 1; }

// The most scenarios whose p rows a block of `rows_per_block` rows reads,
// at horizon N.
__host__ __device__ inline long long block_scenarios(int rows_per_block, int N,
                                                     int batch) {
  const long long s = (rows_per_block - 1) / N + 2;
  return s < batch ? s : batch;
}

// The block's scenarios [b_first, b_last] and their p rows (pd floats each,
// ps_b apart in global memory) copied to dst in shared memory by 4-byte
// cp.async, so that a thread's copies are in flight at once instead of
// each store waiting on its load (a quarter of the routed GP quad's team
// sweep at B=16384, PERF.md); the caller synchronizes.
DI long long stage_rows(float* dst, const float* __restrict__ ps, long long ps_b,
                        int pd, long long row_first, long long row_last, int N) {
  const long long b_first = row_first / N, b_last = row_last / N;
  const int len = (int)(b_last - b_first + 1) * pd;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(ps + (b_first + i / pd) * ps_b + i % pd)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  return b_first;
}

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
// A team functor's block copies its rows likewise, `stride` threads apart.
DI void store_rows(float* __restrict__ dst, const float* tile, int w,
                   long long row0, int rows, int lane, int stride = WARP) {
  float* out = dst + row0 * w;
  const int len = rows * w, len4 = len / 4;
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = lane; i < len4; i += stride) o4[i] = t4[i];
  for (int i = 4 * len4 + lane; i < len; i += stride) out[i] = tile[i];
}

// The thread-per-row path: every tangent column of [A | Bm] of the
// thread's row, and its c, into its rows of the tiles.
template <class Dyn>
DI void vde_row(const float* x0, const float* u0, const float* xn,
                const typename Dyn::Ctx& p, const Dyn& f, Steps st, float* tA,
                float* tB, float* tc) {
  constexpr int NX = Dyn::NX;
  constexpr int NU = Dyn::NU;
  constexpr int NT = NX + NU;
  Dual<NT> x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i].v = x0[i];
#pragma unroll
    for (int t = 0; t < NT; ++t) x[i].d[t] = (i == t) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i].v = u0[i];
#pragma unroll
    for (int t = 0; t < NT; ++t) u[i].d[t] = (NX + i == t) ? 1.0f : 0.0f;
  }

  rk4_map(x, u, p, f, st);

  // a[i*nx + j] = dF_i/dx_j, b[i*nu + j] = dF_i/du_j.
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (t < NX) tA[i * NX + t] = x[i].d[t];
      else tB[i * NU + (t - NX)] = x[i].d[t];
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) tc[i] = x[i].v - xn[i];
}

// A warp's tile of vde_kernel in floats: its 32 rows of A, then of Bm, then
// of c.
template <class Dyn>
__host__ __device__ constexpr int vde_tile() {
  return WARP * Dyn::NX * (Dyn::NX + Dyn::NU + 1);
}

// A team functor's block: its rows, its tangent columns per lane, and its
// tile in floats (the block's rows of A, then of Bm, then of c).
template <class Dyn>
struct TeamShape {
  static constexpr int NV = Dyn::NX + Dyn::NU;
  static constexpr int TEAM = row_team<Dyn>::value;
  static constexpr int COLS = (NV + TEAM - 1) / TEAM;
  static constexpr int ROWS = Dyn::ROW_WARPS * WARP / TEAM;
  static constexpr int TILE_B = ROWS * Dyn::NX * Dyn::NX;
  static constexpr int TILE_C = TILE_B + ROWS * Dyn::NX * Dyn::NU;
  static constexpr int TILE = ROWS * Dyn::NX * (NV + 1);
};

// Whether the team path copies a whole block's tile out by three bulk
// asynchronous copies (cp.async.bulk, one thread issuing and waiting for
// their reads of the tile) or by the block's 16-byte stores
// (-DVDE_BULK_STORE=0, a measured variant); a ragged last block stores.
#ifndef VDE_BULK_STORE
#define VDE_BULK_STORE 1
#endif

#if VDE_BULK_STORE
DI void bulk_store(float* dst, const float* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes)
               : "memory");
}
#endif

// The RK4 map of the team path: rk4_map's arithmetic, with the first
// sub-step's start x0 read again from the row (its value xk[i], its tangent
// the lane's one-hot seed) wherever rk4_map reads x, instead of held in
// registers as duals across the sub-step's four evaluations; later
// sub-steps (rk4_steps > 1) run rk4_map on the result.
template <class Dyn, int NT>
DI void rk4_team(const float* xk, int j0, Dual<NT>* x, const Dual<NT>* u,
                 const typename Dyn::Ctx& p, const Dyn& f, Steps st) {
  constexpr int NX = Dyn::NX;
  const auto x0 = [&](int i) {
    Dual<NT> s;
    s.v = xk[i];
#pragma unroll
    for (int t = 0; t < NT; ++t) s.d[t] = (i == j0 + t) ? 1.0f : 0.0f;
    return s;
  };
  {
    Dual<NT> k[NX], xt[NX], acc[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x0(i);
    f(xt, u, p, k);  // k1
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = k[i];
      xt[i] = x0(i) + st.hh * k[i];
    }
    f(xt, u, p, k);  // k2
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xt[i] = x0(i) + st.hh * k[i];
    }
    f(xt, u, p, k);  // k3
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.0f * k[i];
      xt[i] = x0(i) + st.h * k[i];
    }
    f(xt, u, p, k);  // k4
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0(i) + st.h6 * (acc[i] + k[i]);
  }
  if (st.n > 1) rk4_map(x, u, p, f, Steps{st.n - 1, st.h, st.hh, st.h6});
}

// The team path of vde_kernel: ROW_TEAM lanes per (b, k) row, thread t of
// the block on row t / ROW_TEAM of the block's ROWS, its lane r = t %
// ROW_TEAM on tangent columns [r COLS, (r + 1) COLS) of [A | Bm], all in
// one pass. Every lane carries the primal in lockstep with its columns (the
// same float arithmetic in each), so no pass recomputes it; lane 0 writes
// c. A ragged last block computes clamped duplicates of the last row and
// copies only its own rows. A dyn_table functor's table is staged after
// the block's tile, and every lane's context points at it; so are a
// dyn_rows functor's block's p rows where rows_staged(N), each lane's
// context at its scenario's copy (else at its row in global memory).
template <class Dyn>
DI void vde_team(float* tile, const float* __restrict__ xs, const float* __restrict__ us,
                 const float* __restrict__ ps, float* __restrict__ A,
                 float* __restrict__ Bm, float* __restrict__ c, int batch, int N,
                 int pd, Steps st, const Dyn& f) {
  using S = TeamShape<Dyn>;
  constexpr int NX = Dyn::NX;
  constexpr int NU = Dyn::NU;
  static_assert(WARP % S::TEAM == 0, "a team lies within a warp");
  static_assert(S::ROWS % 4 == 0, "a block's rows start on 16 bytes in A, Bm and c");
  static_assert(!(dyn_rows<Dyn>::value && dyn_table<Dyn>::value),
                "a functor stages its table or its p rows after the tile, not both");
  const int slot = threadIdx.x / S::TEAM, j0 = (threadIdx.x % S::TEAM) * S::COLS;
  const long long rows = (long long)batch * N;
  const long long row0 = (long long)blockIdx.x * S::ROWS;
  const long long row = min(row0 + slot, rows - 1);
  const long long b = row / N;

  const float* xk = xs + (row + b) * NX;  // (b*(N+1) + k) * NX
  Dual<S::COLS> x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    u[i].v = us[row * NU + i];
#pragma unroll
    for (int t = 0; t < S::COLS; ++t) u[i].d[t] = (NX + i == j0 + t) ? 1.0f : 0.0f;
  }
  // A dyn_rows functor's two branches each call rk4_team, so that the
  // staged branch's reads of the p row compile to shared-memory loads; one
  // call with a pointer to either memory took 7% longer (PERF.md).
  if constexpr (dyn_rows<Dyn>::value) {
    if (rows_staged(N)) {
      float* staged = tile + S::TILE;
      const long long b_first =
          stage_rows(staged, ps, pd, pd, row0, min(row0 + S::ROWS, rows) - 1, N);
      __syncthreads();
      rk4_team(xk, j0, x, u, f.context(staged + (b - b_first) * pd), f, st);
    } else {
      rk4_team(xk, j0, x, u, f.context(ps + b * pd), f, st);
    }
  } else {
    typename Dyn::Ctx ctx = f.context(ps + b * pd);
    if constexpr (dyn_table<Dyn>::value) {
      float* table = tile + S::TILE;
      f.stage_to(table);
      __syncthreads();
      f.use_table(ctx, table);
    }
    rk4_team(xk, j0, x, u, ctx, f, st);
  }

  // a[i*nx + j] = dF_i/dx_j, b[i*nu + j] = dF_i/du_j.
  float* tA = tile + slot * NX * NX;
  float* tB = tile + S::TILE_B + slot * NX * NU;
#pragma unroll
  for (int t = 0; t < S::COLS; ++t) {
    const int col = j0 + t;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (col < NX) tA[i * NX + col] = x[i].d[t];
      else if (col < S::NV) tB[i * NU + (col - NX)] = x[i].d[t];
    }
  }
  if (j0 == 0) {
    float* tc = tile + S::TILE_C + slot * NX;
#pragma unroll
    for (int i = 0; i < NX; ++i) tc[i] = x[i].v - xk[NX + i];
  }

  const int n = (int)min((long long)S::ROWS, rows - row0);  // >= 1: the grid is exact
#if VDE_BULK_STORE
  if (n == S::ROWS) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(A + row0 * NX * NX, tile, 4u * S::TILE_B);
      bulk_store(Bm + row0 * NX * NU, tile + S::TILE_B, 4u * (S::TILE_C - S::TILE_B));
      bulk_store(c + row0 * NX, tile + S::TILE_C, 4u * (S::TILE - S::TILE_C));
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    return;
  }
#endif
  __syncthreads();
  store_rows(A, tile, NX * NX, row0, n, threadIdx.x, blockDim.x);
  store_rows(Bm, tile + S::TILE_B, NX * NU, row0, n, threadIdx.x, blockDim.x);
  store_rows(c, tile + S::TILE_C, NX, row0, n, threadIdx.x, blockDim.x);
}

template <class Dyn>
__global__ void __launch_bounds__(Dyn::ROW_WARPS * WARP, min_blocks<Dyn>::value)
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
  // ROW_WARPS tiles, then the block's p rows (dyn_rows); a team functor's
  // block tile, then its table or its p rows (vde_team)
  extern __shared__ float4 smem[];
  float* const table = reinterpret_cast<float*>(smem) + ROW_WARPS * TILE;
  if constexpr (Dyn::STAGES) {
    f.stage();
    __syncthreads();
  }
  if constexpr (row_team<Dyn>::value > 1) {
    vde_team(reinterpret_cast<float*>(smem), xs, us, ps, A, Bm, c, batch, N, pd, st, f);
  } else {
    static_assert(!dyn_table<Dyn>::value,
                  "a table in dynamic shared memory takes the team path");

    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    float* tile = reinterpret_cast<float*>(smem) + warp * TILE;
    const long long rows = (long long)batch * N;
    const long long row0 = ((long long)blockIdx.x * ROW_WARPS + warp) * WARP;
    const long long row = min(row0 + lane, rows - 1);
    const long long b = row / N;
    long long b_first = 0;
    if constexpr (dyn_rows<Dyn>::value) {
      if (rows_staged(N)) {
        const long long first = (long long)blockIdx.x * ROW_WARPS * WARP;
        b_first = stage_rows(table, ps, pd, pd, first,
                             min(first + ROW_WARPS * WARP, rows) - 1, N);
        __syncthreads();
      }
    }

    const float* xk = xs + (row + b) * NX;  // (b*(N+1) + k) * NX
    float x0[NX], u0[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x0[i] = xk[i];
      xn[i] = xk[NX + i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) u0[i] = us[row * NU + i];

    const float* prow = ps + b * pd;
    if constexpr (dyn_rows<Dyn>::value) {
      if (rows_staged(N)) prow = table + (b - b_first) * pd;
    }
    typename Dyn::Ctx ctx = f.context(prow);
    vde_row(x0, u0, xn, ctx, f, st, tile + lane * NX * NX, tile + TILE_B + lane * NX * NU,
            tile + TILE_C + lane * NX);

    __syncwarp();
    if (row0 < rows) {
      const int n = (int)min((long long)WARP, rows - row0);
      store_rows(A, tile, NX * NX, row0, n, lane);
      store_rows(Bm, tile + TILE_B, NX * NU, row0, n, lane);
      store_rows(c, tile + TILE_C, NX, row0, n, lane);
    }
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
  constexpr int RW = RK4_ROW_WARPS;
  __shared__ float4 smem[RW * WARP * NX / 4];
  extern __shared__ float4 rk4_table[];  // a dyn_table functor's table, or p rows
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
  const long long row0 = ((long long)blockIdx.x * RW + warp) * WARP;
  const long long row = min(row0 + lane, rows - 1);
  const long long b = row / N;
  const long long k = row - b * N;
  long long b_first = 0;
  if constexpr (dyn_rows<Dyn>::value) {
    if (rows_staged(N)) {
      const long long first = (long long)blockIdx.x * RW * WARP;
      b_first = stage_rows(reinterpret_cast<float*>(rk4_table), ps, ps_b, f.p_dim(),
                           first, min(first + RW * WARP, rows) - 1, N);
      __syncthreads();
    }
  }

  const float* xk = xs + b * xs_b + k * NX;
  const float* uk = us + b * us_b + k * us_k;
  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xk[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = uk[i];

  const float* prow = ps + b * ps_b;
  if constexpr (dyn_rows<Dyn>::value) {
    if (rows_staged(N))
      prow = reinterpret_cast<const float*>(rk4_table) + (b - b_first) * f.p_dim();
  }
  typename Dyn::Ctx ctx = f.context(prow);
  if constexpr (dyn_table<Dyn>::value)
    f.use_table(ctx, reinterpret_cast<const float*>(rk4_table));
  rk4_map(x, u, ctx, f, st);

#pragma unroll
  for (int i = 0; i < NX; ++i) tile[lane * NX + i] = defect ? x[i] - xk[NX + i] : x[i];
  __syncwarp();
  if (row0 < rows)
    store_rows(out, tile, NX, row0, (int)min((long long)WARP, rows - row0), lane);
}

// The dynamic shared memory a block of `kernel` may opt in to on this
// device (the device's limit less the kernel's static shared memory): what
// vde_prepare lets a dyn_rows functor's kernels take.
static int rows_limit(const void* kernel) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  return bytes - (int)attr.sharedSizeBytes;
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
  // A tile per warp, then its block's p rows (the limit of a dyn_rows
  // functor's kernels is set once, by vde_prepare).
  size_t bytes = sizeof(float) * RW * vde_tile<Dyn>();
  if constexpr (dyn_rows<Dyn>::value) {
    if (rows_staged(N)) bytes += sizeof(float) * pd * block_scenarios(RW * WARP, N, batch);
    static const int limit = rows_limit((const void*)vde_kernel<Dyn>);
    if (bytes > (size_t)limit) return cudaErrorInvalidValue;
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

// A team functor's sweep, launched with the geometry the wrapper computed
// (ops/cuda_vde.py:vde_geometry; with ROW_TEAM = 1 the thread-per-row
// path's, whose per-warp tiles make TeamShape's tile): refused unless it
// is the functor's, so that the launch bounds, the block's rows and its
// tile (and a dyn_table
// functor's table or a dyn_rows functor's block's p rows after it) agree
// with the kernel's, and refused where the p rows would take more shared
// memory than vde_prepare let the kernel take.
template <class Dyn>
static cudaError_t launch_vde_team(const float* xs, const float* us, const float* ps,
                                   float* A, float* Bm, float* c, int batch, int N,
                                   int nx, int nu, int pd, int grid, int threads,
                                   int bytes, double dt, int steps, Dyn f,
                                   void* stream) {
  using S = TeamShape<Dyn>;
  if (!shape_ok<Dyn>(nx, nu, pd, steps)) return cudaErrorInvalidValue;
  const long long rows = (long long)batch * N;
  if (rows == 0) return cudaSuccess;
  long long floats = S::TILE;
  if constexpr (dyn_table<Dyn>::value) floats += f.table_floats();
  if constexpr (dyn_rows<Dyn>::value) {
    if (rows_staged(N)) floats += (long long)pd * block_scenarios(S::ROWS, N, batch);
    static const int limit = rows_limit((const void*)vde_kernel<Dyn>);
    if ((long long)sizeof(float) * floats > limit) return cudaErrorInvalidValue;
  }
  if (threads != Dyn::ROW_WARPS * WARP || bytes != (long long)sizeof(float) * floats ||
      grid != (rows + S::ROWS - 1) / S::ROWS)
    return cudaErrorInvalidValue;
  vde_kernel<Dyn><<<(unsigned)grid, threads, bytes, (cudaStream_t)stream>>>(
      xs, us, ps, A, Bm, c, batch, N, pd, steps_of(dt, steps), f);
  return cudaGetLastError();
}

// A team functor's traits as its source was built: ROW_TEAM, ROW_WARPS,
// MIN_BLOCKS, tangent columns per lane, vde_kernel's static shared bytes
// and its registers.
template <class Dyn>
static cudaError_t team_traits(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, vde_kernel<Dyn>);
  if (err != cudaSuccess) return err;
  const int v[6] = {TeamShape<Dyn>::TEAM, Dyn::ROW_WARPS, min_blocks<Dyn>::value,
                    TeamShape<Dyn>::COLS, (int)attr.sharedSizeBytes, attr.numRegs};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

// Blocks of vde_kernel<Dyn> of `threads` threads and `bytes` of dynamic
// shared memory resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the error.
template <class Dyn>
static int team_occupancy(int threads, int bytes) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, vde_kernel<Dyn>, threads, bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// Let a team functor's sweep take its block tile's shared memory, and a
// dyn_table functor's kernels the shared memory of its largest table
// (`table` floats) besides (at the library's first load, so that no launch
// sets an attribute and a launch may be captured in a CUDA graph).
template <class Dyn>
static cudaError_t prepare_team(int table = 0) {
  const cudaError_t err = cudaFuncSetAttribute(
      vde_kernel<Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(float) * (TeamShape<Dyn>::TILE + table));
  if (err != cudaSuccess || table == 0) return err;
  return cudaFuncSetAttribute(rk4_kernel<Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(float) * table);
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
  constexpr int RW = RK4_ROW_WARPS;
  const long long grid = (rows + RW * WARP - 1) / (RW * WARP);
  size_t bytes = 0;
  if constexpr (dyn_table<Dyn>::value) bytes = sizeof(float) * f.table_floats();
  if constexpr (dyn_rows<Dyn>::value) {
    if (rows_staged(N)) bytes = sizeof(float) * pd * block_scenarios(RW * WARP, N, batch);
    static const int limit = rows_limit((const void*)rk4_kernel<Dyn>);
    if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  }
  rk4_kernel<Dyn><<<(unsigned)grid, RW * WARP, bytes, (cudaStream_t)stream>>>(
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
// that params_ok refuses (GPQuadDualDyn's layout, a routed GP's p_dim) is
// refused likewise, and so is a launch whose block's p rows (dyn_rows) would
// take more shared memory than the device allows.
//
// A team functor's entries (VDE_TEAM_ENTRIES): vde_<model> takes the launch
// geometry (grid, threads, dynamic shared bytes) after pd, as
// ops/cuda_vde.py:vde_geometry computes it, and refuses any other;
// vde_<model>_traits writes team_traits' six ints and
// vde_<model>_occupancy(threads, bytes) gives team_occupancy.
#define RK4_ENTRY(model, Dyn, ParamsC)                                        \
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

#define VDE_ENTRIES(model, Dyn, ParamsC)                                      \
  int vde_##model(const float* xs, const float* us, const float* ps,         \
                  float* A, float* Bm, float* c, int batch, int N, int nx,   \
                  int nu, int pd, double dt, int rk4_steps, ParamsC params,  \
                  void* stream) {                                            \
    if (!params_ok(params, pd)) return (int)cudaErrorInvalidValue;           \
    return (int)launch_vde(xs, us, ps, A, Bm, c, batch, N, nx, nu, pd, dt,   \
                           rk4_steps, Dyn{params}, stream);                  \
  }                                                                          \
  RK4_ENTRY(model, Dyn, ParamsC)

#define VDE_TEAM_ENTRIES(model, Dyn, ParamsC)                                 \
  int vde_##model(const float* xs, const float* us, const float* ps,         \
                  float* A, float* Bm, float* c, int batch, int N, int nx,   \
                  int nu, int pd, int grid, int threads, int bytes,          \
                  double dt, int rk4_steps, ParamsC params, void* stream) {  \
    if (!params_ok(params, pd)) return (int)cudaErrorInvalidValue;           \
    return (int)launch_vde_team(xs, us, ps, A, Bm, c, batch, N, nx, nu, pd,  \
                                grid, threads, bytes, dt, rk4_steps,         \
                                Dyn{params}, stream);                        \
  }                                                                          \
  int vde_##model##_traits(int* out) { return (int)team_traits<Dyn>(out); }  \
  int vde_##model##_occupancy(int threads, int bytes) {                      \
    return team_occupancy<Dyn>(threads, bytes);                              \
  }                                                                          \
  RK4_ENTRY(model, Dyn, ParamsC)

// Let a dyn_rows functor's kernels take the most dynamic shared memory the
// device allows (at the library's first load, so that no launch sets an
// attribute and a launch may be captured in a CUDA graph).
template <class Dyn>
static cudaError_t prepare_rows() {
  cudaError_t err = cudaFuncSetAttribute(
      vde_kernel<Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rows_limit((const void*)vde_kernel<Dyn>));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(rk4_kernel<Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              rows_limit((const void*)rk4_kernel<Dyn>));
}

#define VDE_ERROR_STRING \
  const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
