// The interior-point LQ kernel at the quadrotor's shape, nx = 13, nu = 4,
// for Hopper (sm_90a). Included by lq_ipm.cu after the helpers it shares
// with the 7x2 kernel (the cone terms and steps, the cp.async wrappers,
// load_vec, LqBounds) and behind the same C interface.
//
// Replaces: ad_mpc_tpu/ops/pallas_lq.py:468 _lq_kernel, the stage-unrolled
// twin that the Pallas wrapper takes for N < 16 (the quad's N = 10), and
// :485 _lq_kernel_rolled at 13x4 (both evaluate _lq_core). It computes what
// the 7x2 kernel computes: 18 fixed iterations of cone elimination (weight
// capped at 1e6), the backward Riccati sweep with the unrolled 4x4
// Cholesky, the forward rollout, the fraction-to-boundary step at 0.995,
// the 1e-10 floor and the centering.
//
// What bounds it on the H100: at c5 (B=16384, N=10, 18 iterations) the
// Riccati algebra is 29.63 GFLOP by the hand count of
// chip_smoke.py:lq_flops_per_stage_iter, 0.442 ms at 67 TFLOP/s FP32;
// its 189 MB of inputs and outputs would take 0.057 ms at 3.35 TB/s. So the
// bound is the operations.
//
// Design. A team of 16 lanes runs one scenario, 2 teams to a warp, S <= 8
// teams to a block (ops/cuda_lq.py:lq_geometry). The stage's matrices are
// padded to 16 columns (rows and columns 13-15 are padding that no real
// output reads), and lane t = 4 tr + tc owns the 4x4 tile (rows 4tr..,
// columns 4tc..) of every 16x16 product. What the design does about the
// limits of the first 13x4 kernel, which gave lane i row i of each product:
//   1. FMAs per shared load. The stage's products, [P A | P Bm], Bm^T
//      [P A | p | P Bm] and A^T [P A | p] + H_ux^T [K | kf], run as register
//      tiles in outer-product form: per step a lane reads a 16-byte row
//      segment of each operand (P is symmetric, so a column segment of P is
//      a row segment) and does 16 FMAs for 8 floats ([P A | P Bm]: 20 for
//      9), where the first kernel read one float per FMA. A warp's 16-byte
//      load still costs the shared pipe one cycle per 32 floats delivered,
//      so these products remain bound by shared-memory throughput, about
//      470 floats per lane and stage, not by the FP32 rate.
//   2. No shadow lanes. Every lane owns a distinct tile. Column 13 of the
//      padded products carries the stage's vectors: p beside P A, so that
//      Bm^T [P A | p] gives H_ux and the sum of h_u; kf beside K, so that
//      A^T [P A | p] + H_ux^T [K | kf] gives the new P and p in one tile
//      product; the lane of column 13 keeps the kf solve while lane t keeps
//      column t of K. Left redundant, as a small share of a stage: the 4x4
//      Cholesky and both triangular solves in all 16 lanes (about 100 of a
//      lane's ~1,000 instructions a stage; branch-free, so that the A^T
//      [P A | p] product, which needs no gain, fills their latency), and du
//      of the forward rollout in 4 lanes per entry, shared by shuffles.
//   3. Occupancy. Shared memory, 12,608 bytes per scenario at c5
//      (ops/cuda_lq.py:scenario_floats), holds 16 scenarios (8 warps) on an
//      SM; at most 8 teams to a block (128 threads) keep 2 blocks on each
//      SM, whose staggered ends keep it busy (one block of 18 scenarios ran
//      slower). Registers are not the limit (launch bound 128 threads).
//   4. A and Bm. Each sweep streams the stages in order through a double
//      buffer, one stage ahead, with 4-byte cp.async into the 16-column
//      rows (a 13-float row of A is not 16-byte aligned in the inputs); the
//      sweeps re-read them from L2. Keeping all N stages resident (20,928
//      bytes per scenario at N=10, 10 scenarios per SM) ran no faster at
//      its best block size and does not scale to long horizons
//      (PERF.md, experiments/quad_kernels.py).
// Sums keep the order of the first 13x4 kernel and of the plain version:
// every output is one accumulator over ascending l from 0, contracted to
// FMAs as before, and ((Q + w) + A^T PA) + H_ux^T K, (q_k + A^T p) +
// H_ux^T kf; so the kernel gives the first kernel's bits. The symmetric P
// is exchanged between tiles (r, c) and (c, r) by shuffles. The cone
// passes spread their (stage or row, cone) pairs over the lanes; the
// complementarity sum keeps the 7x2 kernel's order (each lane's rows, cone
// by cone, then a fixed tree). A ragged last block runs its missing
// scenarios on a clamped index and stores nothing.

namespace lq_wide {

constexpr int NX = 13, NU = 4;
constexpr int W = 16;      // padded width of a row; also the team's lanes
constexpr int TEAM = 16;
constexpr int RING = 16;   // stages of cone weights computed at once
constexpr int MAX_TEAMS = LQ_MAX_TEAMS;  // 128 threads a block at most
constexpr int SA = NX * W;      // floats of a padded A_k: 13 rows of 16
constexpr int SB = NX * NU;     // floats of Bm_k: 13 rows of 4
constexpr int STAGE = SA + SB;
constexpr int GAIN = NU * W;    // [K_k | kf_k]: kf_k in column PCOL
constexpr int PCOL = NX;        // the padding column that carries vectors

// Block header in floats: Q and QN padded to 16x16, R and the cone list.
__host__ __device__ constexpr int header_floats() {
  return (2 * W * W + NU * NU + 7 * LQ_MAX_CONES + 31) & ~31;
}

// Per-scenario shared layout in floats (ops/cuda_lq.py:scenario_floats
// computes the same total); every part starts on 16 bytes, and the total is
// 16 mod 32 floats, so the 2 teams of a warp sit 16 banks apart.
struct Layout {
  int nst, st, dst, K, cone, cref, qr, tw, tg, tP, tPA, tPBt, tHux, tHuu,
      tqk, tWX, trk, stage, total;
  __host__ __device__ Layout(int N, int nc) {
    nst = align4(W * (N + 1) + NU * N);  // dx (N+1, 16), then du (N, 4)
    st = 0;
    dst = st + nst;                      // ddx, ddu: the Newton step
    K = dst + nst;                       // N gain records [K_k | kf_k]
    cone = K + N * GAIN;                 // [4 (t, lam, sigma, mu)][nc][N]
    cref = cone + align4(4 * nc * N);    // [nc][N]: reference under each cone
    qr = cref + align4(nc * N);          // q (N+1, 13), then r (N, 4)
    const int ring = RING * (nc > 0 ? nc : 1);
    tw = qr + align4(NX * (N + 1) + NU * N);  // cone weights [RING][nc]
    tg = tw + ring;                      // and their gradients
    tP = tg + ring;                      // P (16x16)
    tPA = tP + W * W;                    // [P A | p] (16x16)
    tPBt = tPA + W * W;                  // (P Bm)^T (4x16)
    tHux = tPBt + NU * W;                // [H_ux | Bm^T p] (4x16)
    tHuu = tHux + NU * W;                // H_uu (4x4)
    tqk = tHuu + NU * NU;                // q_k + Q dx_k + gx_k (16)
    tWX = tqk + W;                       // x-cone weights of the stage (16)
    trk = tWX + W;                       // r_k + R du_k + gu_k (4)
    stage = trk + align4(NU);            // two stage buffers (A_k, Bm_k)
    const int raw = stage + 2 * STAGE;
    total = raw + ((16 - raw) % 32 + 32) % 32;
  }
};

__device__ __forceinline__ void f4(float (&d)[4], const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void st4(float* dst, const float (&s)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
}

__global__ void __launch_bounds__(TEAM * MAX_TEAMS, 1)
lq_ipm_wide_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ c, const float* __restrict__ q,
                   const float* __restrict__ r, const float* __restrict__ u_ref,
                   const float* __restrict__ x_ref, const float* __restrict__ Qg,
                   const float* __restrict__ Rg, const float* __restrict__ QNg,
                   float* __restrict__ dx_out, float* __restrict__ du_out,
                   float* __restrict__ alpha_out, int batch, int N, int iters,
                   float reg, float tau_min, const __grid_constant__ LqBounds bd,
                   int teams, int pitch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;  // 16x16, zero outside 13x13
  float* sQN = sQ + W * W;
  float* sR = sQN + W * W;
  LqCone* sc = reinterpret_cast<LqCone*>(sR + NU * NU);
  const int nc = bd.n;
  for (int f = threadIdx.x; f < W * W; f += blockDim.x) {
    const int i = f / W, j = f % W;
    const bool in = i < NX && j < NX;
    sQ[f] = in ? Qg[i * NX + j] : 0.0f;
    sQN[f] = in ? QNg[i * NX + j] : 0.0f;
  }
  for (int f = threadIdx.x; f < NU * NU; f += blockDim.x) sR[f] = Rg[f];
  for (int e = threadIdx.x; e < nc; e += blockDim.x) sc[e] = bd.e[e];
  __syncthreads();

  const int team = threadIdx.x / TEAM;
  const int t = threadIdx.x % TEAM;   // lane in the team
  const int tr = t >> 2, tc = t & 3;  // its tile: rows 4tr.., columns 4tc..
  const bool row_lane = t < NX;       // owns state row t where a pass is by rows
  const bool diag = tr == tc;         // its tile holds diagonal entries
  const long long bl = (long long)blockIdx.x * teams + team;
  const bool valid = bl < batch;
  const size_t b = (size_t)(valid ? bl : batch - 1);
  const int wbase = threadIdx.x & ~31;
  const int wn = min(32, (int)blockDim.x - wbase);
  const unsigned wmask = wn == 32 ? 0xffffffffu : ((1u << wn) - 1u);

  const Layout L(N, nc);
  float* base = smem + header_floats() + (size_t)team * pitch;
  float* DX = base + L.st;  // [k * W + j]
  float* DU = DX + W * (N + 1);
  float* DDX = base + L.dst;
  float* DDU = DDX + W * (N + 1);
  const int nvar = W * (N + 1) + NU * N;  // the iterate's floats, padding included
  // Gains of stage k: K_k[a][j] at gain(k)[a * W + j], kf_k[a] at column PCOL.
  auto gain = [&](int k) { return base + L.K + k * GAIN; };
  float* CN = base + L.cone;
  float* CR = base + L.cref;
  float* sq = base + L.qr;         // q [N+1][13]
  float* sr = sq + NX * (N + 1);   // r [N][4]
  float* tw = base + L.tw;  // ring of RING stages' cone weights [slot][nc]
  float* tg = base + L.tg;  // and gradients
  float* tP = base + L.tP;
  float* tPA = base + L.tPA;
  float* tPBt = base + L.tPBt;
  float* tHux = base + L.tHux;
  float* tHuu = base + L.tHuu;
  float* tqk = base + L.tqk;
  float* tWX = base + L.tWX;
  float* trk = base + L.trk;
  auto stA = [&](int k) { return base + L.stage + (k & 1) * STAGE; };
  auto cn = [&](int var, int e, int k) -> float& {
    return CN[(var * nc + e) * N + k];
  };
  // Row k of cone e is entry j of x at stage k+1 or of u at stage k, at
  // offset under(ce) + k * stride(ce) of the iterate and of the step.
  auto under = [&](const LqCone& ce) {
    return ce.is_x ? W + ce.j : W * (N + 1) + ce.j;
  };
  auto stride = [&](const LqCone& ce) { return ce.is_x ? W : NU; };
  auto value = [&](const LqCone& ce, int e, int k) -> float {
    return CR[e * N + k] + DX[under(ce) + k * stride(ce)];
  };

  // fetch(k) queues stage k's A_k (into rows of 16) and Bm_k into its buffer.
  const float* Ab = A + b * N * NX * NX;
  const float* Bb = Bm + b * N * NX * NU;
  auto fetch = [&](int k) {
    float* d = stA(k);
    const float* Ak = Ab + (size_t)k * NX * NX;
    const float* Bk = Bb + (size_t)k * NX * NU;
    if (row_lane) {
#pragma unroll
      for (int l = 0; l < NX; ++l) cp_async4(d + l * W + t, Ak + l * NX + t);
    }
#pragma unroll
    for (int f = 0; f < SB; f += TEAM)
      if (f + t < SB) cp_async4(d + SA + f + t, Bk + f + t);
    cp_async_commit();
  };

  // The iterate and the step start at 0 (their padding stays 0); the
  // padding columns of the stage buffers are 0; q and r stay resident.
  for (int f = t; f < 2 * L.nst; f += TEAM) base[L.st + f] = 0.0f;
  if (!row_lane) {
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      stA(0)[l * W + t] = 0.0f;
      stA(1)[l * W + t] = 0.0f;
    }
  }
  {
    const float* qb = q + b * (N + 1) * NX;
    const float* rb = r + b * N * NU;
    for (int f = t; f < NX * (N + 1); f += TEAM) sq[f] = qb[f];
    for (int f = t; f < NU * N; f += TEAM) sr[f] = rb[f];
  }

  // The lower and upper cone over state entry t and over input entry t & 3
  // (-1: none). The cone list has at most one of each, lower first.
  int xlo = -1, xhi = -1, ulo = -1, uhi = -1;
  int count = 0;
  for (int e = 0; e < nc; ++e) {
    const LqCone ce = sc[e];
    count += 1 + (ce.soft ? 1 : 0);
    if (ce.is_x && ce.j == t) {
      if (ce.lo) xlo = e; else xhi = e;
    }
    if (!ce.is_x && ce.j == (t & 3)) {
      if (ce.lo) ulo = e; else uhi = e;
    }
  }
  count *= N;

  for (int f = t; f < nc * N; f += TEAM) {
    const int e = f / N, k = f - e * N;
    const LqCone ce = sc[e];
    CR[f] = ce.is_x ? x_ref[(b * (N + 1) + k + 1) * NX + ce.j]
                    : u_ref[(b * N + k) * NU + ce.j];
  }

  // Initial primal iterate: du = 0, dx = defect propagation (feasible).
  fetch(0);
  const float* cb = c + b * N * NX;
  for (int k = 0; k < N; ++k) {
    if (k + 1 < N) {
      fetch(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp(wmask);
    float xn = 0.0f;
    if (row_lane) {
      float x[NX], a[NX];
      load_vec(x, DX + k * W);
      load_vec(a, stA(k) + t * W);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += a[j] * x[j];
      xn = acc + cb[k * NX + t];
    }
    __syncwarp(wmask);
    if (row_lane) DX[(k + 1) * W + t] = xn;
  }
  __syncwarp(wmask);

  const float t0 = 0.1f, lam0 = 0.1f;
  for (int f = t; f < nc * N; f += TEAM) {
    const int e = f / N, k = f - e * N;
    const LqCone ce = sc[e];
    const float v = value(ce, e, k);
    const float gap = ce.lo ? (v - ce.b) : (ce.b - v);
    float tt, sig, mu;
    if (ce.soft) {
      sig = fmaxf(t0 - gap, t0);
      tt = gap + sig;
      mu = lam0;
    } else {
      sig = 1.0f;
      tt = fmaxf(gap, t0);
      mu = 1.0f;
    }
    cn(0, e, k) = tt;
    cn(1, e, k) = lam0;
    cn(2, e, k) = sig;
    cn(3, e, k) = mu;
  }
  __syncwarp(wmask);

  float tau = 0.1f;
  float alpha = 1.0f;

  // (a) Cone weights and gradients of the stages s0 down to
  // max(s0 - RING + 1, 0), (stage, cone) pairs spread over the lanes,
  // consecutive lanes on consecutive stages of one cone (so the branches on a
  // cone's kind rarely diverge). Stage ks goes to ring slot (N - ks) % RING;
  // it holds the x cones at row ks-1 and the u cones at row ks.
  auto cone_weights = [&](int s0) {
    const int S = min(s0 + 1, RING);
    for (int f = t; f < S * nc; f += TEAM) {
      const int e = f / S, ks = s0 - (f - e * S);
      const LqCone ce = sc[e];
      const int row = ce.is_x ? ks - 1 : ks;
      if (row < 0 || row >= N) continue;
      const int slot = (N - ks) & (RING - 1);
      const float lam = cn(1, e, row), v = value(ce, e, row);
      const ConeTerms o =
          ce.soft ? cone_terms<true>(ce, v, cn(0, e, row), lam, cn(2, e, row),
                                     cn(3, e, row), tau)
                  : cone_terms<false>(ce, v, cn(0, e, row), lam, 1.0f, 1.0f, tau);
      tw[slot * nc + e] = o.w;
      tg[slot * nc + e] = (ce.lo ? -1.0f : 1.0f) * (lam + o.g);
    }
  };
  // Weight and gradient of one entry at a ring slot: 0 + lower + upper, the
  // order in which the cone list adds them.
  auto stage_weight = [&](int slot, int lo, int hi, float& w, float& g) {
    const float* ws = tw + slot * nc;
    const float* gs = tg + slot * nc;
    const float wl = ws[max(lo, 0)], gl = gs[max(lo, 0)];
    const float wh = ws[max(hi, 0)], gh = gs[max(hi, 0)];
    w = (0.0f + (lo >= 0 ? wl : 0.0f)) + (hi >= 0 ? wh : 0.0f);
    g = (0.0f + (lo >= 0 ? gl : 0.0f)) + (hi >= 0 ? gh : 0.0f);
  };
  // Entry `row` of Qm dx_k + q_k + gx: the lanes past row 12 compute row 12
  // and store nothing, so that the pass has no branch.
  const int row = min(t, NX - 1);
  auto linear_x = [&](const float* Qm, int k, float gx) {
    float x[NX], qrow[NX];
    load_vec(x, DX + k * W);
    load_vec(qrow, Qm + row * W);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) acc += qrow[j] * x[j];
    return acc + sq[k * NX + row] + gx;
  };

  for (int it = 0; it < iters; ++it) {
    // (a)+(b) Backward Riccati sweep with the cone-modified cost. The
    // terminal stage carries x-cone row N-1 (stage N).
    fetch(N - 1);
    cone_weights(N);
    __syncwarp(wmask);
    {
      float wx, gx;
      stage_weight(0, xlo, xhi, wx, gx);
      const float pn = linear_x(sQN, N, gx);
      tWX[t] = wx;
      tqk[t] = row_lane ? pn : 0.0f;
    }
    __syncwarp(wmask);
    // P = QN + diag(wx_N), tile by tile; p (column PCOL) stays with the
    // lanes of tile column 3, 4 rows each.
    float pv[4];
    {
      float wxr[4];
      f4(wxr, tWX + 4 * tr);
      f4(pv, tqk + 4 * tr);
#pragma unroll
      for (int rho = 0; rho < 4; ++rho) {
        float o[4];
        f4(o, sQN + (4 * tr + rho) * W + 4 * tc);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          o[g] = o[g] + ((diag && rho == g) ? wxr[rho] : 0.0f);
        st4(tP + (4 * tr + rho) * W + 4 * tc, o);
      }
    }
    for (int k = N - 1; k >= 0; --k) {
      if (k > 0) {
        fetch(k - 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if ((N - k) % RING == 0) cone_weights(k);
      __syncwarp(wmask);
      const float* Ak = stA(k);
      const float* Bk = Ak + SA;
      const int slot = (N - k) & (RING - 1);

      // (1) The stage's weights and linear terms (x cones at stage k, none
      // at stage 0, for row t; u cones for input entry t & 3), then the
      // tile of P A and the column segment of P Bm (column tc). P is
      // symmetric: P[4tr.., l] is read as row l. Nothing here branches, so
      // the short chains interleave with the tile's FMAs.
      float wu;  // weight of input entry t & 3
      {
        float wx, gx, gu;
        stage_weight(slot, k > 0 ? xlo : -1, k > 0 ? xhi : -1, wx, gx);
        stage_weight(slot, ulo, uhi, wu, gu);
        const float qk = linear_x(sQ, k, gx);
        const int a = t & 3;
        float sr_a = 0.0f;
#pragma unroll
        for (int j = 0; j < NU; ++j) sr_a += sR[a * NU + j] * DU[k * NU + j];
        const float rk = sr_a + sr[k * NU + a] + gu;

        float pa[4][4], pb[4];
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) {
          pb[rho] = 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g) pa[rho][g] = 0.0f;
        }
#pragma unroll
        for (int l = 0; l < NX; ++l) {
          float pr[4], ar[4];
          f4(pr, tP + l * W + 4 * tr);
          f4(ar, Ak + l * W + 4 * tc);
          const float bl = Bk[l * NU + tc];
#pragma unroll
          for (int rho = 0; rho < 4; ++rho) {
#pragma unroll
            for (int g = 0; g < 4; ++g) pa[rho][g] += pr[rho] * ar[g];
            pb[rho] += pr[rho] * bl;
          }
        }
        if (tc == 3) {
#pragma unroll
          for (int rho = 0; rho < 4; ++rho) pa[rho][PCOL - 12] = pv[rho];
        }
#pragma unroll
        for (int rho = 0; rho < 4; ++rho)
          st4(tPA + (4 * tr + rho) * W + 4 * tc, pa[rho]);
        st4(tPBt + tc * W + 4 * tr, pb);
        tqk[t] = row_lane ? qk : 0.0f;
        tWX[t] = wx;
        if (t < NU) trk[t] = rk;
      }
      __syncwarp(wmask);

      // (2) Column t of [H_ux | Bm^T p] (column PCOL: the sum of h_u) and
      // entry (t/4, t%4) of H_uu.
      float hx[NU];
      {
        const int ha = t >> 2, hd = t & 3;
        float hh = 0.0f;
#pragma unroll
        for (int a = 0; a < NU; ++a) hx[a] = 0.0f;
#pragma unroll
        for (int l = 0; l < NX; ++l) {
          float br[4];
          f4(br, Bk + l * NU);
          const float pal = tPA[l * W + t];
          const float pbl = tPBt[hd * W + l];
#pragma unroll
          for (int a = 0; a < NU; ++a) hx[a] += br[a] * pal;
          const float ba = ha == 0 ? br[0] : ha == 1 ? br[1] : ha == 2 ? br[2] : br[3];
          hh += ba * pbl;
        }
        // The diagonal entry (a, a) lies with lane 5a, whose input entry
        // t & 3 is a.
        const float rreg = sR[ha * NU + hd] + (ha == hd ? reg : 0.0f);
        tHuu[t] = (rreg + (ha == hd ? wu : 0.0f)) + hh;
#pragma unroll
        for (int a = 0; a < NU; ++a) tHux[a * W + t] = hx[a];
      }
      __syncwarp(wmask);

      // (3) Unrolled Cholesky H_uu = Lc Lc^T (pallas_lq.py:chol_factor), in
      // every lane; lane t solves for column t of K = -H_uu^{-1} H_ux
      // (chol_solve), the lane of column PCOL for kf = -H_uu^{-1} h_u
      // (chol_solve_vec divides instead of multiplying by the inverse): each
      // lane runs both solves and keeps its own, so that the pass has no
      // branch and the product A^T [P A | p], which needs no gain, fills the
      // chain's latency.
      float* gk = gain(k);
      float a1[4][4];
      {
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) {
#pragma unroll
          for (int g = 0; g < 4; ++g) a1[rho][g] = 0.0f;
        }
#pragma unroll
        for (int l = 0; l < NX; ++l) {
          float ar[4], pr[4];
          f4(ar, Ak + l * W + 4 * tr);
          f4(pr, tPA + l * W + 4 * tc);
#pragma unroll
          for (int rho = 0; rho < 4; ++rho) {
#pragma unroll
            for (int g = 0; g < 4; ++g) a1[rho][g] += ar[rho] * pr[g];
          }
        }
        float Huu[NU][NU], Lc[NU][NU];
#pragma unroll
        for (int a = 0; a < NU; ++a) f4(Huu[a], tHuu + a * NU);
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          float sd = Huu[a][a];
#pragma unroll
          for (int m = 0; m < a; ++m) sd = sd - Lc[a][m] * Lc[a][m];
          Lc[a][a] = fsqrt(sd);
          const float inv = fdiv(1.0f, Lc[a][a]);
#pragma unroll
          for (int d = a + 1; d < NU; ++d) {
            float so = Huu[d][a];
#pragma unroll
            for (int m = 0; m < a; ++m) so = so - Lc[d][m] * Lc[a][m];
            Lc[d][a] = so * inv;
          }
        }
        float Y[NU], Kc[NU], y[NU], kf[NU];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          const float inv = fdiv(1.0f, Lc[a][a]);
          float sm = hx[a];
#pragma unroll
          for (int m = 0; m < a; ++m) sm = sm - Lc[a][m] * Y[m];
          Y[a] = sm * inv;
          float sv = trk[a] + hx[a];  // h_u, in the lane of column PCOL
#pragma unroll
          for (int m = 0; m < a; ++m) sv = sv - Lc[a][m] * y[m];
          y[a] = fdiv(sv, Lc[a][a]);
        }
#pragma unroll
        for (int a = NU - 1; a >= 0; --a) {
          const float inv = fdiv(1.0f, Lc[a][a]);
          float sm = Y[a];
#pragma unroll
          for (int m = a + 1; m < NU; ++m) sm = sm - Lc[m][a] * Kc[m];
          Kc[a] = sm * inv;
          float sv = y[a];
#pragma unroll
          for (int m = a + 1; m < NU; ++m) sv = sv - Lc[m][a] * kf[m];
          kf[a] = fdiv(sv, Lc[a][a]);
        }
#pragma unroll
        for (int a = 0; a < NU; ++a) gk[a * W + t] = t == PCOL ? -kf[a] : -Kc[a];
      }
      __syncwarp(wmask);

      // (4) The tile of [P | p] <- [Q + diag(wx_k) | q_k + Q dx_k + gx_k]
      // + A^T [P A | p] + H_ux^T [K | kf].
      float Pn[4][4];
      {
        float a2[4][4];
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) {
#pragma unroll
          for (int g = 0; g < 4; ++g) a2[rho][g] = 0.0f;
        }
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          float hr[4], kr[4];
          f4(hr, tHux + a * W + 4 * tr);
          f4(kr, gk + a * W + 4 * tc);
#pragma unroll
          for (int rho = 0; rho < 4; ++rho) {
#pragma unroll
            for (int g = 0; g < 4; ++g) a2[rho][g] += hr[rho] * kr[g];
          }
        }
        float wxr[4], qkr[4];
        f4(wxr, tWX + 4 * tr);
        f4(qkr, tqk + 4 * tr);
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) {
          float qrow[4];
          f4(qrow, sQ + (4 * tr + rho) * W + 4 * tc);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float base_v = qrow[g] + ((diag && rho == g) ? wxr[rho] : 0.0f);
            if (tc == 3 && g == PCOL - 12) base_v = qkr[rho];
            Pn[rho][g] = base_v + a1[rho][g] + a2[rho][g];
          }
        }
      }
      // (5) p of the next stage stays with its lanes; P is symmetrised with
      // the transposed tile, shuffled from lane (tc, tr).
      if (tc == 3) {
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) pv[rho] = Pn[rho][PCOL - 12];
      }
      {
        const int partner = tc * 4 + tr;
        float T[4][4];
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            T[g][rho] = __shfl_sync(wmask, Pn[rho][g], partner, TEAM);
        }
#pragma unroll
        for (int rho = 0; rho < 4; ++rho) {
          float o[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            o[g] = (diag && rho == g) ? Pn[rho][g] : 0.5f * (Pn[rho][g] + T[rho][g]);
          st4(tP + (4 * tr + rho) * W + 4 * tc, o);
        }
      }
      __syncwarp(wmask);
    }

    // (c) Forward rollout of the affine policy (homogeneous dynamics): lane
    // t computes du for input entry t & 3 (4 lanes each) and shares it by
    // shuffles, then row t of the state (lanes 13-15 compute row 12 and
    // store nothing).
    fetch(0);
    DDX[t] = 0.0f;
    for (int k = 0; k < N; ++k) {
      if (k + 1 < N) {
        fetch(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp(wmask);
      const float* Ak = stA(k);
      float x[NX], du[NU];
      load_vec(x, DDX + k * W);
      {
        float g[W];
        load_vec(g, gain(k) + (t & 3) * W);
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += g[j] * x[j];
        const float mine = acc + g[PCOL];
#pragma unroll
        for (int a = 0; a < NU; ++a) du[a] = __shfl_sync(wmask, mine, a, TEAM);
      }
      float ar[NX], br[NU];
      load_vec(ar, Ak + row * W);
      f4(br, Ak + SA + row * NU);
      float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) a1 += ar[j] * x[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) a2 += br[j] * du[j];
      if (row_lane) DDX[(k + 1) * W + t] = a1 + a2;
      if (t == TEAM - 1) {
#pragma unroll
        for (int a = 0; a < NU; ++a) DDU[k * NU + a] = du[a];
      }
      __syncwarp(wmask);
    }

    // (d) Cone Newton step and fraction-to-boundary, (row, cone) pairs
    // spread over the lanes as in (a).
    float amin = INFINITY;
    auto step_ratios = [&](auto soft, const LqCone& ce, int e, int k) {
      constexpr bool SOFT = decltype(soft)::value;
      const int u = under(ce) + k * stride(ce);
      const float tt = cn(0, e, k), lam = cn(1, e, k);
      const float sig = SOFT ? cn(2, e, k) : 1.0f, mu = SOFT ? cn(3, e, k) : 1.0f;
      const ConeTerms o = cone_terms<SOFT>(ce, CR[e * N + k] + DX[u], tt, lam,
                                           sig, mu, tau);
      float d[4];
      cone_step<SOFT>(ce, o, tt, sig, mu, DDX[u], d);
      amin = fminf(amin, fminf(fminf(ratio(tt, d[0]), ratio(lam, d[1])),
                               fminf(ratio(sig, d[2]), ratio(mu, d[3]))));
    };
    for (int f = t; f < nc * N; f += TEAM) {
      const int e = f / N, k = f - e * N;
      const LqCone ce = sc[e];
      if (ce.soft) step_ratios(Soft<true>(), ce, e, k);
      else step_ratios(Soft<false>(), ce, e, k);
    }
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1)
      amin = fminf(amin, __shfl_xor_sync(wmask, amin, o, TEAM));
    alpha = fminf(1.0f, 0.995f * amin);

    // (e) Step, positivity floor, centering. The cone steps are recomputed
    // from ddx/ddu at the old iterate, so the cones go before dx and du.
    // The complementarity sum runs over rows t, t+TEAM, ... of each cone in
    // turn, then over the lanes in a fixed tree, so every lane gets the
    // same bits (and those of the 7x2 kernel's order).
    const float floor_v = 1e-10f;
    auto step_cones = [&](auto soft, const LqCone& ce, int e, int k) {
      constexpr bool SOFT = decltype(soft)::value;
      const int u = under(ce) + k * stride(ce);
      float v4[4];
#pragma unroll
      for (int var = 0; var < 4; ++var) v4[var] = cn(var, e, k);
      const ConeTerms o = cone_terms<SOFT>(ce, CR[e * N + k] + DX[u], v4[0],
                                           v4[1], v4[2], v4[3], tau);
      float d[4];
      cone_step<SOFT>(ce, o, v4[0], v4[2], v4[3], DDX[u], d);
#pragma unroll
      for (int var = 0; var < 4; ++var)
        cn(var, e, k) = fmaxf(v4[var] + alpha * d[var], floor_v);
    };
    for (int f = t; f < nc * N; f += TEAM) {
      const int e = f / N, k = f - e * N;
      const LqCone ce = sc[e];
      if (ce.soft) step_cones(Soft<true>(), ce, e, k);
      else step_cones(Soft<false>(), ce, e, k);
    }
    __syncwarp(wmask);
    float comp = 0.0f;
    for (int e = 0; e < nc; ++e) {
      const bool soft = sc[e].soft;
      for (int k = t; k < N; k += TEAM) {
        comp += cn(0, e, k) * cn(1, e, k);
        if (soft) comp += cn(2, e, k) * cn(3, e, k);
      }
    }
    for (int f = t; f < nvar; f += TEAM) DX[f] = DX[f] + alpha * DDX[f];
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1)
      comp += __shfl_down_sync(wmask, comp, o, TEAM);
    comp = __shfl_sync(wmask, comp, 0, TEAM);
    tau = fmaxf(0.1f * comp / (float)(count > 0 ? count : 1), tau_min);
    __syncwarp(wmask);
  }

  if (valid) {
    float* dxo = dx_out + b * (N + 1) * NX;
    float* duo = du_out + b * N * NU;
    for (int f = t; f < (N + 1) * NX; f += TEAM) {
      const int k = f / NX;
      dxo[f] = DX[k * W + (f - k * NX)];
    }
    for (int f = t; f < N * NU; f += TEAM) duo[f] = DU[f];
    if (t == 0) alpha_out[b] = alpha;
  }
}

}  // namespace lq_wide
