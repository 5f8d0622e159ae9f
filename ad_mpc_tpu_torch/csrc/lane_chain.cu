// Chained batched small-matrix product X <- A @ X, batch on lanes, for
// Hopper (sm_90a).
//
// Replaces: ad_mpc_tpu/experiments/mxu_riccati.py:135 `kernel` (built by
// `lane_chain_build`, :149). It applies one fixed nx x nx matrix A_b CHAIN
// times to X_b for every scenario b, with the entries unrolled: the
// stage-algebra shape of the Riccati recursion, as the MXU-vs-VPU micro
// measures it. The layout is the Pallas kernel's: a and x are (nx*nx, batch)
// float32, entry-major and batch-innermost, so neighbouring lanes read and
// write neighbouring addresses.
//
// What bounds it on the H100: at the micro's shape (batch 16384, nx 7,
// chain 12) it reads a and x and writes o once, 3 * 16384 * 49 * 4 B =
// 9.63 MB (2.87 us at 3.35 TB/s), and does 2 * 16384 * 343 * 12 = 134.9
// MFLOP (2.01 us at 67 TFLOP/s FP32): bound by bytes, near the ridge.
//
// What held the first design back: one thread per scenario in blocks of 128
// left one warp per SM sub-partition. A single warp issues its 4,096
// instructions (3,860 FMAs and multiplies in dependent chains) at about 0.3
// per cycle: fed from registers it still took 7.1 us of its 8.1, and with
// its stores cut 7.8. It was bound by issue latency, not by its bytes.
//
// Design: split each scenario by column. Column k of A @ X needs only A
// and column k of X, so warp k of a block carries column k of 32 scenarios
// (one per lane) through all CHAIN links with no exchange between warps.
// A block is NX warps (224 threads); the grid is one block per 32
// scenarios (512 at batch 16384). A thread holds A (49 floats), its column
// and the new column: 72 registers, no spill, so 4 blocks (28 warps) are
// resident per SM and the whole grid runs in one wave on all 132 SMs. A is
// read by all NX warps straight from global memory (the L1 and L2 catch the
// repeats; a shared tile and a barrier measured slower with the inputs in
// L2). X is read and o written once, in coalesced 128-byte rows. Lanes past
// the batch read the last scenario and store nothing. Each entry
// accumulates in the Pallas body's order, acc = a[i*nx] * x[k], then
// acc += a[i*nx+j] * x[j*nx+k] for j = 1..nx-1, contracted by nvcc exactly
// as in the first design: the results keep its bits.
//
// Measured (torch.profiler device time at the micro's shape, inputs in L2,
// H100 80GB HBM3 at 700 W): 0.0046 ms against the first design's 0.0078 ms
// in the same run, 63% of the bound. An empty kernel on the same grid takes
// 1.15 us; fed from registers, the products and stores take 3.9 us (672
// instructions per warp, 588 of them FMAs and multiplies, at about 0.8 per
// cycle per sub-partition); the loads add 0.7 us on top. Two scenarios per
// thread, blocks of 14 warps, and double-buffered cp.async tiles with 2-4
// tiles per block were all slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ad_mpc_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>

// The compiled instance and its launch geometry, mirrored by
// ops/cuda_chain.py (NX, CHAIN, LANES, chain_geometry).
constexpr int LC_NX = 7;
constexpr int LC_CHAIN = 12;
constexpr int LC_LANES = 32;                 // scenarios per block
constexpr int LC_THREADS = LC_NX * LC_LANES;  // a warp per column
constexpr int LC_MIN_BLOCKS = 4;             // caps registers at 72

template <int NX, int CHAIN>
__global__ void __launch_bounds__(NX * LC_LANES, LC_MIN_BLOCKS)
lane_chain_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ o, int batch) {
  const int k = threadIdx.x / LC_LANES, lane = threadIdx.x % LC_LANES;
  const int tiles = (batch + LC_LANES - 1) / LC_LANES;
  const size_t stride = (size_t)batch;
  // The launch gives each block one tile, but the straight-line form of
  // this body spilled 4 bytes at the 72-register cap and the loop none.
#pragma unroll 1
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t * LC_LANES + lane;
    const int src = b < batch ? b : batch - 1;
    float A[NX * NX], X[NX];
#pragma unroll
    for (int e = 0; e < NX * NX; ++e) A[e] = __ldg(a + e * stride + src);
#pragma unroll
    for (int j = 0; j < NX; ++j) X[j] = __ldg(x + (j * NX + k) * stride + src);
#pragma unroll
    for (int link = 0; link < CHAIN; ++link) {
      float Y[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = A[i * NX] * X[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) acc += A[i * NX + j] * X[j];
        Y[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) X[i] = Y[i];
    }
    if (b < batch) {
#pragma unroll
      for (int i = 0; i < NX; ++i) o[(i * NX + k) * stride + b] = X[i];
    }
  }
}

extern "C" {

// Blocks resident on one SM at once (cudaOccupancy...), or minus a
// cudaError_t. Compiled for nx = 7, chain = 12 only.
int lane_chain_occupancy(int nx, int chain) {
  if (nx != LC_NX || chain != LC_CHAIN) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, lane_chain_kernel<LC_NX, LC_CHAIN>, LC_THREADS, 0);
  return err ? -err : blocks;
}

// a, x, o: (nx*nx, batch) float32, batch-innermost. One block of LC_THREADS
// threads per LC_LANES scenarios. Returns a cudaError_t.
int lane_chain(const float* a, const float* x, float* o, int batch, int nx,
               int chain, void* stream) {
  if (batch < 0 || nx != LC_NX || chain != LC_CHAIN)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((batch + LC_LANES - 1) / LC_LANES);
  lane_chain_kernel<LC_NX, LC_CHAIN><<<grid, LC_THREADS, 0,
                                       (cudaStream_t)stream>>>(a, x, o, batch);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
