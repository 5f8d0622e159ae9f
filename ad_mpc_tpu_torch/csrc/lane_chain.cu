// Chained batched small-matrix product X <- A @ X, batch on lanes, for
// Hopper (sm_90a).
//
// Replaces: ad_mpc_tpu/experiments/mxu_riccati.py:135 `kernel` (built by
// `lane_chain_build`, :149). It applies one fixed nx x nx matrix A_b CHAIN
// times to X_b for every scenario b, with the entries unrolled: the
// stage-algebra shape of the Riccati recursion, as the MXU-vs-VPU micro
// measures it. The layout is the Pallas kernel's: a and x are (nx*nx, batch)
// float32, entry-major and batch-innermost, so neighbouring threads read and
// write neighbouring addresses.
//
// What bounds it on the H100: at the micro's shape (batch 16384, nx 7,
// chain 12) it reads a and x and writes o once, 3 * 16384 * 49 * 4 B =
// 9.63 MB (2.87 us at 3.35 TB/s), and does 2 * 16384 * 343 * 12 = 134.9
// MFLOP (2.01 us at 67 TFLOP/s FP32): bound by bytes, near the ridge.
//
// Design (simple and right first): one thread per scenario holds A, X and
// the new X in registers (3 * 49 = 147 floats) through the whole chain, so
// the only memory traffic is the one read of a and x and the one write of
// o, all coalesced. Each new entry accumulates in the Pallas body's order:
// acc = a[i*nx] * x[k], then acc += a[i*nx+j] * x[j*nx+k] for j = 1..nx-1
// (nvcc contracts each step to one fused multiply-add). Any batch works;
// the tail block is guarded. No tensor cores: the micro compares this
// layout with tensor-core batched products through its torch.bmm arms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ad_mpc_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>

template <int NX, int CHAIN>
__global__ void __launch_bounds__(128)
lane_chain_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ o, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t stride = (size_t)batch;
  float A[NX * NX], X[NX * NX];
#pragma unroll
  for (int e = 0; e < NX * NX; ++e) {
    A[e] = a[e * stride + b];
    X[e] = x[e * stride + b];
  }
#pragma unroll
  for (int link = 0; link < CHAIN; ++link) {
    float Y[NX * NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        float acc = A[i * NX] * X[k];
#pragma unroll
        for (int j = 1; j < NX; ++j) acc += A[i * NX + j] * X[j * NX + k];
        Y[i * NX + k] = acc;
      }
    }
#pragma unroll
    for (int e = 0; e < NX * NX; ++e) X[e] = Y[e];
  }
#pragma unroll
  for (int e = 0; e < NX * NX; ++e) o[e * stride + b] = X[e];
}

extern "C" {

// a, x, o: (nx*nx, batch) float32, batch-innermost. Compiled for nx = 7,
// chain = 12 only. Returns a cudaError_t.
int lane_chain(const float* a, const float* x, float* o, int batch, int nx,
               int chain, void* stream) {
  if (batch < 0 || nx != 7 || chain != 12) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const int block = 128;
  const unsigned grid = (unsigned)((batch + block - 1) / block);
  lane_chain_kernel<7, 12><<<grid, block, 0, (cudaStream_t)stream>>>(
      a, x, o, batch);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
