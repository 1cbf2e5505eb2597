// fused_matmul_bn_wgrad: the weight gradient of fused_matmul_bn,
//   u    = [relu](x * ps + pb)          f32, rounded to dy's type
//                                       (recomputed, never stored)
//   ytot = dy + dssum + 2 * y * dssq    f32, rounded to u's type
//   dW   = u^T @ ytot                   f32 over all M, rounded once
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/fused_matmul.py
// `_wgrad_kernel` (launched by `_wgrad_pallas` from `_fused_bwd`).  In
// ResNet-50 training it runs once per fused_matmul_bn call of the
// forward (36 per step).
//
// What bounds it on an H100: 2*M*K*N operations over
// 2*(M*K + 2*M*N) + 4*K*N bytes is 21-270 ops per byte at ResNet-50's
// shapes, below the card's ~295 ops/byte ridge: bound by memory.  The
// TPU kernel walks M as its sequential inner grid axis and keeps the dW
// block in VMEM.  dW here has few output tiles (K = 64, N = 256 gives
// four 128x64 tiles) and the reduction over M is long (100,352 rows at
// batch 32), so one block per tile would leave most of the 132 SMs
// idle.  The M reduction is therefore split over gridDim.z slices of
// `chunk` rows: each slice writes a partial f32 dW into caller-allocated
// scratch, and wgrad_reduce_kernel sums the slices in a fixed order and
// rounds to the weight type.  Deterministic, no atomics.
//
// Both operands are row-major in M.  The x tile is loaded along K,
// passed through the prologue, rounded, and stored transposed into
// shared memory (As[k][m]); the dy/y tile becomes ytot, is rounded and
// stored as the forward's B tile (Bs[n][m]).  The product then runs on
// the forward's fragment code (fused_gemm_bn.cuh): 128x64 tiles,
// mma.sync, not pipelined.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_dgrad_bn.cuh"

namespace {

using fgbn::BK;
using fgbn::BM;
using fgbn::BN;
using fgbn::LDS;
using fgbn::THREADS;

// A tile: 128 rows of dW (K) x 32 reduction rows (M) = 512 vectors of 8
// along K, two per thread, stored transposed.
template <typename T>
__device__ __forceinline__ void load_u_tile(T* As, const T* __restrict__ x,
                                            const float* __restrict__ ps,
                                            const float* __restrict__ pb,
                                            int k0, int mr0, int m_hi, int K,
                                            int prologue, int relu) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int mr = v >> 4;
    const int kv = (v & 15) * 8;
    const int m = mr0 + mr, k = k0 + kv;
    float f[8];
    if (m < m_hi && k < K) {
      fgbn::load8(x + static_cast<size_t>(m) * K + k, f);
      if (prologue) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float u = __fadd_rn(__fmul_rn(f[j], ps[k + j]), pb[k + j]);
          f[j] = relu ? fmaxf(u, 0.0f) : u;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) fgbn::cvt(f[j], As[(kv + j) * LDS + mr]);
  }
}

// B tile: 32 reduction rows (M) x 64 columns (N) of ytot, one vector of
// 8 per thread, stored transposed (Bs[n][m]) as the forward's B tile.
template <typename T>
__device__ __forceinline__ void load_ytot_tile(
    T* Bs, const T* __restrict__ dy, const T* __restrict__ y,
    const float* __restrict__ dss, const float* __restrict__ dsq, int mr0,
    int n0, int m_hi, int N) {
  const int v = threadIdx.x;
  const int mr = v >> 3;
  const int nv = (v & 7) * 8;
  const int m = mr0 + mr, n = n0 + nv;
  float f[8];
  if (m < m_hi && n < N) {
    const size_t o = static_cast<size_t>(m) * N + n;
    fgbn::ytot8(dy + o, y + o, dss, dsq, n, f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) fgbn::cvt(f[j], Bs[(nv + j) * LDS + mr]);
}

// Block (kx, ny, z): dW rows [kx*128, +128), columns [ny*64, +64), from
// the M rows [z*chunk, min((z+1)*chunk, M)); writes part[z] (K, N) f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    wgrad_kernel(const T* __restrict__ x, const float* __restrict__ ps,
                 const float* __restrict__ pb, const T* __restrict__ dy,
                 const T* __restrict__ y, const float* __restrict__ dss,
                 const float* __restrict__ dsq, float* __restrict__ part,
                 int M, int K, int N, int chunk, int prologue, int relu) {
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];

  const int k0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int m_lo = blockIdx.z * chunk;
  const int m_hi = min(m_lo + chunk, M);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  for (int mr0 = m_lo; mr0 < m_hi; mr0 += BK) {
    load_u_tile<T>(As, x, ps, pb, k0, mr0, m_hi, K, prologue, relu);
    load_ytot_tile<T>(Bs, dy, y, dss, dsq, mr0, n0, m_hi, N);
    __syncthreads();
    fgbn::compute_tile<T>(As, Bs, acc, warp_m, warp_n, lane);
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(blockIdx.z) * K * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r0 = k0 + warp_m * 32 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + warp_n * 32 + ni * 8 + t * 2;
      if (c < N) {  // N % 8 == 0, so c + 1 < N as well
        if (r0 < K)
          fgbn::store2(out + static_cast<size_t>(r0) * N + c, acc[mi][ni][0],
                       acc[mi][ni][1]);
        if (r0 + 8 < K)
          fgbn::store2(out + static_cast<size_t>(r0 + 8) * N + c,
                       acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

// dW[i] = sum over slices z = 0, 1, ... of part[z][i], in that order,
// rounded once to the weight type.
template <typename T>
__global__ void __launch_bounds__(256)
    wgrad_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                        int slices, size_t kn) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= kn) return;
  float s = 0.0f;
  for (int z = 0; z < slices; ++z) s += part[z * kn + i];
  fgbn::cvt(s, dw[i]);
}

// x (M, K), dy/y (M, N); part (slices, K, N) f32 scratch with
// slices = ceil(M / chunk) and chunk a multiple of 32; dw (K, N).
template <typename T>
int run(const void* x, const float* ps, const float* pb, const void* dy,
        const void* y, const float* dss, const float* dsq, float* part,
        void* dw, int M, int K, int N, int chunk, int prologue, int relu,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = (M + chunk - 1) / chunk;
  dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, slices);
  wgrad_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), ps, pb, static_cast<const T*>(dy),
      static_cast<const T*>(y), dss, dsq, part, M, K, N, chunk, prologue,
      relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t kn = static_cast<size_t>(K) * N;
  wgrad_reduce_kernel<T><<<static_cast<unsigned>((kn + 255) / 256), 256, 0,
                           s>>>(part, static_cast<T*>(dw), slices, kn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_matmul_bn_wgrad_bf16(const void* x, const float* ps,
                                          const float* pb, const void* dy,
                                          const void* y, const float* dss,
                                          const float* dsq, float* part,
                                          void* dw, int M, int K, int N,
                                          int chunk, int prologue, int relu,
                                          void* stream) {
  return run<__nv_bfloat16>(x, ps, pb, dy, y, dss, dsq, part, dw, M, K, N,
                            chunk, prologue, relu, stream);
}

extern "C" int fused_matmul_bn_wgrad_f32(const void* x, const float* ps,
                                         const float* pb, const void* dy,
                                         const void* y, const float* dss,
                                         const float* dsq, float* part,
                                         void* dw, int M, int K, int N,
                                         int chunk, int prologue, int relu,
                                         void* stream) {
  return run<float>(x, ps, pb, dy, y, dss, dsq, part, dw, M, K, N, chunk,
                    prologue, relu, stream);
}
