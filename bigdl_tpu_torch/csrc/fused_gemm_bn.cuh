// Shared tiled GEMM with a BatchNorm prologue and a statistics epilogue:
// the f32 paths of fused_matmul_bn.cu (1x1 conv as a matmul) and
// fused_conv3x3_bn.cu (3x3 stride-1 SAME conv as an implicit GEMM) and,
// through fused_dgrad_bn.cuh and fused_matmul_bn_wgrad.cu, of the
// gradient kernels; every bf16 path is a wgmma kernel of its own.
// colsum_kernel and relu_nan serve all of them.
//
//   u   = [relu](x * ps + pb)   in f32, rounded to the weight type
//   acc = u @ W                 f32 accumulation
//   y   = acc rounded to x's type
//   ssum[n] = sum_m acc[m, n],  ssq[n] = sum_m acc[m, n]^2   (from acc)
//
// Blocking: one block of 256 threads (8 warps, 4 x 2) owns a 128 x 64
// output tile and walks K in steps of 32 through shared memory.  Each
// warp owns a 32 x 32 sub-tile: 2 x 4 fragments of 16 x 8 in
// mma.sync's m16n8 accumulator layout, computed with FMAs (a TF32
// product would change the numbers).
//
// A rows past M, K columns past K and W columns past N load as 0, never
// as prologue(0): padded rows then add nothing to the statistics.
//
// Statistics: the TPU kernel sums them across sequential grid steps.
// Blocks here run in parallel, in no order, so each block writes its
// 128-row partial column sums into a (grid_m, N) f32 scratch that the
// caller allocates, and colsum_kernel reduces it in a fixed order.
// No atomics: the result is the same on every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fgbn {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // padded shared-memory row (elements)
constexpr int THREADS = 256;

struct ConvGeom {  // input image geometry of the implicit GEMM
  int H, W, C;
};

// max(u, 0) that keeps a NaN, as jnp.maximum does (fmaxf turns it into
// 0, and then no NaN reaches the loss for its detector to see); one
// instruction, as fmaxf is
__device__ __forceinline__ float relu_nan(float u) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(u));
  return r;
}

// ---------------------------------------------------------------- I/O
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// raw copy of 8 elements (16 or 32 bytes) without a type round trip
template <typename T>
__device__ __forceinline__ void copy8(T (&dst)[8], const T* src) {
  constexpr int n = 8 * sizeof(T) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < n; ++i) d[i] = s[i];
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = t.x;
  b = t.y;
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x;
  b = t.y;
}

// ------------------------------------------------------------- tiles
// Where the 8-vector A[m][k .. k+7] comes from: returns false for
// padding (a row past M, a column past K, or a 3x3 tap outside the
// image), else sets the source offset and the channel `c` of its first
// element.  For CONV the reduction index is k = (dh * 3 + dw) * C + c,
// the HWIO order; C % 8 == 0, so a vector of 8 never crosses a tap.
template <bool CONV>
__device__ __forceinline__ bool a_src(int m, int k, int M, int K, ConvGeom g,
                                      size_t& off, int& c) {
  c = k;
  if (m >= M || k >= K) return false;
  if (CONV) {
    const int tap = k / g.C;
    c = k - tap * g.C;
    const int dh = tap / 3, dw = tap - 3 * (tap / 3);
    const int ow = m % g.W;
    const int t = m / g.W;
    const int oh = t % g.H;
    const int b = t / g.H;
    const int ih = oh + dh - 1, iw = ow + dw - 1;
    if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return false;
    off = ((static_cast<size_t>(b) * g.H + ih) * g.W + iw) * g.C + c;
  } else {
    off = static_cast<size_t>(m) * K + k;
  }
  return true;
}

// A tile: 128 rows x 32 reduction columns = 512 vectors of 8, two per
// thread.  The prologue runs here, on the way into shared memory.
template <typename T, bool CONV>
__device__ __forceinline__ void load_a_tile(T* As, const T* __restrict__ x,
                                            const float* __restrict__ ps,
                                            const float* __restrict__ pb,
                                            int m0, int k0, int M, int K,
                                            int prologue, int relu,
                                            ConvGeom g) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v >> 2;
    const int kv = (v & 3) * 8;
    float f[8];
    size_t off = 0;
    int c;  // prologue channel of the first element
    if (a_src<CONV>(m0 + row, k0 + kv, M, K, g, off, c)) {
      load8(x + off, f);
      if (prologue) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // separate multiply and add (no FMA contraction), as the
          // plain version computes it
          float u = __fadd_rn(__fmul_rn(f[j], ps[c + j]), pb[c + j]);
          f[j] = relu ? relu_nan(u) : u;
        }
      }
    } else {
      // zero halo / padded row, applied AFTER the prologue
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    store8(As + row * LDS + kv, f);
  }
}

// B tile: 32 reduction rows x 64 columns, stored transposed (Bs[n][k])
// so a fragment's two consecutive k values are one 32-bit word.
template <typename T>
__device__ __forceinline__ void load_b_tile(T* Bs, const T* __restrict__ w,
                                            int k0, int n0, int K, int N) {
  const int v = threadIdx.x;
  const int kr = v >> 3;
  const int nv = (v & 7) * 8;
  const int k = k0 + kr, n = n0 + nv;
  alignas(16) T t[8];
  if (k < K && n < N) {
    copy8(t, w + static_cast<size_t>(k) * N + n);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = T(0.0f);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) Bs[(nv + j) * LDS + kr] = t[j];
}

// acc[mi][ni][r]: fragment (mi, ni) of the warp's 32 x 32 sub-tile, in
// the m16n8 accumulator layout: r = 0, 1 -> row g, cols 2t, 2t+1;
// r = 2, 3 -> row g + 8 (g = lane / 4, t = lane % 4).
template <typename T>
__device__ __forceinline__ void compute_tile(const T* As, const T* Bs,
                                             float (&acc)[2][4][4],
                                             int warp_m, int warp_n,
                                             int lane) {
  static_assert(std::is_same<T, float>::value,
                "only the f32 paths run these tiles; bf16 runs wgmma");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = warp_m * 32 + mi * 16 + g;
      a[mi][0] = As[r * LDS + k];
      a[mi][1] = As[(r + 8) * LDS + k];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = warp_n * 32 + ni * 8 + t * 2;
      b[ni][0] = Bs[n * LDS + k];
      b[ni][1] = Bs[(n + 1) * LDS + k];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][0] = fmaf(a[mi][0], b[ni][0], acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(a[mi][0], b[ni][1], acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(a[mi][1], b[ni][0], acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(a[mi][1], b[ni][1], acc[mi][ni][3]);
      }
  }
}

// ------------------------------------------------------------ kernels
template <typename T, bool CONV>
__global__ void __launch_bounds__(THREADS)
    fused_gemm_bn_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ ps,
                         const float* __restrict__ pb, T* __restrict__ y,
                         float* __restrict__ part_sum,
                         float* __restrict__ part_sq, int M, int K, int N,
                         int prologue, int relu, ConvGeom geom) {
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float red_s[4][BN];
  __shared__ float red_q[4][BN];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_tile<T, CONV>(As, x, ps, pb, m0, k0, M, K, prologue, relu, geom);
    load_b_tile<T>(Bs, w, k0, n0, K, N);
    __syncthreads();
    compute_tile<T>(As, Bs, acc, warp_m, warp_n, lane);
    __syncthreads();
  }

  // epilogue 1: y rounded to x's type
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r0 = m0 + warp_m * 32 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + warp_n * 32 + ni * 8 + t * 2;
      if (c < N) {  // N % 8 == 0, so c + 1 < N as well
        if (r0 < M)
          store2(y + static_cast<size_t>(r0) * N + c, acc[mi][ni][0],
                 acc[mi][ni][1]);
        if (r0 + 8 < M)
          store2(y + static_cast<size_t>(r0 + 8) * N + c, acc[mi][ni][2],
                 acc[mi][ni][3]);
      }
    }
  }

  // epilogue 2: column sums of acc and acc^2 over the tile's rows
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float a = acc[mi][ni][j], b = acc[mi][ni][2 + j];
        s += a + b;
        q += a * a + b * b;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (g == 0) {
        const int col = warp_n * 32 + ni * 8 + t * 2 + j;
        red_s[warp_m][col] = s;
        red_q[warp_m][col] = q;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < BN) {
    const int col = n0 + threadIdx.x;
    if (col < N) {
      const int i = threadIdx.x;
      const size_t o = static_cast<size_t>(blockIdx.x) * N + col;
      part_sum[o] = ((red_s[0][i] + red_s[1][i]) + red_s[2][i]) + red_s[3][i];
      part_sq[o] = ((red_q[0][i] + red_q[1][i]) + red_q[2][i]) + red_q[3][i];
    }
  }
}

// Sums the (rows, N) partials down the rows, in a fixed order: warp w
// takes rows w, w + 8, ...; then warp 0 adds the 8 warp sums in order.
__global__ void __launch_bounds__(256)
    colsum_kernel(const float* __restrict__ part_sum,
                  const float* __restrict__ part_sq, float* __restrict__ ssum,
                  float* __restrict__ ssq, int rows, int N) {
  __shared__ float ss[8][32];
  __shared__ float sq[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.0f, q = 0.0f;
  if (col < N) {
    for (int r = warp; r < rows; r += 8) {
      s += part_sum[static_cast<size_t>(r) * N + col];
      q += part_sq[static_cast<size_t>(r) * N + col];
    }
  }
  ss[warp][lane] = s;
  sq[warp][lane] = q;
  __syncthreads();
  if (warp == 0 && col < N) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a += ss[i][lane];
      b += sq[i][lane];
    }
    ssum[col] = a;
    ssq[col] = b;
  }
}

// Launches the GEMM and the column reduction on `stream`; returns the
// first cudaGetLastError() that is not cudaSuccess.  The caller has
// checked shapes (K, N, C multiples of 8), alignment and M > 0, and
// allocated part_sum/part_sq as (ceil(M / BM), N) f32.
template <typename T, bool CONV>
int launch(const void* x, const void* w, const float* ps, const float* pb,
           void* y, float* part_sum, float* part_sq, float* ssum, float* ssq,
           int M, int K, int N, int prologue, int relu, ConvGeom geom,
           cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_gemm_bn_kernel<T, CONV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ps, pb,
      static_cast<T*>(y), part_sum, part_sq, M, K, N, prologue, relu, geom);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  colsum_kernel<<<(N + 31) / 32, 256, 0, stream>>>(part_sum, part_sq, ssum,
                                                   ssq, grid.x, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fgbn
