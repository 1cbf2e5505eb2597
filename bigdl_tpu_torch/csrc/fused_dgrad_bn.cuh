// Shared data-gradient GEMM of the fused matmul/conv + BatchNorm
// kernels, used by fused_matmul_bn_dgrad.cu (1x1 conv as a matmul) and
// fused_conv3x3_bn_dgrad.cu (3x3 stride-1 SAME conv as an implicit
// GEMM).  It is the forward GEMM of fused_gemm_bn.cuh with its two ends
// swapped:
//
//   A-tile transform (was the BN prologue):
//     ytot = dy + dssum + 2 * y * dssq   in f32 from the saved (rounded)
//                                        y, rounded to the operand type
//   product:  g_out = ytot @ B           f32 accumulation
//   epilogue (was y + statistics), with a prologue in the forward:
//     g   = (x * ps + pb > 0) ? g_out : 0     (only with relu; strict >)
//     dx  = g * ps                             rounded to x's type
//     d_ps[k] = sum_m g * x,  d_pb[k] = sum_m g   from the f32 g
//   and without one: dx = g_out rounded to x's type.
//
// For the matmul, B is W^T as a (N, K) matrix: the wrapper passes a
// contiguous w.t() (W is at most 2048 x 512, so the copy is small next
// to the (M, N) operands) and the forward's B-tile loader reads it
// unchanged.  For the conv, rows are input pixels, the reduction index
// is (tap, output channel) and B is the flipped, io-swapped weight
// w[2-dh, 2-dw, ci, co] as a (9*Co, Ci) matrix, also built by the
// wrapper.  The A-tile gather uses the forward's geometry (a_src): an
// out-of-image tap is 0, applied AFTER ytot, so dssum never leaks into
// the border.
//
// d_ps/d_pb use the forward's deterministic two-pass column reduction:
// per-block partial sums into a (grid_m, N) f32 scratch, then
// colsum_kernel in a fixed order.  No atomics.
#pragma once

#include "fused_gemm_bn.cuh"

namespace fgbn {

__device__ __forceinline__ void cvt(float f, __nv_bfloat16& o) {
  o = __float2bfloat16_rn(f);
}

__device__ __forceinline__ void cvt(float f, float& o) { o = f; }

// ytot for 8 consecutive channels c .. c+7 of one pixel, in f32, with
// separate multiplies and adds (no FMA contraction), in the plain
// version's order: (dy + dssum) + (2 * y) * dssq.
template <typename T>
__device__ __forceinline__ void ytot8(const T* dy, const T* y,
                                      const float* __restrict__ dss,
                                      const float* __restrict__ dsq, int c,
                                      float (&f)[8]) {
  float a[8], b[8];
  load8(dy, a);
  load8(y, b);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f[j] = __fadd_rn(__fadd_rn(a[j], dss[c + j]),
                     __fmul_rn(__fmul_rn(2.0f, b[j]), dsq[c + j]));
}

// A tile of ytot: 128 rows x 32 reduction columns, two vectors of 8 per
// thread; rounded to T by store8.
template <typename T, bool CONV>
__device__ __forceinline__ void load_a_tile_ytot(
    T* As, const T* __restrict__ dy, const T* __restrict__ y,
    const float* __restrict__ dss, const float* __restrict__ dsq, int m0,
    int k0, int M, int K, ConvGeom g) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v >> 2;
    const int kv = (v & 3) * 8;
    float f[8];
    size_t off = 0;
    int c;
    if (a_src<CONV>(m0 + row, k0 + kv, M, K, g, off, c)) {
      ytot8(dy + off, y + off, dss, dsq, c, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    store8(As + row * LDS + kv, f);
  }
}

// M rows, R reduction, N columns (N is x's channel count).
template <typename T, bool CONV>
__global__ void __launch_bounds__(THREADS)
    fused_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       const float* __restrict__ dss,
                       const float* __restrict__ dsq,
                       const T* __restrict__ bmat, const T* __restrict__ x,
                       const float* __restrict__ ps,
                       const float* __restrict__ pb, T* __restrict__ dx,
                       float* __restrict__ part_gx,
                       float* __restrict__ part_g, int M, int R, int N,
                       int prologue, int relu, ConvGeom geom) {
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float red_a[4][BN];
  __shared__ float red_b[4][BN];

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

  for (int k0 = 0; k0 < R; k0 += BK) {
    load_a_tile_ytot<T, CONV>(As, dy, y, dss, dsq, m0, k0, M, R, geom);
    load_b_tile<T>(Bs, bmat, k0, n0, R, N);
    __syncthreads();
    compute_tile<T>(As, Bs, acc, warp_m, warp_n, lane);
    __syncthreads();
  }

  // epilogue 1: the prologue's backward and dx; gx/gg keep g * x and g
  // (0 for padded rows and columns) for the column sums
  const int g = lane >> 2, t = lane & 3;
  float gx[2][4][4], gg[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + warp_n * 32 + ni * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
        float g0 = acc[mi][ni][2 * h], g1 = acc[mi][ni][2 * h + 1];
        float x0 = 0.0f, x1 = 0.0f;
        const bool ok = r < M && c < N;  // N % 8 == 0: c + 1 < N too
        const size_t o = static_cast<size_t>(r) * N + c;
        if (!prologue) {
          if (ok) store2(dx + o, g0, g1);
          continue;
        }
        if (ok) {
          load2(x + o, x0, x1);
          if (relu) {
            if (!(__fadd_rn(__fmul_rn(x0, ps[c]), pb[c]) > 0.0f)) g0 = 0.0f;
            if (!(__fadd_rn(__fmul_rn(x1, ps[c + 1]), pb[c + 1]) > 0.0f))
              g1 = 0.0f;
          }
          store2(dx + o, __fmul_rn(g0, ps[c]), __fmul_rn(g1, ps[c + 1]));
        } else {
          g0 = g1 = 0.0f;
        }
        gx[mi][ni][2 * h] = __fmul_rn(g0, x0);
        gx[mi][ni][2 * h + 1] = __fmul_rn(g1, x1);
        gg[mi][ni][2 * h] = g0;
        gg[mi][ni][2 * h + 1] = g1;
      }
    }
  }
  if (!prologue) return;  // uniform over the block

  // epilogue 2: column sums of g * x and g over the tile's rows
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        a += gx[mi][ni][j] + gx[mi][ni][2 + j];
        b += gg[mi][ni][j] + gg[mi][ni][2 + j];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (g == 0) {
        const int col = warp_n * 32 + ni * 8 + t * 2 + j;
        red_a[warp_m][col] = a;
        red_b[warp_m][col] = b;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < BN) {
    const int col = n0 + threadIdx.x;
    if (col < N) {
      const int i = threadIdx.x;
      const size_t o = static_cast<size_t>(blockIdx.x) * N + col;
      part_gx[o] = ((red_a[0][i] + red_a[1][i]) + red_a[2][i]) + red_a[3][i];
      part_g[o] = ((red_b[0][i] + red_b[1][i]) + red_b[2][i]) + red_b[3][i];
    }
  }
}

// Launches the GEMM and, with a prologue, the column reduction of d_ps
// and d_pb on `stream`; returns the first cudaGetLastError() that is not
// cudaSuccess.  The caller has checked shapes (R, N, channels multiples
// of 8), alignment and M > 0, and allocated part_gx/part_g as
// (ceil(M / BM), N) f32.
template <typename T, bool CONV>
int launch_dgrad(const void* dy, const void* y, const float* dss,
                 const float* dsq, const void* bmat, const void* x,
                 const float* ps, const float* pb, void* dx, float* part_gx,
                 float* part_g, float* dps, float* dpb, int M, int R, int N,
                 int prologue, int relu, ConvGeom geom, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_dgrad_kernel<T, CONV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), dss, dsq,
      static_cast<const T*>(bmat), static_cast<const T*>(x), ps, pb,
      static_cast<T*>(dx), part_gx, part_g, M, R, N, prologue, relu, geom);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !prologue) return static_cast<int>(e);
  colsum_kernel<<<(N + 31) / 32, 256, 0, stream>>>(part_gx, part_g, dps, dpb,
                                                   grid.x, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fgbn
