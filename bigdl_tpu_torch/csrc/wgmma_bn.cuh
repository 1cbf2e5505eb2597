// Pieces shared by the bf16 wgmma GEMMs with the BatchNorm prologue and
// statistics epilogue: fused_matmul_bn.cu (kernel 1, a 1x1 conv as a
// matmul) and fused_conv3x3_bn.cu (kernel 4, the 3x3 conv as an implicit
// GEMM); fused_matmul_bn_wgrad.cu (kernel 3) takes the prologue and the
// wgmma step.  Both tile rows by BM = 128 (two consumer warpgroups of 64 rows,
// A from registers) and columns by BN = 64, 128 or 256, and both follow
// the same rounding points:
//
//   u   = [relu](x * ps + pb)   f32, a separate multiply and add,
//                               rounded to bf16 (prologue2)
//   acc = u @ W                 f32 (wgmma)
//   y   = acc rounded once to bf16;  ssum, ssq from acc
//
// Accumulator layout (hopper.cuh wgmma_rs): in the warp owning rows
// rw .. rw + 15, acc[4j + r] is row rw + g + 8 (r >> 1), column
// 8j + 2t + (r & 1) (g = lane / 4, t = lane % 4).
#pragma once

#include "fused_gemm_bn.cuh"
#include "hopper.cuh"

namespace wgbn {

constexpr int BM = 128;

// bf16 pair of raw x -> [relu](x * s + b) in f32 (a separate multiply
// and add) -> bf16 pair, and-ed with `keep` (0 for a row or tap that
// reads padding).  Without a prologue the tables hold s = 1, b = 0,
// which gives x back.  Branch-free: a branch per pair kept the compiler
// from overlapping the fragments' loads and arithmetic.  The ReLU keeps
// a NaN, as jnp.maximum does.
__device__ __forceinline__ uint32_t prologue2(uint32_t raw, float2 s,
                                              float2 b, bool relu,
                                              uint32_t keep) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  float u0 = __fadd_rn(__fmul_rn(f.x, s.x), b.x);
  float u1 = __fadd_rn(__fmul_rn(f.y, s.y), b.y);
  u0 = relu ? fgbn::relu_nan(u0) : u0;
  u1 = relu ? fgbn::relu_nan(u1) : u1;
  return hopper::pack_bf16(u0, u1) & keep;
}

// Builds the A fragments of one 64-channel step (channels from c0) in
// `a`: the raw bf16 x fragments of rows row .. row + 15 (this lane's
// ldmatrix row; `lhalf` picks the channel half) of a 128-byte swizzled
// tile, then the prologue, and-ed with keep0 (row g) and keep1 (g + 8).
__device__ __forceinline__ void build_a(uint32_t (&a)[4][4], int c0,
                                        uint32_t tile, int row, int lhalf,
                                        int t, const float* ps_s,
                                        const float* pb_s, uint32_t keep0,
                                        uint32_t keep1, bool relu) {
  using namespace hopper;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t raw[4];
    ldmatrix_x4(tile + swz<128>(row, 2 * ks + lhalf), raw);
    const int c = c0 + ks * 16 + 2 * t;
    const float2 sl = *reinterpret_cast<const float2*>(ps_s + c);
    const float2 sh = *reinterpret_cast<const float2*>(ps_s + c + 8);
    const float2 bl = *reinterpret_cast<const float2*>(pb_s + c);
    const float2 bh = *reinterpret_cast<const float2*>(pb_s + c + 8);
    a[ks][0] = prologue2(raw[0], sl, bl, relu, keep0);
    a[ks][1] = prologue2(raw[1], sl, bl, relu, keep1);
    a[ks][2] = prologue2(raw[2], sh, bh, relu, keep0);
    a[ks][3] = prologue2(raw[3], sh, bh, relu, keep1);
  }
}

// Issues the 4 wgmmas of one 64-deep step, A from `a` and B the
// (64, N) MN-major tile at b_tile (column blocks of 64 rows x 128
// bytes), as one commit group.
template <int N>
__device__ __forceinline__ void issue(float (&acc)[N / 2],
                                      uint32_t (&a)[4][4], uint32_t b_tile) {
  using namespace hopper;
  reg_fence(a);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs<N>(acc, a[ks], desc_mn<128>(b_tile, 64, ks * 16), 1);
  wgmma_commit();
}

// One column's sums s, q of a thread's rows, added over the warp's 8 row
// groups (the lanes that share t) and stored at red_s/red_q[i] by group
// 0: red_s and red_q hold 8 rows of BN partials, one per warp.
__device__ __forceinline__ void warp_col(float s, float q, float* red_s,
                                         float* red_q, int i, int g) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  if (g == 0) {
    red_s[i] = s;
    red_q[i] = q;
  }
}

// Columns 8j .. 8j + 7 of y, rounded once, into a swizzled (BM, BN) bf16
// tile in shared memory (column blocks of 64, the TMA store's layout).
// `rw` is the warp's first row.
template <int BN>
__device__ __forceinline__ void stage_y8(const float (&acc)[BN / 2],
                                         unsigned char* ytile, int j, int rw,
                                         int g, int t) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rw + g + 8 * i;
    *reinterpret_cast<uint32_t*>(
        ytile + (j / 8) * BM * 128 + swz<128>(r, j % 8) + 4 * t) =
        pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// The epilogue's first half, per consumer thread: y into the staging
// tile, and the column sums of acc and acc^2 over the warp's 16 rows
// into red_s / red_q.  `wgi` is the warpgroup.
template <int BN>
__device__ __forceinline__ void stage_tile(const float (&acc)[BN / 2],
                                           unsigned char* ytile,
                                           float* red_s, float* red_q,
                                           int wgi, int warp, int rw, int g,
                                           int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    stage_y8<BN>(acc, ytile, j, rw, g, t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float u = acc[4 * j + e], v = acc[4 * j + 2 + e];
      warp_col(u + v, u * u + v * v, red_s, red_q,
               (4 * wgi + warp) * BN + 8 * j + 2 * t + e, g);
    }
  }
}

// The epilogue's second half: column `col` of the tile's 8 warp rows of
// partials, summed in a fixed order.
template <int BN>
__device__ __forceinline__ void reduce_tile(const float* red_s,
                                            const float* red_q, int col,
                                            float& s, float& q) {
  s = 0.0f;
  q = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s += red_s[i * BN + col];
    q += red_q[i * BN + col];
  }
}

// A split reduction's f32 partial tile, straight from the accumulator,
// into slice z of the (slices, M, N) workspace (rows past M and columns
// past N are not written).
template <int BN>
__device__ __forceinline__ void store_slice(const float (&acc)[BN / 2],
                                            float* __restrict__ ws, int z,
                                            int m0, int n0, int M, int N,
                                            int rw, int g, int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: n + 1 < N as well
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + rw + g + 8 * i;
      if (m < M)
        *reinterpret_cast<float2*>(
            ws + (static_cast<size_t>(z) * M + m) * N + n) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// Adds the slices of a split reduction in slice order, rounds y once and
// writes the column partials of the summed f32 values per BM-row tile
// (the layout of the unsplit kernels' partials, which colsum_kernel
// reduces).
__global__ void __launch_bounds__(256)
    split_sum(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
              float* __restrict__ part_sum, float* __restrict__ part_sq,
              int M, int N, int slices) {
  __shared__ float rs[4][64];
  __shared__ float rq[4][64];
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  const int n = blockIdx.y * 64 + tx;
  const int m0 = blockIdx.x * BM;
  float s = 0.0f, q = 0.0f;
  if (n < N) {
    for (int r = ty; r < BM && m0 + r < M; r += 4) {
      const size_t o = static_cast<size_t>(m0 + r) * N + n;
      float v = 0.0f;
      for (int z = 0; z < slices; ++z)
        v += ws[static_cast<size_t>(z) * M * N + o];
      y[o] = __float2bfloat16(v);
      s += v;
      q += v * v;
    }
  }
  rs[ty][tx] = s;
  rq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && n < N) {
    const size_t o = static_cast<size_t>(blockIdx.x) * N + n;
    part_sum[o] = ((rs[0][tx] + rs[1][tx]) + rs[2][tx]) + rs[3][tx];
    part_sq[o] = ((rq[0][tx] + rq[1][tx]) + rq[2][tx]) + rq[3][tx];
  }
}

// The column reduction after a launch: the split sum (slices > 1, which
// writes one partial row per BM-row tile), then colsum_kernel over the
// `rows` partial rows.  Returns 0 or a CUDA error.
inline int finish(const float* ws, void* y, float* part_sum, float* part_sq,
                  float* ssum, float* ssq, int M, int N, int slices,
                  int rows, cudaStream_t stream) {
  if (slices > 1) {
    rows = (M + BM - 1) / BM;
    split_sum<<<dim3(rows, (N + 63) / 64), 256, 0, stream>>>(
        ws, static_cast<__nv_bfloat16*>(y), part_sum, part_sq, M, N,
        slices);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fgbn::colsum_kernel<<<(N + 31) / 32, 256, 0, stream>>>(
      part_sum, part_sq, ssum, ssq, rows, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgbn
