// Pieces shared by the bf16 wgmma GEMMs of the fused matmul and 3x3 conv
// with BatchNorm: fused_matmul_bn.cu (kernel 1, a 1x1 conv as a matmul)
// and fused_conv3x3_bn.cu (kernel 4, the 3x3 conv as an implicit GEMM)
// take the prologue, the wgmma step and the statistics epilogue;
// fused_matmul_bn_dgrad.cu (kernel 2) and fused_conv3x3_bn_dgrad.cu
// (kernel 5) take ytot (kernel 2 in registers, ytot_a; kernel 5 once per
// window in shared memory, ytot2), the wgmma step with a K-major B and
// the dgrad epilogue; fused_matmul_bn_wgrad.cu (kernel 3) takes ytot2,
// the prologue and the wgmma step.  One function, ytot2, fixes ytot's
// rounding order for kernels 2, 3 and 5.  All tile rows by BM = 128 (two
// consumer warpgroups of 64 rows, A from registers) and follow the same
// rounding points:
//
//   forward   u    = [relu](x * ps + pb)   f32, a separate multiply and
//                                          add, rounded to bf16 (prologue2)
//             acc  = u @ W                 f32 (wgmma)
//             y    = acc rounded once to bf16;  ssum, ssq from acc
//   backward  ytot = (dy + dssum) + (2 y) * dssq   f32, separate adds and
//                                          multiplies, rounded to bf16 (ytot2)
//             acc  = ytot @ W^T            f32 (wgmma)
//             g    = acc where x * ps + pb > 0, else 0 (relu; a NaN
//                    gives 0); dx = g * ps rounded once to bf16;
//                    d_ps = sum g * x, d_pb = sum g from the f32 g
//                    (dgrad8); without a prologue dx = acc rounded
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

// ytot of a bf16 pair of dy and y in f32, in the plain version's order
// (dy + dssum) + (2 y) * dssq with separate adds and multiplies, with
// the pair's two constants, as a bf16 pair.
__device__ __forceinline__ uint32_t ytot2(uint32_t dy, uint32_t y, float2 dss,
                                          float2 dsq) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dy));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return hopper::pack_bf16(
      __fadd_rn(__fadd_rn(a.x, dss.x), __fmul_rn(__fmul_rn(2.0f, b.x), dsq.x)),
      __fadd_rn(__fadd_rn(a.y, dss.y), __fmul_rn(__fmul_rn(2.0f, b.y), dsq.y)));
}

// Builds the A fragments of one 64-channel step of ytot (channels from
// c0) in `a`: the raw bf16 dy and y fragments of rows row .. row + 15
// (this lane's ldmatrix row; `lhalf` picks the channel half) of two
// 128-byte swizzled tiles laid out alike, then ytot with the constants
// of each column pair from the dss_s/dsq_s tables (0 past the channels,
// where TMA's zero fill meets them), and-ed with keep0 (row g) and keep1
// (g + 8) AFTER ytot: a zero-filled row or tap gives ytot = dssum.
__device__ __forceinline__ void ytot_a(uint32_t (&a)[4][4], int c0,
                                       uint32_t dy_tile, uint32_t y_tile,
                                       int row, int lhalf, int t,
                                       const float* dss_s, const float* dsq_s,
                                       uint32_t keep0, uint32_t keep1) {
  using namespace hopper;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t rd[4], ry[4];
    const uint32_t off = swz<128>(row, 2 * ks + lhalf);
    ldmatrix_x4(dy_tile + off, rd);
    ldmatrix_x4(y_tile + off, ry);
    const int c = c0 + ks * 16 + 2 * t;
    const float2 sl = *reinterpret_cast<const float2*>(dss_s + c);
    const float2 sh = *reinterpret_cast<const float2*>(dss_s + c + 8);
    const float2 ql = *reinterpret_cast<const float2*>(dsq_s + c);
    const float2 qh = *reinterpret_cast<const float2*>(dsq_s + c + 8);
    a[ks][0] = ytot2(rd[0], ry[0], sl, ql) & keep0;
    a[ks][1] = ytot2(rd[1], ry[1], sl, ql) & keep1;
    a[ks][2] = ytot2(rd[2], ry[2], sh, qh) & keep0;
    a[ks][3] = ytot2(rd[3], ry[3], sh, qh) & keep1;
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

// Issues the 4 wgmmas of one 64-deep step, A from `a` and B the K-major
// (N rows, 64 K) tile at b_tile (one 128-byte swizzled column block),
// as one commit group.
template <int N>
__device__ __forceinline__ void issue_kb(float (&acc)[N / 2],
                                         uint32_t (&a)[4][4],
                                         uint32_t b_tile) {
  using namespace hopper;
  reg_fence(a);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs_kb(acc, a[ks], desc_k<128>(b_tile, N, 0, ks * 16), 1);
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

// The dgrad epilogue on columns 8j .. 8j + 7 of a tile, per consumer
// thread (rows rw + g and rw + g + 8): reads x from the swizzled (BM, BN)
// bf16 tile `xt` (column blocks of 64, the TMA layout), writes dx in its
// place and returns in gx[e], gg[e] the two rows' sums of g * x and g
// for column 8j + 2t + e.  s, b: that column pair's ps and pb.  The mask
// is !(x * ps + pb > 0), so a NaN in x zeroes g, and g * x is kept where
// g is 0: 0 * NaN is NaN in d_ps, as in the plain version.  Without a
// prologue dx = acc and the sums stay 0.
template <int BN>
__device__ __forceinline__ void dgrad8(const float (&acc)[BN / 2],
                                       unsigned char* xt, int j, int rw,
                                       int g, int t, float2 s, float2 b,
                                       bool prologue, bool relu,
                                       float (&gx)[2], float (&gg)[2]) {
  using namespace hopper;
  gx[0] = gx[1] = gg[0] = gg[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t* p = reinterpret_cast<uint32_t*>(
        xt + (j / 8) * BM * 128 + swz<128>(rw + g + 8 * i, j % 8) + 4 * t);
    float g0 = acc[4 * j + 2 * i], g1 = acc[4 * j + 2 * i + 1];
    if (!prologue) {
      *p = pack_bf16(g0, g1);
      continue;
    }
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    if (relu) {
      g0 = __fadd_rn(__fmul_rn(x.x, s.x), b.x) > 0.0f ? g0 : 0.0f;
      g1 = __fadd_rn(__fmul_rn(x.y, s.y), b.y) > 0.0f ? g1 : 0.0f;
    }
    *p = pack_bf16(__fmul_rn(g0, s.x), __fmul_rn(g1, s.y));
    gx[0] = __fadd_rn(gx[0], __fmul_rn(g0, x.x));
    gx[1] = __fadd_rn(gx[1], __fmul_rn(g1, x.y));
    gg[0] = __fadd_rn(gg[0], g0);
    gg[1] = __fadd_rn(gg[1], g1);
  }
}

// Adds the slices of a split dgrad in slice order, then applies dgrad8's
// prologue backward to the f32 sum: dx and, with a prologue, the column
// partials of g * x and g per BM-row tile (the layout colsum_kernel
// reduces).
__global__ void __launch_bounds__(256)
    dgrad_split_sum(const float* __restrict__ ws,
                    const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ ps, const float* __restrict__ pb,
                    __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ part_gx, float* __restrict__ part_g,
                    int M, int N, int slices, int prologue, int relu) {
  __shared__ float rs[4][64];
  __shared__ float rq[4][64];
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  const int n = blockIdx.y * 64 + tx;
  const int m0 = blockIdx.x * BM;
  float s = 0.0f, q = 0.0f;
  if (n < N) {
    const float psn = prologue ? ps[n] : 1.0f, pbn = prologue ? pb[n] : 0.0f;
    for (int r = ty; r < BM && m0 + r < M; r += 4) {
      const size_t o = static_cast<size_t>(m0 + r) * N + n;
      float v = 0.0f;
      for (int z = 0; z < slices; ++z)
        v += ws[static_cast<size_t>(z) * M * N + o];
      if (!prologue) {
        dx[o] = __float2bfloat16(v);
        continue;
      }
      const float xf = __bfloat162float(x[o]);
      if (relu && !(__fadd_rn(__fmul_rn(xf, psn), pbn) > 0.0f)) v = 0.0f;
      dx[o] = __float2bfloat16(__fmul_rn(v, psn));
      s = __fadd_rn(s, __fmul_rn(v, xf));
      q = __fadd_rn(q, v);
    }
  }
  if (!prologue) return;  // uniform over the grid
  rs[ty][tx] = s;
  rq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && n < N) {
    const size_t o = static_cast<size_t>(blockIdx.x) * N + n;
    part_gx[o] = ((rs[0][tx] + rs[1][tx]) + rs[2][tx]) + rs[3][tx];
    part_g[o] = ((rq[0][tx] + rq[1][tx]) + rq[2][tx]) + rq[3][tx];
  }
}

// The end of a dgrad launch: the split sum (slices > 1; it writes one
// partial row per BM-row tile), then, with a prologue, colsum_kernel
// over the `rows` partial rows into d_ps/d_pb.  Returns 0 or a CUDA
// error.
inline int dgrad_finish(const float* ws, const void* x, const float* ps,
                        const float* pb, void* dx, float* part_gx,
                        float* part_g, float* dps, float* dpb, int M, int N,
                        int slices, int rows, int prologue, int relu,
                        cudaStream_t stream) {
  if (slices > 1) {
    rows = (M + BM - 1) / BM;
    dgrad_split_sum<<<dim3(rows, (N + 63) / 64), 256, 0, stream>>>(
        ws, static_cast<const __nv_bfloat16*>(x), ps, pb,
        static_cast<__nv_bfloat16*>(dx), part_gx, part_g, M, N, slices,
        prologue, relu);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!prologue) return 0;
  fgbn::colsum_kernel<<<(N + 31) / 32, 256, 0, stream>>>(
      part_gx, part_g, dps, dpb, rows, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgbn
