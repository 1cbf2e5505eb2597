// fused_matmul_bn_dgrad: the data gradient of fused_matmul_bn,
//   ytot = dy + dssum + 2 * y * dssq      (f32, rounded to W's type)
//   g    = ytot @ W^T                     (f32)
//   with a prologue: g masked by x * ps + pb > 0 (relu), dx = g * ps,
//   d_ps = sum_m g * x, d_pb = sum_m g;   without one: dx = g.
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/fused_matmul.py
// `_dgrad_kernel` (launched by `_dgrad_pallas` from `_fused_bwd`).  In
// ResNet-50 training it runs once per fused_matmul_bn call of the
// forward: every 1x1 convolution and projection shortcut of the fused
// bottleneck blocks.
//
// What bounds it on an H100: 2*M*K*N operations over
// 2*(2*M*N + K*N + 2*M*K) bytes (dy, y, W, x, dx) is 16-280 ops per
// byte at ResNet-50's shapes, all below the card's ~295 ops/byte
// ridge: every call is bound by memory.  The design reads dy and y
// once per column tile of dx and never writes ytot: the statistics'
// cotangents fold into the A build, and the prologue's backward and the
// d_ps/d_pb reductions fold into the epilogue, which reads the x tile
// beside the accumulator.
//
// bf16: kernel 1's persistent wgmma design (fused_matmul_bn.cu) with
// its ends swapped.  One block of 384 threads per SM walks output tiles
// of 128 rows x BN columns of dx (BN = 64 or 128, over K), each over a
// slice of the reduction (over N) in steps of 64:
// - one producer thread keeps two rings full with TMA loads: the
//   (128 rows, 64 N) dy and y tiles, and the (BN, 64) tile of W read in
//   place as a K-major B operand (W is (K, N), N contiguous: a tensor
//   map over W covers it, nothing is transposed or copied), all in the
//   128-byte swizzle, zero past the tensors' ends.  After a tile's steps
//   it loads the tile's (128, BN) box of x into one of two x buffers;
//   it runs on into the next tile while the consumers finish this one;
// - two consumer warpgroups own 64 rows each.  Per step a consumer reads
//   its raw dy and y fragments with ldmatrix (non-transposed: the
//   channels run along the reduction), releases the stage, forms ytot in
//   f32 registers (wgmma_bn.cuh ytot_a), zeroes rows past M AFTER ytot
//   (a zero-filled row gives ytot = dssum, which would pass the ReLU
//   mask at pre = pb and leak into d_pb), rounds to bf16 and issues
//   wgmma m64nBNk16 with A from registers.  Two register sets of A
//   alternate, so step k+1's ytot is formed while step k's products run;
// - epilogue (wgmma_bn.cuh dgrad8): g and dx from the accumulator and
//   the x tile; dx overwrites x in its buffer, and a third thread (in
//   the producer warpgroup) writes it out with TMA stores once the
//   consumers have signalled the buffer, then frees it for the x of the
//   tile after next.  The column sums of g * x and g run on in
//   registers over the block's tiles (its tiles share one column tile)
//   and the block writes one row of partials at its end, reduced in a
//   fixed order; colsum_kernel then sums the rows.  No atomics;
// - the plan (ops/fused_matmul.py `_dgrad_plan`) splits the reduction
//   into slices only where the output tiles leave three quarters of the
//   SMs idle (never at ResNet-50's batch-32 shapes).  A split tile
//   writes its f32 partial to a workspace, and dgrad_split_sum
//   (wgmma_bn.cuh) adds the slices in slice order and only then applies
//   the prologue's backward.
//
// f32 (evaluation) runs the FMA tiles of fused_dgrad_bn.cuh on a
// contiguous W^T that the wrapper copies: a TF32 wgmma would change its
// numbers.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_dgrad_bn.cuh"
#include "hopper.cuh"
#include "wgmma_bn.cuh"

namespace {

namespace wg {

using wgbn::BM;  // rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;  // reduction step: one 128-byte swizzled row
constexpr int THREADS = 384;
constexpr int MAX_SMEM = 232448;  // the most a block may ask for
constexpr int BOX = BM * 128;     // one (128 rows, 64 channels) TMA box
constexpr int PRODUCER = 256;     // the thread that loads
constexpr int STORER = 288;       // the thread that stores dx (warp 9)

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 128 ? 3 : 4;  // both rings
  static constexpr int A_BYTES = 2 * BOX;     // dy tile, then y tile
  static constexpr int B_BYTES = BN * 128;    // one (BN, 64) W tile
  static constexpr int X_BYTES = BM * BN * 2;  // one x/dx tile
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int X_OFF = B_OFF + STAGES * B_BYTES;  // two x tiles
  static constexpr int BAR_OFF = X_OFF + 2 * X_BYTES;
  static constexpr int NBARS = 4 * STAGES + 6;
  static constexpr int VEC_OFF = BAR_OFF + 8 * NBARS;
  // ps, pb of the block's columns, then dssum, dssq over npad channels;
  // + 1 KB to align the base to the 1024-byte swizzle atom
  static int bytes(int npad) { return VEC_OFF + 4 * (2 * BN + 2 * npad) + 1024; }
};
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// One work item: output tile (mt, nt) over reduction slice z, steps
// [s_begin, s_begin + n_local).  Items run with the column tile
// innermost, so the blocks in flight share dy and y rows in L2.
struct Work {
  int m0, n0, z, s_begin, n_local;
};

template <int BN>
__device__ __forceinline__ Work work(int item, int rows, int cols,
                                     int steps, int per) {
  Work w;
  const int nt = item % cols, rest = item / cols;
  w.m0 = (rest % rows) * BM;
  w.n0 = nt * BN;
  w.z = rest / rows;
  w.s_begin = w.z * per;
  w.n_local = min(steps, w.s_begin + per) - w.s_begin;
  return w;
}

// Shared memory of the rings, the x tiles and their barriers.
struct Bars {
  uint64_t *a_full, *a_empty, *b_full, *b_empty;
  uint64_t *x_full, *x_empty, *dx_full;  // two each, one per x tile
};

// Step `gs` of the block's running step count (ring stage gs % STAGES),
// channels from c0: wait for its dy and y tiles, build A, release them
// (ldmatrix has read them), wait for its W tile, wait for the previous
// step's wgmmas and release their W tile (unless this is a tile's first
// step), issue the 4 wgmmas as one commit group.
template <int BN>
__device__ __forceinline__ void consume_step(
    float (&acc)[BN / 2], uint32_t (&a)[4][4], int gs, bool first, int c0,
    uint32_t base, const Bars& r, const float* dss_s, const float* dsq_s,
    uint32_t keep0, uint32_t keep1, int lrow, int lhalf, int t) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  const int st = gs % Cf::STAGES, parity = (gs / Cf::STAGES) & 1;
  mbar_wait(&r.a_full[st], parity);
  const uint32_t dyt = base + st * Cf::A_BYTES;
  wgbn::ytot_a(a, c0, dyt, dyt + BOX, lrow, lhalf, t, dss_s, dsq_s, keep0,
               keep1);
  mbar_arrive(&r.a_empty[st]);
  mbar_wait(&r.b_full[st], parity);
  if (!first) {
    wgmma_wait<0>();
    mbar_arrive(&r.b_empty[(gs - 1) % Cf::STAGES]);
  }
  wgbn::issue_kb<BN>(acc, a, base + Cf::B_OFF + st * Cf::B_BYTES);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    mm_dgrad_wgmma(const __grid_constant__ CUtensorMap dymap,
                   const __grid_constant__ CUtensorMap ymap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap dxmap,
                   const float* __restrict__ dss,
                   const float* __restrict__ dsq,
                   const float* __restrict__ ps, const float* __restrict__ pb,
                   float* __restrict__ ws, float* __restrict__ part_gx,
                   float* __restrict__ part_g, int M, int K, int N,
                   int prologue, int relu, int per) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Cf::BAR_OFF);
  const Bars r{bars, bars + Cf::STAGES, bars + 2 * Cf::STAGES,
               bars + 3 * Cf::STAGES, bars + 4 * Cf::STAGES,
               bars + 4 * Cf::STAGES + 2, bars + 4 * Cf::STAGES + 4};
  const int steps = (N + BK - 1) / BK, npad = steps * BK;
  float* ps_s = reinterpret_cast<float*>(smem + Cf::VEC_OFF);
  float* pb_s = ps_s + BN;
  float* dss_s = pb_s + BN;
  float* dsq_s = dss_s + npad;
  const int rows = (M + BM - 1) / BM, cols = (K + BN - 1) / BN;
  const int items = rows * cols * ((steps + per - 1) / per);
  const bool split = ws != nullptr;
  const bool relu_on = prologue && relu;  // relu applies only with one

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(&r.a_full[s], 1);
      mbar_init(&r.a_empty[s], 256);
      mbar_init(&r.b_full[s], 1);
      mbar_init(&r.b_empty[s], 256);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&r.x_full[b], 1);
      mbar_init(&r.x_empty[b], 1);
      mbar_init(&r.dx_full[b], 256);
    }
    mbar_fence_init();
  }
  // the block's column tile is fixed (gridDim.x is a multiple of the
  // column tiles without a split): its prologue constants, 0 past K
  const int n0_blk = blockIdx.x % cols * BN;
  for (int i = threadIdx.x; i < BN; i += THREADS) {
    const int k = n0_blk + i;
    ps_s[i] = k < K && prologue ? ps[k] : 0.0f;
    pb_s[i] = k < K && prologue ? pb[k] : 0.0f;
  }
  for (int i = threadIdx.x; i < npad; i += THREADS) {  // 0 past N
    dss_s[i] = i < N ? dss[i] : 0.0f;
    dsq_s[i] = i < N ? dsq[i] : 0.0f;
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      // ---------------------------------------------------- producer
      int gs = 0, ti = 0;  // the block's running step and tile counts
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Work w = work<BN>(item, rows, cols, steps, per);
        for (int j = 0; j < w.n_local; ++j, ++gs) {
          const int st = gs % Cf::STAGES;
          const int k0 = (w.s_begin + j) * BK;
          const int parity = (gs / Cf::STAGES - 1) & 1;
          if (gs >= Cf::STAGES) mbar_wait(&r.a_empty[st], parity);
          mbar_expect_tx(&r.a_full[st], Cf::A_BYTES);
          const uint32_t a_dst = sbase + st * Cf::A_BYTES;
          tma_load_2d(a_dst, &dymap, &r.a_full[st], k0, w.m0);
          tma_load_2d(a_dst + BOX, &ymap, &r.a_full[st], k0, w.m0);
          if (gs >= Cf::STAGES) mbar_wait(&r.b_empty[st], parity);
          mbar_expect_tx(&r.b_full[st], Cf::B_BYTES);
          tma_load_2d(sbase + Cf::B_OFF + st * Cf::B_BYTES, &wmap,
                      &r.b_full[st], k0, w.n0);
        }
        if (split) continue;
        // the tile's x, into the buffer that the tile before last used
        // (once its dx has been stored); without a prologue the buffer
        // only stages dx
        const int b = ti & 1, use = ti >> 1;
        if (use > 0) mbar_wait(&r.x_empty[b], (use - 1) & 1);
        if (prologue) {
          const int boxes = min(BN / 64, (K - w.n0 + 63) / 64);
          mbar_expect_tx(&r.x_full[b], boxes * BOX);
          for (int nb = 0; nb < boxes; ++nb)
            tma_load_2d(sbase + Cf::X_OFF + b * Cf::X_BYTES + nb * BOX,
                        &xmap, &r.x_full[b], w.n0 + 64 * nb, w.m0);
        } else {
          mbar_arrive(&r.x_full[b]);
        }
        ++ti;
      }
    } else if (threadIdx.x == STORER && !split) {
      // ------------------------------------------------------ storer
      int ti = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++ti) {
        const Work w = work<BN>(item, rows, cols, steps, per);
        const int b = ti & 1;
        mbar_wait(&r.dx_full[b], (ti >> 1) & 1);
        for (int nb = 0; nb < BN / 64; ++nb)
          if (w.n0 + 64 * nb < K)
            tma_store_2d(&dxmap, sbase + Cf::X_OFF + b * Cf::X_BYTES +
                                     nb * BOX,
                         w.n0 + 64 * nb, w.m0);
        tma_store_commit();
        tma_store_wait_read();
        mbar_arrive(&r.x_empty[b]);
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rw = 64 * wgi + 16 * warp;  // the warp's first row
    const int lrow = rw + (lane & 15), lhalf = lane >> 4;
    float acc[BN / 2];
    // two register sets of A alternate, so step j's ytot is formed while
    // step j - 1's wgmmas are in flight
    uint32_t a0[4][4], a1[4][4];
    // the thread's running sums of g * x and g over its rows of every
    // tile of the block, per column pair (8j + 2t + e at 2j + e)
    float col_gx[BN / 4], col_g[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) col_gx[i] = col_g[i] = 0.0f;
    int gs = 0, ti = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Work w = work<BN>(item, rows, cols, steps, per);
      // rows past M: 0 after ytot
      const uint32_t keep0 = w.m0 + rw + g < M ? ~0u : 0u;
      const uint32_t keep1 = w.m0 + rw + g + 8 < M ? ~0u : 0u;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      reg_fence(acc);
      for (int j = 0; j < w.n_local; j += 2) {
        consume_step<BN>(acc, a0, gs + j, j == 0, (w.s_begin + j) * BK,
                         sbase, r, dss_s, dsq_s, keep0, keep1, lrow, lhalf,
                         t);
        if (j + 1 < w.n_local)
          consume_step<BN>(acc, a1, gs + j + 1, false,
                           (w.s_begin + j + 1) * BK, sbase, r, dss_s, dsq_s,
                           keep0, keep1, lrow, lhalf, t);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      gs += w.n_local;
      mbar_arrive(&r.b_empty[(gs - 1) % Cf::STAGES]);

      if (split) {  // a slice: its f32 partial tile
        wgbn::store_slice<BN>(acc, ws, w.z, w.m0, w.n0, M, K, rw, g, t);
        continue;
      }
      // epilogue: g and dx from acc and the x tile (dx in x's place),
      // then hand the tile to the storer
      const int b = ti & 1;
      mbar_wait(&r.x_full[b], (ti >> 1) & 1);
      unsigned char* xt = smem + Cf::X_OFF + b * Cf::X_BYTES;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(ps_s + 8 * j + 2 * t);
        const float2 bb =
            *reinterpret_cast<const float2*>(pb_s + 8 * j + 2 * t);
        float gx[2], gg[2];
        wgbn::dgrad8<BN>(acc, xt, j, rw, g, t, s, bb, prologue, relu_on, gx,
                         gg);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          col_gx[2 * j + e] += gx[e];
          col_g[2 * j + e] += gg[e];
        }
      }
      fence_proxy_async();  // the dx tile is read by the TMA stores
      mbar_arrive(&r.dx_full[b]);
      ++ti;
    }
    if (!split && prologue) {
      // the block's row of column partials, reduced in a fixed order in
      // the A ring, which no step reads any more once both warpgroups
      // are past their last one
      float* red_s = reinterpret_cast<float*>(smem);
      float* red_q = red_s + 8 * BN;
      named_sync(1, 256);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wgbn::warp_col(col_gx[2 * j + e], col_g[2 * j + e], red_s, red_q,
                         (4 * wgi + warp) * BN + 8 * j + 2 * t + e, g);
      named_sync(1, 256);
      // the blocks of column tile nt = blockIdx.x % cols fill its
      // columns of rows 0 .. gridDim.x / cols - 1, one row each
      const int col = threadIdx.x;  // 0..255 over both warpgroups
      const int n = n0_blk + col;
      if (col < BN && n < K) {
        float s, q;
        wgbn::reduce_tile<BN>(red_s, red_q, col, s, q);
        const size_t o = static_cast<size_t>(blockIdx.x / cols) * K + n;
        part_gx[o] = s;
        part_g[o] = q;
      }
    }
  }
}

template <int BN>
int launch(const void* dy, const void* y, const float* dss, const float* dsq,
           const void* w, const void* x, const float* ps, const float* pb,
           void* dx, float* ws, float* part_gx, float* part_g, float* dps,
           float* dpb, int M, int K, int N, int prologue, int relu, int per,
           int blocks, cudaStream_t stream) {
  using Cf = Cfg<BN>;
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_dgrad_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int steps = (N + BK - 1) / BK;
  const int slices = (steps + per - 1) / per;
  const int smem = Cf::bytes(steps * BK);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap dymap, ymap, wmap, xmap, dxmap;
  const cuuint64_t ndims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t nstrides[1] = {2ull * N};
  const cuuint32_t box[2] = {BK, BM};
  int err = hopper::make_map<2>(&dymap, dy, ndims, nstrides, box, 128);
  if (err) return err;
  err = hopper::make_map<2>(&ymap, y, ndims, nstrides, box, 128);
  if (err) return err;
  // W (K, N) as K rows of N: a (BN, 64) box is a K-major B tile
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K)};
  const cuuint32_t wbox[2] = {BK, BN};
  err = hopper::make_map<2>(&wmap, w, wdims, nstrides, wbox, 128);
  if (err) return err;
  const cuuint64_t kdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t kstrides[1] = {2ull * K};
  err = hopper::make_map<2>(&xmap, x, kdims, kstrides, box, 128);
  if (err) return err;
  err = hopper::make_map<2>(&dxmap, dx, kdims, kstrides, box, 128);
  if (err) return err;
  // persistent: `blocks` (at most one per SM and per work item, and
  // without a split a multiple of the column tiles)
  mm_dgrad_wgmma<BN><<<blocks, THREADS, smem, stream>>>(
      dymap, ymap, wmap, xmap, dxmap, dss, dsq, ps, pb,
      slices > 1 ? ws : nullptr, part_gx, part_g, M, K, N, prologue, relu,
      per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return wgbn::dgrad_finish(ws, x, ps, pb, dx, part_gx, part_g, dps, dpb, M,
                            K, slices, blocks / ((K + BN - 1) / BN), prologue,
                            relu, stream);
}

}  // namespace wg

}  // namespace

// x (M, K), w = W (K, N) as it lies, dy/y (M, N); dx (M, K), d_ps/d_pb
// (K,).  `ws` is the (slices, M, K) f32 workspace (unused with one
// slice), `bn` the column tile, `per` the reduction steps of 64 per slice
// and `blocks` the persistent grid (without a split a multiple of the
// column tiles); part_gx/part_g hold max(blocks, ceil(M / 128)) rows.
extern "C" int fused_matmul_bn_dgrad_bf16(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* w, const void* x, const float* ps, const float* pb, void* dx,
    float* ws, float* part_gx, float* part_g, float* dps, float* dpb, int M,
    int K, int N, int prologue, int relu, int bn, int per, int blocks,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return wg::launch<64>(dy, y, dss, dsq, w, x, ps, pb, dx, ws, part_gx,
                            part_g, dps, dpb, M, K, N, prologue, relu, per,
                            blocks, s);
    case 128:
      return wg::launch<128>(dy, y, dss, dsq, w, x, ps, pb, dx, ws, part_gx,
                             part_g, dps, dpb, M, K, N, prologue, relu, per,
                             blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 path: wt = W^T (N, K) contiguous; part_gx/part_g hold
// ceil(M / 128) rows.  ws, bn, per and blocks are ignored.
extern "C" int fused_matmul_bn_dgrad_f32(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* wt, const void* x, const float* ps, const float* pb, void* dx,
    float* /*ws*/, float* part_gx, float* part_g, float* dps, float* dpb,
    int M, int K, int N, int prologue, int relu, int /*bn*/, int /*per*/,
    int /*blocks*/, void* stream) {
  return fgbn::launch_dgrad<float, false>(
      dy, y, dss, dsq, wt, x, ps, pb, dx, part_gx, part_g, dps, dpb, M, N, K,
      prologue, relu, fgbn::ConvGeom{0, 0, 0},
      static_cast<cudaStream_t>(stream));
}
