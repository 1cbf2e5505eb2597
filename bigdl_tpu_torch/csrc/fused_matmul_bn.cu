// fused_matmul_bn: y = [relu](x * ps + pb) @ W with per-column sums of
// the f32 accumulator and of its square.
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/fused_matmul.py
// `_fwd_kernel` (launched by `_fwd_pallas`, public `fused_matmul_bn`).
// In ResNet-50 it runs every 1x1 convolution and projection shortcut of
// the fused bottleneck blocks (x is NHWC flattened to (B*H*W, C)).
//
// What bounds it on an H100: at ResNet-50's shapes K and N are 64-2048,
// so 2*M*K*N operations over 2*(M*K + K*N + M*N) bytes is 21-410 ops per
// byte; the narrow early layers (K, N = 64-256) sit below the card's
// ~295 ops/byte ridge and are bound by memory, the wide late ones by the
// tensor cores.  The prologue applies the previous BatchNorm on the way
// into the product, so the normalised activation is never written, and
// the statistics come from the accumulator, so BatchNorm costs no extra
// pass over y.
//
// bf16: kernel 4's design (fused_conv3x3_bn.cu) with one tap and no
// halo, made persistent.  One block of 384 threads per SM walks output
// tiles of 128 rows x BN columns (BN = 64 or 128), each over a slice of
// the reduction in steps of 64:
// - one producer thread keeps two rings full with TMA loads: (128 rows,
//   64 K) x tiles and (64 K, BN) weight tiles, 128-byte swizzle, zero
//   past the tensors' ends.  It runs on into the next tile's steps while
//   the consumers finish the last one, so at K = 64 (one step per tile)
//   the loads of one tile overlap the epilogue of the one before;
// - two consumer warpgroups own 64 rows each.  Per step a consumer reads
//   its raw x fragments with ldmatrix and releases the x stage, applies
//   the prologue in f32 registers (wgmma_bn.cuh prologue2), zeroes rows
//   past M AFTER the prologue (prologue(0) = relu(pb) is not 0), rounds
//   to bf16 and issues wgmma m64nBNk16 with the weight tile as an
//   MN-major operand (W's rows are N-contiguous: nothing is transposed).
//   Two register sets of A alternate, so step k+1's prologue runs while
//   step k's products do;
// - the plan (ops/fused_matmul.py `_matmul_plan`) splits the reduction
//   into slices where the output tiles alone would not fill the card.  A
//   split tile writes its f32 partial to a workspace, and split_sum
//   (wgmma_bn.cuh) adds the slices in slice order, rounds y once and
//   takes the column partials of the sums.  No atomics: the result is
//   the same on every run, so the forward that remat recomputes equals
//   the first one.
// Epilogue without a split: y rounded once into a swizzled staging tile
// of its own (not the ring, which the producer is refilling), written by
// TMA stores; a tile's staging waits until the TMA store of the block's
// previous tile has read it.  The column sums of acc and acc^2 run on in
// registers over all the block's tiles (its tiles share one column
// tile), and the block writes its columns of one row of partials at its
// end, reduced in a fixed order; colsum_kernel then sums the rows.
// (Reducing each tile's sums across the warp's rows, 192 shuffles a
// thread per 128-column tile, held up the consumers at K = 64, where a
// tile is one step.)
//
// f32 (evaluation) runs the FMA tiles of fused_gemm_bn.cuh: a TF32
// wgmma would change its numbers.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.  `ws` is
// the (slices, M, N) f32 workspace (unused with one slice), `bn` the
// column tile, `per` the reduction steps of 64 per slice and `blocks` the
// persistent grid (without a split a multiple of the column tiles);
// part_sum/part_sq hold max(blocks, ceil(M / 128)) rows.
// The f32 entry point ignores ws, bn, per and blocks.
#include "fused_gemm_bn.cuh"
#include "hopper.cuh"
#include "wgmma_bn.cuh"

namespace {

namespace wg {

using wgbn::BM;  // rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;  // reduction step: one 128-byte swizzled row
constexpr int THREADS = 384;
constexpr int MAX_SMEM = 232448;  // the most a block may ask for

template <int BN>
struct Cfg {
  static constexpr int STAGES = 4;  // both rings
  static constexpr int A_BYTES = BM * BK * 2;  // one x tile
  static constexpr int B_BYTES = BK * BN * 2;  // one weight tile
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int Y_OFF = B_OFF + STAGES * B_BYTES;  // y staging
  static constexpr int RED_OFF = Y_OFF + BM * BN * 2;
  static constexpr int BAR_OFF = RED_OFF + 2 * 8 * BN * 4;
  static constexpr int VEC_OFF = BAR_OFF + 32 * STAGES;  // 4 barriers
  // + 1 KB to align the base to the 1024-byte swizzle atom
  static int bytes(int kpad) { return VEC_OFF + 8 * kpad + 1024; }
};
// per-thread registers after setmaxnreg: producer, consumers.  One block
// per SM: two (at 80 registers a thread) spilled the persistent loop's
// state at BN = 64.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// One work item: output tile (mt, nt) over reduction slice z, steps
// [s_begin, s_begin + n_local).  Items run with the column tile
// innermost, so the blocks in flight share x rows in L2.
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

// Shared memory of the two rings and their barriers.
struct Ring {
  uint32_t base;
  uint64_t *a_full, *a_empty, *b_full, *b_empty;
};

// Step `gs` of the block's running step count (ring stage gs % STAGES),
// channels from c0: wait for its x tile, build A, release the x tile
// (ldmatrix has read it), wait for its weight tile, wait for the
// previous step's wgmmas and release their weight tile (unless this is
// a tile's first step), issue the 4 wgmmas as one commit group.
template <int BN>
__device__ __forceinline__ void consume_step(
    float (&acc)[BN / 2], uint32_t (&a)[4][4], int gs, bool first, int c0,
    const Ring& r, const float* ps_s, const float* pb_s, uint32_t keep0,
    uint32_t keep1, int lrow, int lhalf, int t, bool relu) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  const int st = gs % Cf::STAGES, parity = (gs / Cf::STAGES) & 1;
  mbar_wait(&r.a_full[st], parity);
  wgbn::build_a(a, c0, r.base + st * Cf::A_BYTES, lrow, lhalf, t, ps_s, pb_s,
                keep0, keep1, relu);
  mbar_arrive(&r.a_empty[st]);
  mbar_wait(&r.b_full[st], parity);
  if (!first) {
    wgmma_wait<0>();
    mbar_arrive(&r.b_empty[(gs - 1) % Cf::STAGES]);
  }
  wgbn::issue<BN>(acc, a, r.base + Cf::B_OFF + st * Cf::B_BYTES);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    mm_wgmma(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap ymap,
             const float* __restrict__ ps, const float* __restrict__ pb,
             float* __restrict__ ws, float* __restrict__ part_sum,
             float* __restrict__ part_sq, int M, int K, int N, int prologue,
             int relu, int per) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(smem + Cf::BAR_OFF);
  uint64_t* a_empty = a_full + Cf::STAGES;
  uint64_t* b_full = a_empty + Cf::STAGES;
  uint64_t* b_empty = b_full + Cf::STAGES;
  const int steps = (K + BK - 1) / BK, kpad = steps * BK;
  float* ps_s = reinterpret_cast<float*>(smem + Cf::VEC_OFF);
  float* pb_s = ps_s + kpad;
  const int rows = (M + BM - 1) / BM, cols = (N + BN - 1) / BN;
  const int items = rows * cols * ((steps + per - 1) / per);
  const bool relu_on = prologue && relu;  // relu applies only with one

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 256);
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 256);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < kpad; i += THREADS) {  // 0 past K
    ps_s[i] = i >= K ? 0.0f : prologue ? ps[i] : 1.0f;
    pb_s[i] = i >= K || !prologue ? 0.0f : pb[i];
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------ producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int gs = 0;  // the block's running step count
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Work w = work<BN>(item, rows, cols, steps, per);
        // weight boxes that start inside N (a box past N is not loaded;
        // its columns are never stored)
        const int boxes = min(BN / 64, (N - w.n0 + 63) / 64);
        for (int j = 0; j < w.n_local; ++j, ++gs) {
          const int st = gs % Cf::STAGES;
          const int k0 = (w.s_begin + j) * BK;
          const int parity = (gs / Cf::STAGES - 1) & 1;
          if (gs >= Cf::STAGES) mbar_wait(&a_empty[st], parity);
          mbar_expect_tx(&a_full[st], Cf::A_BYTES);
          tma_load_2d(sbase + st * Cf::A_BYTES, &xmap, &a_full[st], k0,
                      w.m0);
          if (gs >= Cf::STAGES) mbar_wait(&b_empty[st], parity);
          mbar_expect_tx(&b_full[st], boxes * BK * 128);
          const uint32_t b_dst = sbase + Cf::B_OFF + st * Cf::B_BYTES;
          for (int nb = 0; nb < boxes; ++nb)
            tma_load_2d(b_dst + nb * BK * 128, &wmap, &b_full[st],
                        w.n0 + 64 * nb, k0);
        }
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
    unsigned char* ytile = smem + Cf::Y_OFF;
    float* red_s = reinterpret_cast<float*>(smem + Cf::RED_OFF);
    float* red_q = red_s + 8 * BN;
    const Ring ring{sbase, a_full, a_empty, b_full, b_empty};
    float acc[BN / 2];
    // two register sets of A alternate, so step j's prologue runs while
    // step j - 1's wgmmas are in flight
    uint32_t a0[4][4], a1[4][4];
    // the thread's running sums of acc and acc^2 over its rows of every
    // tile of the block, per column pair (8j + 2t + e at 2j + e); the
    // block's tiles share one column tile (gridDim.x is a multiple of
    // the column tiles), so one shuffle reduction per block, not per
    // tile, gives its row of partials
    float col_s[BN / 4], col_q[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) col_s[i] = col_q[i] = 0.0f;
    int gs = 0;
    bool staged = false;  // a TMA store of this block may be reading ytile
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Work w = work<BN>(item, rows, cols, steps, per);
      // rows past M: 0 after the prologue
      const uint32_t keep0 = w.m0 + rw + g < M ? ~0u : 0u;
      const uint32_t keep1 = w.m0 + rw + g + 8 < M ? ~0u : 0u;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      reg_fence(acc);
      for (int j = 0; j < w.n_local; j += 2) {
        consume_step<BN>(acc, a0, gs + j, j == 0, (w.s_begin + j) * BK,
                         ring, ps_s, pb_s, keep0, keep1, lrow, lhalf, t,
                         relu_on);
        if (j + 1 < w.n_local)
          consume_step<BN>(acc, a1, gs + j + 1, false,
                           (w.s_begin + j + 1) * BK, ring, ps_s, pb_s,
                           keep0, keep1, lrow, lhalf, t, relu_on);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      gs += w.n_local;
      mbar_arrive(&b_empty[(gs - 1) % Cf::STAGES]);

      if (ws != nullptr) {  // a slice: its f32 partial tile
        wgbn::store_slice<BN>(acc, ws, w.z, w.m0, w.n0, M, N, rw, g, t);
        continue;
      }
      // epilogue: the column sums (rows past M are 0), then y; the
      // staging tile waits until the previous tile's TMA store has read it
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float u = acc[4 * j + e], v = acc[4 * j + 2 + e];
          col_s[2 * j + e] += u + v;
          col_q[2 * j + e] += u * u + v * v;
        }
      }
      if (staged) {
        if (threadIdx.x == 0) tma_store_wait_read();
        named_sync(1, 256);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        wgbn::stage_y8<BN>(acc, ytile, j, rw, g, t);
      fence_proxy_async();  // the y tile is read by the TMA stores
      named_sync(1, 256);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int nb = 0; nb < BN / 64; ++nb)
          if (w.n0 + 64 * nb < N)
            tma_store_2d(&ymap, smem_u32(ytile) + nb * BM * 128,
                         w.n0 + 64 * nb, w.m0);
        tma_store_commit();
      }
      staged = true;
    }
    if (ws == nullptr) {
      // the block's row of column partials, reduced in a fixed order
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wgbn::warp_col(col_s[2 * j + e], col_q[2 * j + e], red_s, red_q,
                         (4 * wgi + warp) * BN + 8 * j + 2 * t + e, g);
      named_sync(1, 256);
      // the blocks of column tile nt = blockIdx.x % cols fill its
      // columns of rows 0 .. gridDim.x / cols - 1, one row each
      const int col = threadIdx.x;  // 0..255 over both warpgroups
      const int n = blockIdx.x % cols * BN + col;
      if (col < BN && n < N) {
        float s, q;
        wgbn::reduce_tile<BN>(red_s, red_q, col, s, q);
        const size_t o = static_cast<size_t>(blockIdx.x / cols) * N + n;
        part_sum[o] = s;
        part_sq[o] = q;
      }
    }
    if (threadIdx.x == 0) tma_store_wait_read();  // before the block exits
  }
}

template <int BN>
int launch(const void* x, const void* w, const float* ps, const float* pb,
           void* y, float* ws, float* part_sum, float* part_sq, float* ssum,
           float* ssq, int M, int K, int N, int prologue, int relu, int per,
           int blocks, cudaStream_t stream) {
  using Cf = Cfg<BN>;
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int steps = (K + BK - 1) / BK;
  const int slices = (steps + per - 1) / per;
  CUtensorMap xmap, wmap, ymap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {2ull * K};
  const cuuint32_t xbox[2] = {BK, BM};
  int err = hopper::make_map<2>(&xmap, x, xdims, xstrides, xbox, 128);
  if (err) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K)};
  const cuuint64_t nstrides[1] = {2ull * N};
  const cuuint32_t wbox[2] = {64, BK};
  err = hopper::make_map<2>(&wmap, w, wdims, nstrides, wbox, 128);
  if (err) return err;
  const cuuint64_t ydims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(M)};
  const cuuint32_t ybox[2] = {64, BM};
  err = hopper::make_map<2>(&ymap, y, ydims, nstrides, ybox, 128);
  if (err) return err;
  // persistent: `blocks` (at most one per SM and per work item, and
  // without a split a multiple of the column tiles)
  mm_wgmma<BN><<<blocks, THREADS, Cf::bytes(steps * BK), stream>>>(
      xmap, wmap, ymap, ps, pb, slices > 1 ? ws : nullptr, part_sum,
      part_sq, M, K, N, prologue, relu, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return wgbn::finish(ws, y, part_sum, part_sq, ssum, ssq, M, N, slices,
                      blocks / ((N + BN - 1) / BN), stream);
}

}  // namespace wg

}  // namespace

extern "C" int fused_matmul_bn_bf16(const void* x, const void* w,
                                    const float* ps, const float* pb, void* y,
                                    float* ws, float* part_sum,
                                    float* part_sq, float* ssum, float* ssq,
                                    int M, int K, int N, int prologue,
                                    int relu, int bn, int per, int blocks,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return wg::launch<64>(x, w, ps, pb, y, ws, part_sum, part_sq, ssum, ssq,
                            M, K, N, prologue, relu, per, blocks, s);
    case 128:
      return wg::launch<128>(x, w, ps, pb, y, ws, part_sum, part_sq, ssum,
                             ssq, M, K, N, prologue, relu, per, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_matmul_bn_f32(const void* x, const void* w,
                                   const float* ps, const float* pb, void* y,
                                   float* /*ws*/, float* part_sum,
                                   float* part_sq, float* ssum, float* ssq,
                                   int M, int K, int N, int prologue,
                                   int relu, int /*bn*/, int /*per*/,
                                   int /*blocks*/, void* stream) {
  return fgbn::launch<float, false>(x, w, ps, pb, y, part_sum, part_sq, ssum,
                                    ssq, M, K, N, prologue, relu,
                                    fgbn::ConvGeom{0, 0, 0},
                                    static_cast<cudaStream_t>(stream));
}
