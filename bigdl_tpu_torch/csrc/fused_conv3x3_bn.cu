// fused_conv3x3_bn: 3x3 stride-1 SAME convolution, NHWC input and HWIO
// weight, with the BatchNorm prologue [relu](x * ps + pb) and the
// statistics epilogue of fused_matmul_bn.
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/fused_matmul.py
// `_conv3_kernel` (launched by `_conv3_pallas`, public
// `fused_conv3x3_bn`).  In ResNet-50 it runs the 13 stride-1 3x3
// convolutions of the fused bottleneck blocks.
//
// The TPU kernel holds whole padded images in 60-100 MB of VMEM and
// runs 9 shifted matmuls.  A Hopper block has 227 KB of shared memory,
// so this is an implicit GEMM instead: rows are output pixels (B*H*W),
// the reduction index is (dh, dw, c) in the HWIO order, so the weight is
// already the (9*C, Co) matrix, and columns are output channels.
//
// What bounds it on an H100: 18*M*C*Co operations over
// 2*(M*C + 9*C*Co + M*Co) bytes is 190-1500 ops per byte at ResNet-50's
// shapes (C = Co = 64-512), so the narrowest stage is near the ridge and
// the rest are bound by the tensor cores.  At batch 32 the deep stages
// are too small to fill the card: (32, 7, 7, 512, 512) has 13 row tiles
// of 128 pixels and 4608 reduction steps per row, so a plain tiling
// leaves most SMs idle while a few walk K serially.
//
// bf16: a warp-specialised wgmma kernel (384 threads).  A block owns 128
// pixels x BN output channels (BN = 64, 128 or 256; two blocks per SM at
// 64) and a slice of the reduction, walked in steps of one tap and 64
// channels, taps innermost:
// - one producer thread keeps two rings full with TMA loads, each stage
//   signalled on an mbarrier: x windows (a 2-D map over x as (C, M): the
//   136 pixels from the tile's first pixel shifted by (dh - 1) rows and
//   one column back, 64 channels; one window serves the three taps of a
//   kernel row, pixel r of the tile at window row r + dw) and (64, BN)
//   weight tiles (a 2-D map over w as (Co, 9C)), both in the 128-byte
//   swizzle, zero past the tensors' ends.  A tap that leaves the image
//   reads a neighbouring pixel, which the consumers zero.  (A producer
//   warpgroup of cp.async copies, 16 bytes per thread and instruction,
//   could not keep the consumers fed);
// - two consumer warpgroups own 64 rows each.  Per step a consumer reads
//   its raw x fragments with ldmatrix, applies the prologue in f32 (a
//   separate multiply and add, branch-free), writes 0 where the tap falls
//   outside the image (a per-row, per-tap mask decoded once per block:
//   the zero halo comes AFTER the prologue, never relu(pb)), rounds to
//   bf16 and issues wgmma m64nBNk16 with this A from registers and the
//   weight tile as an MN-major shared-memory operand (the HWIO rows are
//   N-contiguous, so nothing is transposed).  Two register sets of A
//   alternate, so step k+1's prologue runs while step k's products do;
// - the plan (ops/fused_matmul.py `_conv3_plan`) splits the reduction
//   into slices (gridDim.z, whole x windows each) where the output tiles
//   alone would not fill the card.  A split block writes its f32 partial
//   tile to a workspace; split_sum (wgmma_bn.cuh) then adds the slices
//   in a fixed order, rounds y once and takes the column partials of the
//   summed f32 values.  No atomics: the result is the same on every run.
// Epilogue without a split: y rounded once from the f32 accumulator into
// a swizzled tile in shared memory and written by TMA stores, and the
// tile's column sums of acc and acc^2 reduced in a fixed order (one row
// of partials per 128-pixel tile); colsum_kernel then sums the rows.
//
// f32 (evaluation) runs the shared FMA tiles of fused_gemm_bn.cuh: a
// TF32 wgmma would change its numbers.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.  `ws` is
// the (slices, M, Co) f32 workspace (unused with one slice), `bn` the
// column tile and `per` the reduction steps per slice (a multiple of 3);
// the f32 entry point ignores all three.
#include "fused_gemm_bn.cuh"
#include "hopper.cuh"
#include "wgmma_bn.cuh"

namespace {

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;  // pixels per block: two consumer warpgroups
constexpr int BK = 64;   // channels per reduction step
constexpr int WIN = 136;  // window rows: BM + 2 for the dw shifts, padded
constexpr int A_STAGES = 3;  // x windows in flight (3 steps each)
constexpr int B_STAGES = 4;  // weight tiles in flight (1 step each)
constexpr int THREADS = 384;
constexpr int MAX_SMEM = 232448;  // the most a block may ask for

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = WIN * BK * 2;  // one x window
  static constexpr int B_BYTES = BK * BN * 2;   // one weight tile
  static constexpr int B_OFF = A_STAGES * A_BYTES;
  static constexpr int BAR_OFF = B_OFF + B_STAGES * B_BYTES;
  static constexpr int VEC_OFF = BAR_OFF + 16 * (A_STAGES + B_STAGES);
  // + 1 KB to align the base to the 1024-byte swizzle atom
  static int bytes(int cpad) { return VEC_OFF + 8 * cpad + 1024; }
  // two blocks per SM at BN = 64 (their rings fit twice in shared memory)
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  // per-thread registers after setmaxnreg: producer, consumers
  static constexpr int PRODUCER_REGS = BN == 64 ? 24 : 40;
  static constexpr int CONSUMER_REGS = BN == 64 ? 104 : 232;
};

// Shared memory of the x-window and weight rings and their barriers.
struct Ring {
  uint32_t base;
  uint64_t *a_full, *a_empty, *b_full, *b_empty;
};

// Reduction step j of a consumer warpgroup (step s_begin + j: channels
// from (step / 9) * 64, tap step % 9): wait for its x window (on the
// window's first tap) and weight tile, build A in `a`, release the
// window after its third tap (ldmatrix has read it), wait for step
// j - 1's wgmmas and release their weight tile, issue step j.
template <int BN>
__device__ __forceinline__ void consume_step(float (&acc)[BN / 2],
                                             uint32_t (&a)[4][4], int j,
                                             int s_begin, const Ring& r,
                                             const float* ps_s,
                                             const float* pb_s,
                                             const uint32_t (&vmask)[2],
                                             int lrow, int lhalf, int t,
                                             bool relu) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  const int tap = (s_begin + j) % 9, c0 = (s_begin + j) / 9 * BK;
  const int wi = j / 3, ast = wi % A_STAGES, bst = j % B_STAGES;
  if (tap % 3 == 0) mbar_wait(&r.a_full[ast], (wi / A_STAGES) & 1);
  // the tile's pixel r at window row r + dw; 0 where the tap leaves the
  // image (all ones in keep where it is inside)
  wgbn::build_a(a, c0, r.base + ast * Cf::A_BYTES, lrow + tap % 3, lhalf, t,
                ps_s, pb_s, 0u - ((vmask[0] >> tap) & 1),
                0u - ((vmask[1] >> tap) & 1), relu);
  if (tap % 3 == 2) mbar_arrive(&r.a_empty[ast]);
  mbar_wait(&r.b_full[bst], (j / B_STAGES) & 1);
  if (j > 0) {
    wgmma_wait<0>();
    mbar_arrive(&r.b_empty[(j - 1) % B_STAGES]);
  }
  wgbn::issue<BN>(acc, a, r.base + Cf::B_OFF + bst * Cf::B_BYTES);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Cfg<BN>::MIN_BLOCKS)
    conv3_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap ymap,
                const float* __restrict__ ps, const float* __restrict__ pb,
                float* __restrict__ ws,
                float* __restrict__ part_sum, float* __restrict__ part_sq,
                int M, int H, int W, int C, int Co, int prologue, int relu,
                int per) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(smem + Cf::BAR_OFF);
  uint64_t* a_empty = a_full + A_STAGES;
  uint64_t* b_full = a_empty + A_STAGES;
  uint64_t* b_empty = b_full + B_STAGES;
  const int nch = (C + BK - 1) / BK, cpad = nch * BK;
  float* ps_s = reinterpret_cast<float*>(smem + Cf::VEC_OFF);
  float* pb_s = ps_s + cpad;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool relu_on = prologue && relu;  // relu applies only with one
  const int s_begin = blockIdx.z * per;
  const int n_local = min(9 * nch, s_begin + per) - s_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 256);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 256);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < cpad; i += THREADS) {  // 0 past C
    ps_s[i] = i >= C ? 0.0f : prologue ? ps[i] : 1.0f;
    pb_s[i] = i >= C || !prologue ? 0.0f : pb[i];
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------ producer
    regs_dec<Cf::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int j = 0; j < n_local; ++j) {
        const int step = s_begin + j, tap = step % 9;
        const int c0 = step / 9 * BK;
        if (tap % 3 == 0) {
          // x as (C, M): the window of pixels m0 + (dh - 1) W - 1 + r,
          // r < WIN, serves the three taps of row dh.  Pixels whose shift
          // leaves the image are read from a neighbour (or as 0 past
          // either end) and zeroed by the consumers' validity mask.
          const int wi = j / 3, st = wi % A_STAGES;
          if (wi >= A_STAGES)
            mbar_wait(&a_empty[st], (wi / A_STAGES - 1) & 1);
          mbar_expect_tx(&a_full[st], Cf::A_BYTES);
          tma_load_2d(sbase + st * Cf::A_BYTES, &xmap, &a_full[st], c0,
                      m0 + (tap / 3 - 1) * W - 1);
        }
        // w as (Co, 9C): 64 reduction rows, BN columns in blocks of 64
        const int st = j % B_STAGES;
        if (j >= B_STAGES) mbar_wait(&b_empty[st], (j / B_STAGES - 1) & 1);
        mbar_expect_tx(&b_full[st], Cf::B_BYTES);
        const uint32_t b_dst = sbase + Cf::B_OFF + st * Cf::B_BYTES;
#pragma unroll
        for (int nb = 0; nb < BN / 64; ++nb)
          tma_load_2d(b_dst + nb * BK * 128, &wmap, &b_full[st],
                      n0 + 64 * nb, tap * C + c0);
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    regs_inc<Cf::CONSUMER_REGS>();
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rw = 64 * wgi + 16 * warp;  // the warp's first row
    // bit `tap` set where row rw + g (+ 8) reads inside the image
    uint32_t vmask[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + rw + g + 8 * i;
      const int ow = m % W, oh = (m / W) % H;
      uint32_t mask = 0;
      if (m < M) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ih = oh + tap / 3 - 1, iw = ow + tap % 3 - 1;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W) mask |= 1u << tap;
        }
      }
      vmask[i] = mask;
    }
    const int lrow = rw + (lane & 15), lhalf = lane >> 4;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    reg_fence(acc);
    // two register sets of A alternate, so step j's prologue runs while
    // step j - 1's wgmmas are in flight
    uint32_t a0[4][4], a1[4][4];
    const Ring ring{sbase, a_full, a_empty, b_full, b_empty};
    for (int j = 0; j < n_local; j += 2) {
      consume_step<BN>(acc, a0, j, s_begin, ring, ps_s, pb_s, vmask, lrow,
                       lhalf, t, relu_on);
      if (j + 1 < n_local)
        consume_step<BN>(acc, a1, j + 1, s_begin, ring, ps_s, pb_s, vmask,
                         lrow, lhalf, t, relu_on);
    }
    wgmma_wait<0>();
    reg_fence(acc);

    if (ws != nullptr) {  // a slice: its f32 partial tile
      wgbn::store_slice<BN>(acc, ws, blockIdx.z, m0, n0, M, Co, rw, g, t);
      return;
    }

    // epilogue: y rounded once into a swizzled (128, BN) tile in shared
    // memory the ring no longer needs, written out by TMA stores (rows
    // past M and columns past Co are clipped); the column sums of acc and
    // acc^2 over the tile's rows, reduced in a fixed order
    named_sync(1, 256);  // both warpgroups are done with the ring
    unsigned char* ytile = smem;
    float* red_s = reinterpret_cast<float*>(smem + BM * BN * 2);
    float* red_q = red_s + 8 * BN;
    wgbn::stage_tile<BN>(acc, ytile, red_s, red_q, wgi, warp, rw, g, t);
    fence_proxy_async();  // the y tile is read by the TMA stores
    named_sync(1, 256);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int nb = 0; nb < BN / 64; ++nb)
        tma_store_2d(&ymap, smem_u32(ytile) + nb * BM * 128, n0 + 64 * nb,
                     m0);
      tma_store_commit();
    }
    const int col = threadIdx.x;  // 0..255 over both warpgroups
    if (col < BN && n0 + col < Co) {
      float s, q;
      wgbn::reduce_tile<BN>(red_s, red_q, col, s, q);
      const size_t o = static_cast<size_t>(blockIdx.x) * Co + n0 + col;
      part_sum[o] = s;
      part_sq[o] = q;
    }
    if (threadIdx.x == 0) tma_store_wait_read();  // before the block exits
  }
}

template <int BN>
int launch(const void* x, const void* w, const float* ps, const float* pb,
           void* y, float* ws, float* part_sum, float* part_sq, float* ssum,
           float* ssq, int M, int H, int W, int C, int Co, int prologue,
           int relu, int per, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int nch = (C + BK - 1) / BK;
  const int slices = (9 * nch + per - 1) / per;
  CUtensorMap xmap, wmap, ymap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {2ull * C};
  const cuuint32_t xbox[2] = {BK, WIN};
  int err = hopper::make_map<2>(&xmap, x, xdims, xstrides, xbox, 128);
  if (err) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(Co),
                               static_cast<cuuint64_t>(9 * C)};
  const cuuint64_t wstrides[1] = {2ull * Co};
  const cuuint32_t wbox[2] = {64, BK};
  err = hopper::make_map<2>(&wmap, w, wdims, wstrides, wbox, 128);
  if (err) return err;
  const cuuint64_t ydims[2] = {static_cast<cuuint64_t>(Co),
                               static_cast<cuuint64_t>(M)};
  const cuuint32_t ybox[2] = {64, BM};
  err = hopper::make_map<2>(&ymap, y, ydims, wstrides, ybox, 128);
  if (err) return err;
  const dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN, slices);
  conv3_wgmma<BN><<<grid, THREADS, Cfg<BN>::bytes(nch * BK), stream>>>(
      xmap, wmap, ymap, ps, pb, slices > 1 ? ws : nullptr,
      part_sum, part_sq, M, H, W, C, Co, prologue, relu, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return wgbn::finish(ws, y, part_sum, part_sq, ssum, ssq, M, Co, slices,
                      grid.x, stream);
}

}  // namespace wg

}  // namespace

extern "C" int fused_conv3x3_bn_bf16(const void* x, const void* w,
                                     const float* ps, const float* pb,
                                     void* y, float* ws, float* part_sum,
                                     float* part_sq, float* ssum, float* ssq,
                                     int B, int H, int W, int C, int Co,
                                     int prologue, int relu, int bn, int per,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  switch (bn) {
    case 64:
      return wg::launch<64>(x, w, ps, pb, y, ws, part_sum, part_sq, ssum, ssq,
                            M, H, W, C, Co, prologue, relu, per, s);
    case 128:
      return wg::launch<128>(x, w, ps, pb, y, ws, part_sum, part_sq, ssum,
                             ssq, M, H, W, C, Co, prologue, relu, per, s);
    case 256:
      return wg::launch<256>(x, w, ps, pb, y, ws, part_sum, part_sq, ssum,
                             ssq, M, H, W, C, Co, prologue, relu, per, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_conv3x3_bn_f32(const void* x, const void* w,
                                    const float* ps, const float* pb, void* y,
                                    float* /*ws*/, float* part_sum,
                                    float* part_sq, float* ssum, float* ssq,
                                    int B, int H, int W, int C, int Co,
                                    int prologue, int relu, int /*bn*/,
                                    int /*per*/, void* stream) {
  return fgbn::launch<float, true>(x, w, ps, pb, y, part_sum, part_sq, ssum,
                                   ssq, B * H * W, 9 * C, Co, prologue, relu,
                                   fgbn::ConvGeom{H, W, C},
                                   static_cast<cudaStream_t>(stream));
}
