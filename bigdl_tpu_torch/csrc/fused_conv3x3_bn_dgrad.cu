// fused_conv3x3_bn_dgrad: the data gradient of fused_conv3x3_bn, a
// transposed 3x3 stride-1 SAME convolution of
//   ytot = dy + dssum + 2 * y * dssq      (f32, rounded to dy's type)
// with the zero halo applied to ytot, then the prologue's backward and
// the d_ps/d_pb reductions of fused_matmul_bn_dgrad:
//   acc[p, ci] = sum_{dh, dw, co} ytot[p + (dh-1, dw-1), co]
//                                 * w[2-dh, 2-dw, ci, co]
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/fused_matmul.py
// `_conv3_dgrad_kernel` (launched by `_conv3_dgrad_pallas` from
// `_conv3_bwd`).  In ResNet-50 training it runs once per stride-1 3x3
// convolution of the fused bottleneck blocks (13 per step).
//
// The TPU kernel holds whole padded images in VMEM and runs 9 shifted
// matmuls.  Here it is an implicit GEMM, as the forward is: rows are
// the B*H*W input pixels, the reduction index is (output-channel chunk,
// tap) with the taps innermost, and the columns are Ci.
//
// What bounds it on an H100: 18*M*Ci*Co operations over
// 2*(2*M*Co + 2*M*Ci + 9*Ci*Co) bytes is 140-670 ops per byte at
// ResNet-50's shapes (about 2.25 * C): the 64- and 128-channel stages
// sit below the card's ~295 ops/byte ridge, the wider ones are bound by
// the tensor cores.
//
// bf16: kernel 4's warp-specialised implicit GEMM (fused_conv3x3_bn.cu)
// with ytot as A.  A block of 384 threads owns 128 pixels x BN input
// channels (BN = 64 or 128) and a slice of the reduction, walked in
// steps of one tap and 64 output channels:
// - one producer thread keeps two rings full with TMA loads: dy and y
//   windows (2-D maps over dy and y as (Co, M): the 136 pixels from the
//   tile's first pixel shifted by (dh - 1) rows and one column back; one
//   window pair serves the three taps of a kernel row, pixel r of the
//   tile at window row r + dw) and the (BN ci, 64 co) tile of w for tap
//   (dh, dw): w (3, 3, Ci, Co) viewed as (9*Ci, Co) is read in place at
//   row ((2-dh)*3 + (2-dw))*Ci, a K-major B tile (Co contiguous), so no
//   flipped copy is made.  It also loads the block's (128, BN) x tile for
//   the epilogue once the rings are first filled;
// - two consumer warpgroups own 64 rows each.  When a window pair lands,
//   the 256 consumer threads form ytot over its 130 rows once, in f32 in
//   the plain version's order (wgmma_bn.cuh ytot2), rounded to bf16 and
//   written over the dy window in place, then meet at a named barrier:
//   the three taps that share the window read ytot, not dy and y, so
//   each pixel's ytot is formed once per 64-channel chunk instead of
//   three times, and a step's A build is 4 ldmatrix and a mask.  (Forming
//   ytot per tap in registers, from two raw fragments per A fragment,
//   took 0.900 ms per batch-32 ResNet-50 backward on an H100 at 700 W,
//   against 0.576 ms with the window pass.)  Per step
//   a consumer reads its ytot fragments with ldmatrix, writes 0 where the
//   tap falls outside the image (a per-row, per-tap mask decoded once per
//   block, applied AFTER ytot: TMA's zero fill gives ytot = dssum, never
//   0) and issues wgmma m64nBNk16 with A from registers and the w tile
//   K-major.  Two register sets of A alternate, so step k+1's A is read
//   while step k's products run;
// - the plan (ops/fused_matmul.py `_conv3_dgrad_plan`) splits the
//   reduction into slices (gridDim.z, whole windows each) only where the
//   output tiles leave three quarters of the SMs idle (no ResNet-50
//   shape at batch 32 or 256: there a split's f32 round trip cost more
//   than the SMs it filled).  A split block writes
//   its f32 partial tile to a workspace; dgrad_split_sum (wgmma_bn.cuh)
//   then adds the slices in a fixed order and only then applies the
//   prologue's backward.  No atomics: the result is the same on every run.
// Epilogue without a split (wgmma_bn.cuh dgrad8): g and dx from the f32
// accumulator and the x tile, dx written over x in shared memory and out
// by TMA stores; the tile's column sums of g * x and g reduced in a
// fixed order (one row of partials per 128-pixel tile); colsum_kernel
// then sums the rows.
//
// f32 (evaluation) runs the FMA tiles of fused_dgrad_bn.cuh on the
// flipped, io-swapped weight (3, 3, Co, Ci) that the wrapper copies: a
// TF32 wgmma would change its numbers.  Its A-tile gather forms ytot
// from dy and y once per tap.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_dgrad_bn.cuh"
#include "hopper.cuh"
#include "wgmma_bn.cuh"

namespace {

namespace wg {

using wgbn::BM;  // pixels per block: two consumer warpgroups of 64
constexpr int BK = 64;    // output channels per reduction step
constexpr int WIN = 136;  // window rows: BM + 2 for the dw shifts, padded
constexpr int WIN_BYTES = WIN * 128;  // one dy or y window
constexpr int YROWS = BM + 2;  // the window rows a tap reads
constexpr int THREADS = 384;
constexpr int MAX_SMEM = 232448;  // the most a block may ask for

template <int BN>
struct Cfg {
  // window pairs in flight (3 steps each), w tiles in flight (1 step
  // each): two blocks per SM at BN = 64 (kernel 4's occupancy there)
  static constexpr int A_STAGES = BN == 64 ? 2 : 3;
  static constexpr int B_STAGES = BN == 64 ? 3 : 4;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static constexpr int A_BYTES = 2 * WIN_BYTES;  // dy window, y window
  static constexpr int B_BYTES = BN * 128;       // one (BN, 64) w tile
  static constexpr int X_BYTES = BM * BN * 2;    // the x/dx tile
  static constexpr int B_OFF = A_STAGES * A_BYTES;
  static constexpr int X_OFF = B_OFF + B_STAGES * B_BYTES;
  static constexpr int BAR_OFF = X_OFF + X_BYTES;
  static constexpr int VEC_OFF = BAR_OFF + 8 * (2 * A_STAGES + 2 * B_STAGES + 2);
  // ps, pb of the block's columns, then dssum, dssq over cpad channels;
  // + 1 KB to align the base to the 1024-byte swizzle atom
  static int bytes(int cpad) { return VEC_OFF + 4 * (2 * BN + 2 * cpad) + 1024; }
  // per-thread registers after setmaxnreg: producer, consumers
  static constexpr int PRODUCER_REGS = BN == 64 ? 24 : 40;
  static constexpr int CONSUMER_REGS = BN == 64 ? 104 : 232;
};

// Shared memory of the rings and their barriers.
struct Ring {
  uint32_t base;
  uint64_t *a_full, *a_empty, *b_full, *b_empty;
};

// ytot over the rows 0 .. YROWS - 1 of a landed window pair (channels
// c0 .. c0 + 63), written over the dy window in place: consumer thread
// `tid` (0..255) owns the 16-byte chunk column tid % 8 of every 32nd row
// from tid / 8, so no two threads touch one chunk.
__device__ __forceinline__ void ytot_window(unsigned char* dyw,
                                            const unsigned char* yw, int c0,
                                            int tid, const float* dss_s,
                                            const float* dsq_s) {
  using namespace hopper;
  const int lc = tid % 8, c = c0 + 8 * lc;
  float2 s[4], q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = *reinterpret_cast<const float2*>(dss_s + c + 2 * i);
    q[i] = *reinterpret_cast<const float2*>(dsq_s + c + 2 * i);
  }
#pragma unroll
  for (int i = 0; i < (YROWS + 31) / 32; ++i) {
    const int row = tid / 8 + 32 * i;
    if (row < YROWS) {
      const uint32_t off = swz<128>(row, lc);
      uint4 d = *reinterpret_cast<const uint4*>(dyw + off);
      const uint4 v = *reinterpret_cast<const uint4*>(yw + off);
      d.x = wgbn::ytot2(d.x, v.x, s[0], q[0]);
      d.y = wgbn::ytot2(d.y, v.y, s[1], q[1]);
      d.z = wgbn::ytot2(d.z, v.z, s[2], q[2]);
      d.w = wgbn::ytot2(d.w, v.w, s[3], q[3]);
      *reinterpret_cast<uint4*>(dyw + off) = d;
    }
  }
}

// Reduction step j of a consumer warpgroup (step s_begin + j: output
// channels from (step / 9) * 64, tap step % 9): on the window's first
// tap wait for its window pair and form its ytot (both warpgroups, then
// a named barrier); read A from the ytot window and zero the taps that
// leave the image; release the windows after their third tap (ldmatrix
// has read them); wait for the w tile and for step j - 1's wgmmas and
// release their w tile; issue step j.  `prev` is step j - 1's A: it is
// kept live until its wgmmas are done, so the compiler cannot give its
// registers to this step's ldmatrix while the tensor cores still read
// them.
template <int BN>
__device__ __forceinline__ void consume_step(float (&acc)[BN / 2],
                                             uint32_t (&a)[4][4],
                                             uint32_t (&prev)[4][4], int j,
                                             int s_begin, const Ring& r,
                                             unsigned char* smem, int tid,
                                             const float* dss_s,
                                             const float* dsq_s,
                                             const uint32_t (&vmask)[2],
                                             int lrow, int lhalf) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  const int tap = (s_begin + j) % 9, c0 = (s_begin + j) / 9 * BK;
  const int wi = j / 3, ast = wi % Cf::A_STAGES, bst = j % Cf::B_STAGES;
  unsigned char* dyw = smem + ast * Cf::A_BYTES;
  if (tap % 3 == 0) {
    mbar_wait(&r.a_full[ast], (wi / Cf::A_STAGES) & 1);
    ytot_window(dyw, dyw + WIN_BYTES, c0, tid, dss_s, dsq_s);
    fence_proxy_async();  // the stores, before the TMA that refills them
    named_sync(1, 256);   // every row of the window's ytot is in place
  }
  // the tile's pixel r at window row r + dw; 0 where the tap leaves the
  // image (all ones in keep where it is inside)
  const uint32_t keep0 = 0u - ((vmask[0] >> tap) & 1);
  const uint32_t keep1 = 0u - ((vmask[1] >> tap) & 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ldmatrix_x4(smem_u32(dyw) + swz<128>(lrow + tap % 3, 2 * ks + lhalf),
                a[ks]);
    a[ks][0] &= keep0;
    a[ks][1] &= keep1;
    a[ks][2] &= keep0;
    a[ks][3] &= keep1;
  }
  if (tap % 3 == 2) mbar_arrive(&r.a_empty[ast]);
  mbar_wait(&r.b_full[bst], (j / Cf::B_STAGES) & 1);
  // unconditional (with nothing in flight it returns at once): behind
  // `if (j > 0)` ptxas serialised the wgmmas (C7513)
  wgmma_wait<0>();
  reg_fence(prev);
  if (j > 0) mbar_arrive(&r.b_empty[(j - 1) % Cf::B_STAGES]);
  wgbn::issue_kb<BN>(acc, a, r.base + Cf::B_OFF + bst * Cf::B_BYTES);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Cfg<BN>::MIN_BLOCKS)
    conv3_dgrad_wgmma(const __grid_constant__ CUtensorMap dymap,
                      const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dxmap,
                      const float* __restrict__ dss,
                      const float* __restrict__ dsq,
                      const float* __restrict__ ps,
                      const float* __restrict__ pb, float* __restrict__ ws,
                      float* __restrict__ part_gx,
                      float* __restrict__ part_g, int M, int H, int W,
                      int Ci, int Co, int prologue, int relu, int per) {
  using namespace hopper;
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(smem + Cf::BAR_OFF);
  uint64_t* a_empty = a_full + Cf::A_STAGES;
  uint64_t* b_full = a_empty + Cf::A_STAGES;
  uint64_t* b_empty = b_full + Cf::B_STAGES;
  uint64_t* x_full = b_empty + Cf::B_STAGES;
  const int nch = (Co + BK - 1) / BK, cpad = nch * BK;
  float* ps_s = reinterpret_cast<float*>(smem + Cf::VEC_OFF);
  float* pb_s = ps_s + BN;
  float* dss_s = pb_s + BN;
  float* dsq_s = dss_s + cpad;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool split = ws != nullptr;
  const bool load_x = !split && prologue;
  const bool relu_on = prologue && relu;  // relu applies only with one
  const int s_begin = blockIdx.z * per;
  const int n_local = min(9 * nch, s_begin + per) - s_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::A_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 256);
    }
    for (int s = 0; s < Cf::B_STAGES; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 256);
    }
    mbar_init(x_full, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < BN; i += THREADS) {  // 0 past Ci
    const int k = n0 + i;
    ps_s[i] = k < Ci && prologue ? ps[k] : 0.0f;
    pb_s[i] = k < Ci && prologue ? pb[k] : 0.0f;
  }
  for (int i = threadIdx.x; i < cpad; i += THREADS) {  // 0 past Co
    dss_s[i] = i < Co ? dss[i] : 0.0f;
    dsq_s[i] = i < Co ? dsq[i] : 0.0f;
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------ producer
    regs_dec<Cf::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      // the x tile's boxes that start inside Ci
      const int boxes = min(BN / 64, (Ci - n0 + 63) / 64);
      const int x_at = min(n_local, Cf::B_STAGES) - 1;  // once the rings fill
      for (int j = 0; j < n_local; ++j) {
        const int step = s_begin + j, tap = step % 9;
        const int c0 = step / 9 * BK;
        if (tap % 3 == 0) {
          // dy, y as (Co, M): the window of pixels m0 + (dh - 1) W - 1 + r,
          // r < WIN, serves the three taps of row dh.  Pixels whose shift
          // leaves the image are read from a neighbour (or as 0 past
          // either end) and zeroed by the consumers' validity mask.
          const int wi = j / 3, st = wi % Cf::A_STAGES;
          if (wi >= Cf::A_STAGES)
            mbar_wait(&a_empty[st], (wi / Cf::A_STAGES - 1) & 1);
          mbar_expect_tx(&a_full[st], Cf::A_BYTES);
          const uint32_t dst = sbase + st * Cf::A_BYTES;
          const int p0 = m0 + (tap / 3 - 1) * W - 1;
          tma_load_2d(dst, &dymap, &a_full[st], c0, p0);
          tma_load_2d(dst + WIN_BYTES, &ymap, &a_full[st], c0, p0);
        }
        // w as (9 Ci, Co): the BN rows of tap (2 - dh, 2 - dw), 64 Co
        const int st = j % Cf::B_STAGES;
        if (j >= Cf::B_STAGES)
          mbar_wait(&b_empty[st], (j / Cf::B_STAGES - 1) & 1);
        mbar_expect_tx(&b_full[st], Cf::B_BYTES);
        tma_load_2d(sbase + Cf::B_OFF + st * Cf::B_BYTES, &wmap, &b_full[st],
                    c0, (8 - tap) * Ci + n0);
        if (j == x_at && load_x) {
          mbar_expect_tx(x_full, boxes * BM * 128);
          for (int nb = 0; nb < boxes; ++nb)
            tma_load_2d(sbase + Cf::X_OFF + nb * BM * 128, &xmap, x_full,
                        n0 + 64 * nb, m0);
        }
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
    // two register sets of A alternate, so step j's A is read while
    // step j - 1's wgmmas are in flight
    uint32_t a0[4][4], a1[4][4];
    const Ring ring{sbase, a_full, a_empty, b_full, b_empty};
    const int ctid = threadIdx.x;  // 0..255 over both warpgroups
    for (int j = 0; j < n_local; j += 2) {
      consume_step<BN>(acc, a0, a1, j, s_begin, ring, smem, ctid, dss_s,
                       dsq_s, vmask, lrow, lhalf);
      if (j + 1 < n_local)
        consume_step<BN>(acc, a1, a0, j + 1, s_begin, ring, smem, ctid,
                         dss_s, dsq_s, vmask, lrow, lhalf);
    }
    wgmma_wait<0>();
    reg_fence(acc);

    if (split) {  // a slice: its f32 partial tile
      wgbn::store_slice<BN>(acc, ws, blockIdx.z, m0, n0, M, Ci, rw, g, t);
      return;
    }

    // epilogue: g and dx from acc and the x tile, dx written over x and
    // out by TMA stores (rows past M and columns past Ci are clipped);
    // the column sums of g * x and g over the tile's rows, reduced in a
    // fixed order in the ring, which both warpgroups are done with
    if (load_x) mbar_wait(x_full, 0);
    named_sync(1, 256);
    unsigned char* xt = smem + Cf::X_OFF;
    float* red_s = reinterpret_cast<float*>(smem);
    float* red_q = red_s + 8 * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 s = *reinterpret_cast<const float2*>(ps_s + 8 * j + 2 * t);
      const float2 bb = *reinterpret_cast<const float2*>(pb_s + 8 * j + 2 * t);
      float gx[2], gg[2];
      wgbn::dgrad8<BN>(acc, xt, j, rw, g, t, s, bb, prologue, relu_on, gx,
                       gg);
      if (prologue) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wgbn::warp_col(gx[e], gg[e], red_s, red_q,
                         (4 * wgi + warp) * BN + 8 * j + 2 * t + e, g);
      }
    }
    fence_proxy_async();  // the dx tile is read by the TMA stores
    named_sync(1, 256);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int nb = 0; nb < BN / 64; ++nb)
        if (n0 + 64 * nb < Ci)
          tma_store_2d(&dxmap, smem_u32(xt) + nb * BM * 128, n0 + 64 * nb,
                       m0);
      tma_store_commit();
    }
    const int col = threadIdx.x;  // 0..255 over both warpgroups
    if (prologue && col < BN && n0 + col < Ci) {
      float s, q;
      wgbn::reduce_tile<BN>(red_s, red_q, col, s, q);
      const size_t o = static_cast<size_t>(blockIdx.x) * Ci + n0 + col;
      part_gx[o] = s;
      part_g[o] = q;
    }
    if (threadIdx.x == 0) tma_store_wait_read();  // before the block exits
  }
}

template <int BN>
int launch(const void* dy, const void* y, const float* dss, const float* dsq,
           const void* w, const void* x, const float* ps, const float* pb,
           void* dx, float* ws, float* part_gx, float* part_g, float* dps,
           float* dpb, int B, int H, int W, int Ci, int Co, int prologue,
           int relu, int per, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3_dgrad_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int M = B * H * W;
  const int nch = (Co + BK - 1) / BK;
  const int slices = (9 * nch + per - 1) / per;
  const int smem = Cfg<BN>::bytes(nch * BK);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap dymap, ymap, wmap, xmap, dxmap;
  const cuuint64_t odims[2] = {static_cast<cuuint64_t>(Co),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t ostrides[1] = {2ull * Co};
  const cuuint32_t wbox_a[2] = {BK, WIN};
  int err = hopper::make_map<2>(&dymap, dy, odims, ostrides, wbox_a, 128);
  if (err) return err;
  err = hopper::make_map<2>(&ymap, y, odims, ostrides, wbox_a, 128);
  if (err) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(Co),
                               static_cast<cuuint64_t>(9 * Ci)};
  const cuuint32_t wbox[2] = {BK, BN};
  err = hopper::make_map<2>(&wmap, w, wdims, ostrides, wbox, 128);
  if (err) return err;
  const cuuint64_t idims[2] = {static_cast<cuuint64_t>(Ci),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t istrides[1] = {2ull * Ci};
  const cuuint32_t xbox[2] = {64, BM};
  err = hopper::make_map<2>(&xmap, x, idims, istrides, xbox, 128);
  if (err) return err;
  err = hopper::make_map<2>(&dxmap, dx, idims, istrides, xbox, 128);
  if (err) return err;
  const dim3 grid((M + BM - 1) / BM, (Ci + BN - 1) / BN, slices);
  conv3_dgrad_wgmma<BN><<<grid, THREADS, smem, stream>>>(
      dymap, ymap, wmap, xmap, dxmap, dss, dsq, ps, pb,
      slices > 1 ? ws : nullptr, part_gx, part_g, M, H, W, Ci, Co, prologue,
      relu, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return wgbn::dgrad_finish(ws, x, ps, pb, dx, part_gx, part_g, dps, dpb, M,
                            Ci, slices, grid.x, prologue, relu, stream);
}

}  // namespace wg

}  // namespace

// x/dx (B, H, W, Ci), dy/y (B, H, W, Co), w (3, 3, Ci, Co) as it lies;
// d_ps/d_pb (Ci,).  `ws` is the (slices, M, Ci) f32 workspace (unused
// with one slice), `bn` the column tile and `per` the reduction steps
// per slice (a multiple of 3); part_gx/part_g hold ceil(M / 128) rows.
extern "C" int fused_conv3x3_bn_dgrad_bf16(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* w, const void* x, const float* ps, const float* pb, void* dx,
    float* ws, float* part_gx, float* part_g, float* dps, float* dpb, int B,
    int H, int W, int Ci, int Co, int prologue, int relu, int bn, int per,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return wg::launch<64>(dy, y, dss, dsq, w, x, ps, pb, dx, ws, part_gx,
                            part_g, dps, dpb, B, H, W, Ci, Co, prologue, relu,
                            per, s);
    case 128:
      return wg::launch<128>(dy, y, dss, dsq, w, x, ps, pb, dx, ws, part_gx,
                             part_g, dps, dpb, B, H, W, Ci, Co, prologue,
                             relu, per, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 path: wf (3, 3, Co, Ci) = the flipped io-swapped weight; ws,
// bn and per are ignored.
extern "C" int fused_conv3x3_bn_dgrad_f32(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* wf, const void* x, const float* ps, const float* pb, void* dx,
    float* /*ws*/, float* part_gx, float* part_g, float* dps, float* dpb,
    int B, int H, int W, int Ci, int Co, int prologue, int relu, int /*bn*/,
    int /*per*/, void* stream) {
  return fgbn::launch_dgrad<float, true>(
      dy, y, dss, dsq, wf, x, ps, pb, dx, part_gx, part_g, dps, dpb,
      B * H * W, 9 * Co, Ci, prologue, relu, fgbn::ConvGeom{H, W, Co},
      static_cast<cudaStream_t>(stream));
}
