// int8_matmul: y = (x_q @ w_q -> s32) * scale_row[n], cast to bf16 or f32.
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/int8_matmul.py `_kernel`
// (launched by `_pallas`, public `int8_matmul_dequant`).  In a quantized
// model it runs every QuantizedLinear and every 1x1 stride-1 quantized
// convolution (x is NHWC flattened to (B*H*W, C)): 34 calls per forward
// of a quantized ResNet-50.
//
// What bounds it on an H100: 2*M*N*K int8 operations against
// M*K + K*N + 4*N + M*N*(2 or 4) bytes.  The card does 1979 int8 TOP/s
// dense over 3.35 TB/s, about 590 operations per byte.  Every shape of a
// ResNet-50 forward is bound by bytes (43-561 operations per byte), the
// largest stream at stages 1-2 being the bf16 output y; a small batch
// (the fc, an MLP at batch 8, the int8 KV score product) is bound by
// reading the weight; only the FFN shapes at 4096 rows are bound by
// operations.  So the design keeps bytes in flight (TMA loads on an
// mbarrier ring that spans tiles), writes y in whole lines by TMA store
// while the next tile's loads run, and fills the card at small M by
// swapping the operands and splitting K.  The s32 sums stay in registers
// (or, split, in an s32 workspace): the int32 sum never exists in device
// memory as a result, as on the TPU, where it stays in VMEM.
//
// Operands.  wgmma takes s8 A and B from shared memory K-major only, so
// both x (M, K) and the weight are read as rows of K bytes: x as it
// lies, the weight through its (N, K) view with K contiguous (w_q is the
// (K, N) view of that buffer: the quantized layers hold it so, and the
// int8 KV score product passes k_q.T).  Both are loaded by TMA as
// 128-byte swizzled rows (128 K values, four k32 steps); TMA fills 0 past
// M, N and K, and a zero adds nothing to an integer sum, so any M, K and
// N is taken.  The wrapper (ops/int8_matmul.py) copies an operand TMA
// cannot describe (K not contiguous, rows not 16-byte aligned), counting
// each copy.
//
// Large M (> 64): a persistent, warp-specialised kernel.  One block of
// 384 threads per SM keeps one column tile of BN (64, 128 or 256)
// columns and walks row tiles of 128 rows.  One producer thread issues
// TMA loads of x tiles (128 rows x 128 bytes) into a ring of mbarrier
// stages that runs on across tiles (at K 64 a tile is one stage, so
// without that nothing would overlap).  Where K * BN fits beside the
// ring and the staging tiles, the block's weight panel is loaded once
// and stays resident, and the ring carries only x; else each stage also
// carries the (BN, 128-byte) weight tile.  Two consumer warpgroups own
// 64 rows each and run wgmma m64nBNk32.s32.s8.s8 (IGMMA), one commit
// group in flight behind the next.  The epilogue converts s32 to f32
// (round to nearest), multiplies by scale[n] in f32, casts once, writes
// the warpgroup's 64 rows into a 128-byte swizzled staging tile (two
// alternate in bf16) and one thread stores it by TMA, so y leaves in
// whole lines while the next tile's wgmmas and loads run.
//
// Small M (<= 64): swap AB.  The weight's N rows are wgmma's M (64 per
// block, one consumer warpgroup), x's rows its N, zero-filled by TMA up
// to MX, the next N integer wgmma takes (8, 16, 24, 32, 48, 64).  Where
// the N / 64 tiles leave most SMs idle the plan splits K into slices of
// whole 128-byte chunks, one block per (tile, slice): each adds its s32
// partial into an s32 workspace (red.add: integer sums are exact, so
// their order does not matter), and a per-tile arrival counter tells the
// last slice to read the sum back, apply the epilogue and put the
// workspace and the counter back to 0 for the next call (or a CUDA-graph
// replay).  The epilogue scales per accumulator row (n), writes the tile
// transposed into y's layout in shared memory and stores it by TMA.
//
// Exactness: the s32 sum is exact (K * 127 * 127 < 2^31 for K < 133k),
// converted to f32 with round-to-nearest-even, multiplied by the f32
// scale (one rounding) and cast once (round to nearest even).  The
// result is bit-identical to int8_matmul_dequant_plain on every run.
//
// C interface (ctypes): pointers are device addresses; lda and ldw are
// the row strides of x (M, K) and of the weight's (N, K) view, ldy y's,
// all in elements; the plan (ops/int8_matmul.py `_int8_plan`) gives the
// route (swap), the tile (bm: MX on the swap route; bn: BN), the ring
// depth, the slice length in chunks (per), the grid and whether the
// weight panel is resident; ws and cnt are the wrapper's split-K
// workspace and counters (zero between calls); `stream` a cudaStream_t.
// Returns cudaGetLastError() after the launch.
#include "hopper.cuh"

namespace {

constexpr int KB = 128;            // K bytes per chunk: one swizzled row
constexpr int MAX_SMEM = 232448;   // the most a block may ask for
constexpr int MISC = 2048;         // barriers, flags and the scale slice
constexpr int MAX_STAGES = 8;
constexpr int MAX_PANEL = 48;      // resident weight chunks (barriers)

__device__ __forceinline__ float dequant(int acc, float s) {
  return __fmul_rn(__int2float_rn(acc), s);
}

// one y value into a staging tile of 128-byte swizzled rows: element
// (row, col) of a tile whose column blocks (128 bytes of columns each)
// hold `rows` rows
template <typename T>
__device__ __forceinline__ void stage1(unsigned char* tile, int rows,
                                       int row, int col, float v) {
  constexpr int PER = 128 / sizeof(T);  // columns per 128-byte block
  const int cb = col / PER, byte = (col % PER) * sizeof(T);
  T* p = reinterpret_cast<T*>(tile + cb * rows * 128 +
                              hopper::swz<128>(row, byte / 16) + byte % 16);
  if constexpr (sizeof(T) == 2) *p = __float2bfloat16_rn(v);
  else *p = v;
}

// ------------------------------------------------------------- large M
namespace big {

constexpr int BM = 128;  // rows per tile: two consumer warpgroups of 64
constexpr int THREADS = 384;
constexpr int PRODUCER = 256;
constexpr int X_BYTES = BM * KB;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Shared memory: the ring (stages of an x tile and, without a resident
// panel, a weight tile), the resident panel, the staging tiles (512 * BN
// bytes: two 64-row tiles per warpgroup in bf16, one in f32), then MISC.
struct Layout {
  int stage, panel, staging, misc, bytes;
};

__host__ __device__ inline Layout layout(int bn, int kc, int stages,
                                         int resident) {
  Layout l;
  l.stage = X_BYTES + (resident ? 0 : bn * KB);
  l.panel = stages * l.stage;
  l.staging = l.panel + (resident ? kc * bn * KB : 0);
  l.misc = l.staging + 512 * bn;
  l.bytes = l.misc + MISC + 1024;  // + 1 KB to align the base
  return l;
}

template <int BN, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kernel_tma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap ymap,
                       const float* __restrict__ scale, int M, int K, int N,
                       int stages, int resident) {
  using namespace hopper;
  constexpr int ES = sizeof(T);
  constexpr int NB = ES == 2 ? 2 : 1;   // staging tiles per warpgroup
  constexpr int CBS = BN * ES / 128;    // 128-byte column blocks of y
  constexpr int STILE = CBS * 64 * 128;  // one warpgroup's staging tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  const int kc = (K + KB - 1) / KB;
  const Layout L = layout(BN, kc, stages, resident);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.misc);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* wfull = empty + MAX_STAGES;
  float* scale_s = reinterpret_cast<float*>(wfull + MAX_PANEL);
  const int cols = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * cols;
  // the block's column tile is fixed (gridDim.x is a multiple of cols)
  const int n0 = blockIdx.x % cols * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    if (resident)
      for (int c = 0; c < kc; ++c) mbar_init(&wfull[c], 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < BN; i += THREADS)
    scale_s[i] = n0 + i < N ? scale[n0 + i] : 0.0f;
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------ producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER) {
      if (resident) {
        for (int c = 0; c < kc; ++c) {
          mbar_expect_tx(&wfull[c], BN * KB);
          tma_load_2d(sbase + L.panel + c * BN * KB, &wmap, &wfull[c],
                      c * KB, n0);
        }
      }
      int gs = 0;  // the block's running chunk count
      for (int item = blockIdx.x; item < tiles; item += gridDim.x) {
        const int m0 = item / cols * BM;
        for (int c = 0; c < kc; ++c, ++gs) {
          const int st = gs % stages;
          if (gs >= stages) mbar_wait(&empty[st], (gs / stages - 1) & 1);
          mbar_expect_tx(&full[st], L.stage);
          const uint32_t dst = sbase + st * L.stage;
          tma_load_2d(dst, &xmap, &full[st], c * KB, m0);
          if (!resident)
            tma_load_2d(dst + X_BYTES, &wmap, &full[st], c * KB, n0);
        }
      }
    }
    return;
  }
  // ------------------------------------------------------- consumers
  regs_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x - 128 * wgi;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[BN / 2];
  int gs = 0, ti = 0;
  for (int item = blockIdx.x; item < tiles; item += gridDim.x, ++ti) {
    const int m0 = item / cols * BM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    reg_fence(acc);
    for (int c = 0; c < kc; ++c, ++gs) {
      const int st = gs % stages;
      mbar_wait(&full[st], (gs / stages) & 1);
      if (resident) mbar_wait(&wfull[c], 0);
      const uint32_t xa = sbase + st * L.stage;
      const uint32_t wb = resident ? sbase + L.panel + c * BN * KB
                                   : xa + X_BYTES;
      // four k32 steps; past K the tiles hold TMA's zeros
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_s8<BN>(acc, desc_k_s8(xa, BM, 64 * wgi, 32 * s),
                     desc_k_s8(wb, BN, 0, 32 * s), c > 0 || s > 0);
      wgmma_commit();
      if (c > 0) {  // the previous chunk's products are done: free it
        wgmma_wait<1>();
        mbar_arrive(&empty[(gs - 1) % stages]);
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(&empty[(gs - 1) % stages]);

    // epilogue: s32 -> f32 (nearest), times scale[n] in f32, one cast,
    // into this warpgroup's staging tile, then one TMA store
    unsigned char* tile = smem + L.staging + (wgi * NB + ti % NB) * STILE;
    if (tid == 0) tma_store_wait_pending<NB - 1>();  // the tile is free
    named_sync(1 + wgi, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(scale_s + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        const float v0 = dequant(acc[4 * j + 2 * h], s.x);
        const float v1 = dequant(acc[4 * j + 2 * h + 1], s.y);
        constexpr int PER = 128 / ES;
        unsigned char* p = tile + (col / PER) * 64 * 128 +
                           swz<128>(row, (col % PER) * ES / 16) +
                           (col % PER) * ES % 16;
        if constexpr (ES == 2)
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      }
    }
    fence_proxy_async();  // the tile is read by the TMA store
    named_sync(1 + wgi, 128);
    if (tid == 0) {
      const int r0 = m0 + 64 * wgi;
      if (r0 < M)
        for (int cb = 0; cb < CBS; ++cb)
          if (n0 + cb * (128 / ES) < N)
            tma_store_2d(&ymap, smem_u32(tile + cb * 64 * 128),
                         n0 + cb * (128 / ES), r0);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_read();
}

}  // namespace big

// ------------------------------------------------------------- small M
namespace swp {

constexpr int BW = 64;  // weight rows (y columns) per block
constexpr int THREADS = 160;  // one consumer warpgroup, one producer warp
constexpr int PRODUCER = 128;
constexpr int W_BYTES = BW * KB;

// Shared memory: the ring (stages of a weight tile and an MX-row x tile),
// the staging tile (MX rows of y's 64 columns, 256 * MX bytes), MISC.
struct Layout {
  int stage, staging, misc, bytes;
};

__host__ __device__ inline Layout layout(int mx, int stages) {
  Layout l;
  l.stage = W_BYTES + mx * KB;
  l.staging = stages * l.stage;
  l.misc = l.staging + 256 * mx;
  l.bytes = l.misc + MISC + 1024;
  return l;
}

template <int MX, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kernel_swap(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap ymap,
                        const float* __restrict__ scale, int* ws, int* cnt,
                        int M, int K, int N, int stages, int per) {
  using namespace hopper;
  constexpr int ES = sizeof(T);
  constexpr int CBS = BW * ES / 128;  // 128-byte column blocks of y
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  const Layout L = layout(MX, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.misc);
  uint64_t* empty = full + MAX_STAGES;
  int* last_s = reinterpret_cast<int*>(empty + MAX_STAGES);
  const int kc = (K + KB - 1) / KB;
  const int tiles = (N + BW - 1) / BW;
  const int slices = (kc + per - 1) / per;
  const int tile = blockIdx.x % tiles, z = blockIdx.x / tiles;
  const int n0 = tile * BW, c0 = z * per, nc = min(kc, c0 + per) - c0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------ producer
    if (threadIdx.x == PRODUCER) {
      for (int j = 0; j < nc; ++j) {
        const int st = j % stages;
        if (j >= stages) mbar_wait(&empty[st], (j / stages - 1) & 1);
        mbar_expect_tx(&full[st], L.stage);
        const uint32_t dst = sbase + st * L.stage;
        tma_load_2d(dst, &wmap, &full[st], (c0 + j) * KB, n0);
        tma_load_2d(dst + W_BYTES, &xmap, &full[st], (c0 + j) * KB, 0);
      }
    }
    return;
  }
  // -------------------------------------------------------- consumer
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[MX / 2];
#pragma unroll
  for (int i = 0; i < MX / 2; ++i) acc[i] = 0;
  reg_fence(acc);
  for (int j = 0; j < nc; ++j) {
    const int st = j % stages;
    mbar_wait(&full[st], (j / stages) & 1);
    const uint32_t wa = sbase + st * L.stage;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_s8<MX>(acc, desc_k_s8(wa, BW, 0, 32 * s),
                   desc_k_s8(wa + W_BYTES, MX, 0, 32 * s), j > 0 || s > 0);
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(j - 1) % stages]);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // acc[4q + r] is weight row (y column) 16 warp + g + 8 (r >> 1) and x
  // row (y row) 8q + 2t + (r & 1)
  if (slices > 1) {
    int* wt = ws + tile * BW * MX;
#pragma unroll
    for (int i = 0; i < MX / 2; ++i) {
      const int q = i / 4, r = i % 4;
      atomicAdd(wt + (16 * warp + g + 8 * (r >> 1)) * MX + 8 * q + 2 * t +
                    (r & 1),
                acc[i]);
    }
    __threadfence();
    named_sync(1, 128);
    if (tid == 0) *last_s = atomicAdd(cnt + tile, 1) == slices - 1;
    named_sync(1, 128);
    if (!*last_s) return;
    __threadfence();  // the other slices' sums are in before we read
#pragma unroll
    for (int i = 0; i < MX / 2; ++i) {
      const int q = i / 4, r = i % 4;
      int* p = wt + (16 * warp + g + 8 * (r >> 1)) * MX + 8 * q + 2 * t +
               (r & 1);
      acc[i] = __ldcg(p);
      __stcg(p, 0);  // clean for the next call
    }
    if (tid == 0) cnt[tile] = 0;
  }

  // epilogue: scale per weight row, the tile transposed into y's layout
  unsigned char* tile_s = smem + L.staging;
  const float s0 = n0 + 16 * warp + g < N ? scale[n0 + 16 * warp + g] : 0.f;
  const float s1 =
      n0 + 16 * warp + g + 8 < N ? scale[n0 + 16 * warp + g + 8] : 0.f;
#pragma unroll
  for (int i = 0; i < MX / 2; ++i) {
    const int q = i / 4, r = i % 4;
    stage1<T>(tile_s, MX, 8 * q + 2 * t + (r & 1),
              16 * warp + g + 8 * (r >> 1), dequant(acc[i], r >> 1 ? s1 : s0));
  }
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) {
    for (int cb = 0; cb < CBS; ++cb)
      if (n0 + cb * (128 / ES) < N)
        tma_store_2d(&ymap, smem_u32(tile_s + cb * MX * 128),
                     n0 + cb * (128 / ES), 0);
    tma_store_commit();
    tma_store_wait_read();
  }
}

}  // namespace swp

template <typename T>
constexpr CUtensorMapDataType y_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// the three tensor maps: x (M, K) and the weight (N, K) as rows of K
// bytes, boxes of 128 bytes by xr and wr rows; y (M, N) in boxes of 128
// bytes by yr rows; all in the 128-byte swizzle
template <typename T>
int maps(CUtensorMap* xm, CUtensorMap* wm, CUtensorMap* ym, const void* x,
         const void* w, void* y, int M, int K, int N, long long lda,
         long long ldw, long long ldy, int xr, int wr, int yr) {
  constexpr auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K),
                            static_cast<cuuint64_t>(M)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(lda)};
  const cuuint32_t xb[2] = {KB, static_cast<cuuint32_t>(xr)};
  int err = hopper::make_map<2>(xm, x, xd, xs, xb, 128, U8);
  if (err) return err;
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(K),
                            static_cast<cuuint64_t>(N)};
  const cuuint64_t wst[1] = {static_cast<cuuint64_t>(ldw)};
  const cuuint32_t wbx[2] = {KB, static_cast<cuuint32_t>(wr)};
  err = hopper::make_map<2>(wm, w, wd, wst, wbx, 128, U8);
  if (err) return err;
  const cuuint64_t yd[2] = {static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(M)};
  const cuuint64_t ys[1] = {static_cast<cuuint64_t>(ldy * sizeof(T))};
  const cuuint32_t yb[2] = {static_cast<cuuint32_t>(128 / sizeof(T)),
                            static_cast<cuuint32_t>(yr)};
  return hopper::make_map<2>(ym, y, yd, ys, yb, 128, y_type<T>());
}

template <typename F>
int allow_smem(F kernel, bool& done) {
  if (done) return 0;  // once per instantiation, before any capture
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

template <int BN, typename T>
int launch_big(const void* x, const void* w, const float* scale, void* y,
               int M, int K, int N, long long lda, long long ldw,
               long long ldy, int stages, int blocks, int resident,
               cudaStream_t stream) {
  static bool attr = false;
  int err = allow_smem(big::int8_mm_kernel_tma<BN, T>, attr);
  if (err) return err;
  const int kc = (K + KB - 1) / KB;
  const big::Layout L = big::layout(BN, kc, stages, resident);
  if (L.bytes > MAX_SMEM || stages < 1 || stages > MAX_STAGES ||
      (resident && kc > MAX_PANEL) || blocks % ((N + BN - 1) / BN) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm, ym;
  err = maps<T>(&xm, &wm, &ym, x, w, y, M, K, N, lda, ldw, ldy, big::BM, BN,
                64);
  if (err) return err;
  big::int8_mm_kernel_tma<BN, T><<<blocks, big::THREADS, L.bytes, stream>>>(
      xm, wm, ym, scale, M, K, N, stages, resident);
  return static_cast<int>(cudaGetLastError());
}

template <int MX, typename T>
int launch_swap(const void* x, const void* w, const float* scale, void* y,
                int* ws, int* cnt, int M, int K, int N, long long lda,
                long long ldw, long long ldy, int stages, int per,
                int blocks, cudaStream_t stream) {
  static bool attr = false;
  int err = allow_smem(swp::int8_mm_kernel_swap<MX, T>, attr);
  if (err) return err;
  const swp::Layout L = swp::layout(MX, stages);
  const int kc = (K + KB - 1) / KB, tiles = (N + swp::BW - 1) / swp::BW;
  if (L.bytes > MAX_SMEM || stages < 1 || stages > MAX_STAGES || M > MX ||
      per < 1 || blocks != tiles * ((kc + per - 1) / per))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm, ym;
  err = maps<T>(&xm, &wm, &ym, x, w, y, M, K, N, lda, ldw, ldy, MX, swp::BW,
                MX);
  if (err) return err;
  swp::int8_mm_kernel_swap<MX, T><<<blocks, swp::THREADS, L.bytes, stream>>>(
      xm, wm, ym, scale, ws, cnt, M, K, N, stages, per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* w, const float* scale, void* y, int* ws,
        int* cnt, int M, int K, int N, long long lda, long long ldw,
        long long ldy, int swap, int bm, int bn, int stages, int per,
        int blocks, int resident, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swap) {
    switch (bm) {
#define SWAP_CASE(MX)                                                       \
  case MX:                                                                  \
    return launch_swap<MX, T>(x, w, scale, y, ws, cnt, M, K, N, lda, ldw,   \
                              ldy, stages, per, blocks, s);
      SWAP_CASE(8)
      SWAP_CASE(16)
      SWAP_CASE(24)
      SWAP_CASE(32)
      SWAP_CASE(48)
      SWAP_CASE(64)
#undef SWAP_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (bn) {
    case 64:
      return launch_big<64, T>(x, w, scale, y, M, K, N, lda, ldw, ldy,
                               stages, blocks, resident, s);
    case 128:
      return launch_big<128, T>(x, w, scale, y, M, K, N, lda, ldw, ldy,
                                stages, blocks, resident, s);
    case 256:
      return launch_big<256, T>(x, w, scale, y, M, K, N, lda, ldw, ldy,
                                stages, blocks, resident, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int int8_matmul_dequant_bf16(
    const void* x, const void* w, const float* scale, void* y, int* ws,
    int* cnt, int M, int K, int N, long long lda, long long ldw,
    long long ldy, int swap, int bm, int bn, int stages, int per, int blocks,
    int resident, void* stream) {
  return run<__nv_bfloat16>(x, w, scale, y, ws, cnt, M, K, N, lda, ldw, ldy,
                            swap, bm, bn, stages, per, blocks, resident,
                            stream);
}

extern "C" int int8_matmul_dequant_f32(
    const void* x, const void* w, const float* scale, void* y, int* ws,
    int* cnt, int M, int K, int N, long long lda, long long ldw,
    long long ldy, int swap, int bm, int bn, int stages, int per, int blocks,
    int resident, void* stream) {
  return run<float>(x, w, scale, y, ws, cnt, M, K, N, lda, ldw, ldy, swap,
                    bm, bn, stages, per, blocks, resident, stream);
}
