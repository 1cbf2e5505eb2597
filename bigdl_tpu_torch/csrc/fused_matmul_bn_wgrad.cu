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
// two) and the reduction over M is long (100,352 rows at batch 32), so
// one block per tile would leave most of the 132 SMs idle.  The M
// reduction is therefore split into gridDim.z slices of whole 64-row
// steps (the plan, ops/fused_matmul.py `_wgrad_plan`): each slice writes
// a partial f32 dW into caller-allocated scratch, and
// wgrad_reduce_kernel sums the slices in a fixed order and rounds to
// the weight type.  Deterministic, no atomics.
//
// bf16: a warp-specialised wgmma kernel (384 threads) computing the
// transpose, dW^T = ytot^T @ u, so that the operand that always needs an
// elementwise transform (ytot) is the one taken from registers.  A block
// owns 128 rows of dW^T (N) x BK columns (K; BK = 64, 128 or 256) and
// one slice of M, walked in steps of 64 rows:
// - one producer thread keeps a ring full with TMA loads: per step the
//   (64 M, BK) x tile and the (64 M, 128 N) dy and y tiles, 128-byte
//   swizzle, zero past the tensors' ends;
// - two consumer warpgroups own 64 rows of dW^T each.  Per step a
//   consumer reads its dy and y fragments with ldmatrix.trans (the
//   (M, N) tiles give the A fragments of their transpose), forms ytot in
//   f32 with its two rows' constants dssum/dssq (wgmma_bn.cuh ytot2, the
//   rounding order kernels 2 and 5 share), rounds to bf16 and
//   issues wgmma m64nBKk16 with A from registers and the x tile as the
//   MN-major B operand (x is (M, K), K contiguous: nothing is
//   transposed).  With a prologue the two warpgroups first rewrite the
//   stage's x tile in place to u (f32 multiply and add, the ReLU that
//   keeps a NaN, bf16), writing 0 for rows past M, where the TMA's zero
//   fill would otherwise become relu(pb); fence.proxy.async then orders
//   those stores before wgmma reads the tile.  Without a prologue the
//   zero fill is already u.  (Rows of ytot past M are dssum, not 0, but
//   they meet u = 0.)  Two register sets of A alternate, so step j+1's
//   ytot is formed while step j's products run;
// - the epilogue writes the f32 tile transposed into the slice's (K, N)
//   partial: 8 consecutive n per group of lanes, one 32-byte sector.
//
// f32 runs the FMA tiles of fused_gemm_bn.cuh (a TF32 wgmma would change
// its numbers): the x tile is loaded along K, passed through the
// prologue and stored transposed into shared memory (As[k][m]); the
// dy/y tile becomes ytot and is stored as the forward's B tile
// (Bs[n][m]); 128x64 tiles, mma.sync's fragment layout, not pipelined.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_dgrad_bn.cuh"
#include "hopper.cuh"
#include "wgmma_bn.cuh"

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
          f[j] = relu ? fgbn::relu_nan(u) : u;
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
int run_tiles(const void* x, const float* ps, const float* pb,
              const void* dy, const void* y, const float* dss,
              const float* dsq, float* part, void* dw, int M, int K, int N,
              int chunk, int prologue, int relu, cudaStream_t s) {
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

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int NR = 128;  // dW^T rows (N) per block: two warpgroups of 64
constexpr int MS = 64;   // reduction rows (M) per step
constexpr int THREADS = 384;
constexpr int MAX_SMEM = 232448;  // the most a block may ask for
constexpr int BOX = MS * 128;     // one (64 rows, 64 columns) TMA box

template <int BK>
struct Cfg {
  static constexpr int STAGES = BK == 256 ? 3 : 4;
  static constexpr int X_BYTES = MS * BK * 2;  // x tile: BK / 64 boxes
  static constexpr int D_BYTES = MS * NR * 2;  // dy or y tile: 2 boxes
  static constexpr int STAGE = X_BYTES + 2 * D_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  // + 1 KB to align the base to the 1024-byte swizzle atom
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  // per-thread registers after setmaxnreg: producer, consumers
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
};

// The prologue pass over one stage's (64, BK) x tile in place, by the
// 256 consumer threads: thread `tid` owns the 8 channels of 16-byte
// chunk column `lc` (whose constants it holds in s/b) in every
// 256 / (BK / 8)-th row.  Rows past M (m0 + row >= M) become 0.
template <int BK>
__device__ __forceinline__ void prologue_pass(unsigned char* tile, int tid,
                                              const float2 (&s)[4],
                                              const float2 (&b)[4],
                                              bool relu, int m0, int M) {
  using namespace hopper;
  constexpr int CPR = BK / 8;  // chunks per row
  const int lc = tid % CPR;
#pragma unroll
  for (int i = 0; i < MS * CPR / 256; ++i) {
    const int row = tid / CPR + i * (256 / CPR);
    uint4* p = reinterpret_cast<uint4*>(tile + (lc / 8) * BOX +
                                        swz<128>(row, lc % 8));
    const uint32_t keep = m0 + row < M ? ~0u : 0u;
    uint4 v = *p;
    v.x = wgbn::prologue2(v.x, s[0], b[0], relu, keep);
    v.y = wgbn::prologue2(v.y, s[1], b[1], relu, keep);
    v.z = wgbn::prologue2(v.z, s[2], b[2], relu, keep);
    v.w = wgbn::prologue2(v.w, s[3], b[3], relu, keep);
    *p = v;
  }
}

// Per-thread constants of the consumers.
struct Consumer {
  int tid, wgi, m_rows, lrow, lchunk;
  // ytot constants of the two rows, one per pair (a pair is two rows of
  // M in one column n of dy/y)
  float2 dss_a, dsq_a, dss_b, dsq_b;
  float2 pro_s[4], pro_b[4];         // prologue constants of the chunk
  bool prologue, relu;
};

// Step j of a consumer: wait for its stage; with a prologue, rewrite the
// x tile to u (both warpgroups) and order it before the wgmmas; build
// ytot's A fragments in `a` from the dy and y tiles; wait for step
// j - 1's wgmmas and release their stage; issue step j's 4 wgmmas as one
// commit group.
template <int BK>
__device__ __forceinline__ void consume_step(float (&acc)[BK / 2],
                                             uint32_t (&a)[4][4], int j,
                                             int m, unsigned char* smem,
                                             uint64_t* full,
                                             uint64_t* empty,
                                             const Consumer& c) {
  using namespace hopper;
  using Cf = Cfg<BK>;
  const int st = j % Cf::STAGES;
  unsigned char* stage = smem + st * Cf::STAGE;
  mbar_wait(&full[st], (j / Cf::STAGES) & 1);
  if (c.prologue) {
    prologue_pass<BK>(stage, c.tid, c.pro_s, c.pro_b, c.relu, m, c.m_rows);
    fence_proxy_async();  // the generic stores, before wgmma reads
    named_sync(1, 256);
  }
  const uint32_t dyt = smem_u32(stage) + Cf::X_BYTES + c.wgi * BOX;
  const uint32_t yt = dyt + Cf::D_BYTES;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t rd[4], ry[4];
    const uint32_t off = swz<128>(16 * ks + c.lrow, c.lchunk);
    ldmatrix_x4_trans(dyt + off, rd);
    ldmatrix_x4_trans(yt + off, ry);
    a[ks][0] = wgbn::ytot2(rd[0], ry[0], c.dss_a, c.dsq_a);
    a[ks][1] = wgbn::ytot2(rd[1], ry[1], c.dss_b, c.dsq_b);
    a[ks][2] = wgbn::ytot2(rd[2], ry[2], c.dss_a, c.dsq_a);
    a[ks][3] = wgbn::ytot2(rd[3], ry[3], c.dss_b, c.dsq_b);
  }
  if (j > 0) {
    wgmma_wait<0>();
    mbar_arrive(&empty[(j - 1) % Cf::STAGES]);
  }
  wgbn::issue<BK>(acc, a, smem_u32(stage));
}

template <int BK>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap dymap,
                const __grid_constant__ CUtensorMap ymap,
                const float* __restrict__ ps, const float* __restrict__ pb,
                const float* __restrict__ dss, const float* __restrict__ dsq,
                float* __restrict__ part, int M, int K, int N, int prologue,
                int relu, int per) {
  using namespace hopper;
  using Cf = Cfg<BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cf::BAR_OFF);
  uint64_t* empty = full + Cf::STAGES;

  const int k0 = blockIdx.x * BK, n0 = blockIdx.y * NR;
  const int steps = (M + MS - 1) / MS;
  const int s_begin = blockIdx.z * per;
  const int n_local = min(steps, s_begin + per) - s_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------ producer
    regs_dec<Cf::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      // boxes that start inside the tensors (one past K or N is not
      // loaded: its rows or columns of dW^T are never stored)
      const int xboxes = min(BK / 64, (K - k0 + 63) / 64);
      const int nboxes = min(2, (N - n0 + 63) / 64);
      const uint32_t bytes = (xboxes + 2 * nboxes) * BOX;
      for (int j = 0; j < n_local; ++j) {
        const int st = j % Cf::STAGES, m = (s_begin + j) * MS;
        if (j >= Cf::STAGES)
          mbar_wait(&empty[st], (j / Cf::STAGES - 1) & 1);
        mbar_expect_tx(&full[st], bytes);
        const uint32_t dst = sbase + st * Cf::STAGE;
        for (int nb = 0; nb < xboxes; ++nb)
          tma_load_2d(dst + nb * BOX, &xmap, &full[st], k0 + 64 * nb, m);
        for (int h = 0; h < nboxes; ++h) {
          tma_load_2d(dst + Cf::X_BYTES + h * BOX, &dymap, &full[st],
                      n0 + 64 * h, m);
          tma_load_2d(dst + Cf::X_BYTES + Cf::D_BYTES + h * BOX, &ymap,
                      &full[st], n0 + 64 * h, m);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    regs_inc<Cf::CONSUMER_REGS>();
    Consumer c;
    c.tid = threadIdx.x;  // 0..255 over both warpgroups
    c.wgi = wgi;
    c.m_rows = M;
    const int warp = (c.tid & 127) >> 5, lane = c.tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's two rows of dW^T and their ytot constants (0 past N)
    const int na = n0 + 64 * wgi + 16 * warp + g, nb8 = na + 8;
    const float sa = na < N ? dss[na] : 0.0f, qa = na < N ? dsq[na] : 0.0f;
    const float sb = nb8 < N ? dss[nb8] : 0.0f;
    const float qb = nb8 < N ? dsq[nb8] : 0.0f;
    c.dss_a = make_float2(sa, sa);
    c.dsq_a = make_float2(qa, qa);
    c.dss_b = make_float2(sb, sb);
    c.dsq_b = make_float2(qb, qb);
    // the prologue constants of this thread's chunk column (0 past K)
    const int kc = k0 + 8 * (c.tid % (BK / 8));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kc + 2 * i;
      const bool in = prologue && k < K;
      c.pro_s[i] = in ? make_float2(ps[k], ps[k + 1]) : make_float2(0, 0);
      c.pro_b[i] = in ? make_float2(pb[k], pb[k + 1]) : make_float2(0, 0);
    }
    c.prologue = prologue;
    c.relu = prologue && relu;
    // ldmatrix.trans: lane l addresses row l % 8 of matrix l / 8; matrix
    // i covers M rows 8 (i >> 1) .. + 7 of the 16-row slab and the warp's
    // N rows 8 (i & 1) .. + 7, so register i is A fragment i
    const int mi = lane >> 3;
    c.lrow = 8 * (mi >> 1) + (lane & 7);
    c.lchunk = 2 * warp + (mi & 1);

    float acc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc[i] = 0.0f;
    reg_fence(acc);
    // two register sets of A alternate, so step j + 1's ytot is formed
    // while step j's wgmmas are in flight
    uint32_t a0[4][4], a1[4][4];
    for (int j = 0; j < n_local; j += 2) {
      consume_step<BK>(acc, a0, j, (s_begin + j) * MS, smem, full, empty,
                       c);
      if (j + 1 < n_local)
        consume_step<BK>(acc, a1, j + 1, (s_begin + j + 1) * MS, smem, full,
                         empty, c);
    }
    wgmma_wait<0>();
    reg_fence(acc);

    // the f32 tile, transposed, into this slice's (K, N) partial
    float* out = part + static_cast<size_t>(blockIdx.z) * K * N;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const int k = k0 + 8 * jj + 2 * t;
      if (k >= K) continue;  // K % 8 == 0: k + 1 < K as well
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = na + 8 * i;
        if (n < N) {
          out[static_cast<size_t>(k) * N + n] = acc[4 * jj + 2 * i];
          out[static_cast<size_t>(k + 1) * N + n] = acc[4 * jj + 2 * i + 1];
        }
      }
    }
  }
}

template <int BK>
int launch(const void* x, const float* ps, const float* pb, const void* dy,
           const void* y, const float* dss, const float* dsq, float* part,
           void* dw, int M, int K, int N, int prologue, int relu, int per,
           cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        wgrad_wgmma<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int slices = ((M + MS - 1) / MS + per - 1) / per;
  CUtensorMap xmap, dymap, ymap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {2ull * K};
  const cuuint32_t box[2] = {64, MS};
  int err = hopper::make_map<2>(&xmap, x, xdims, xstrides, box, 128);
  if (err) return err;
  const cuuint64_t ndims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t nstrides[1] = {2ull * N};
  err = hopper::make_map<2>(&dymap, dy, ndims, nstrides, box, 128);
  if (err) return err;
  err = hopper::make_map<2>(&ymap, y, ndims, nstrides, box, 128);
  if (err) return err;
  const dim3 grid((K + BK - 1) / BK, (N + NR - 1) / NR, slices);
  wgrad_wgmma<BK><<<grid, THREADS, Cfg<BK>::BYTES, stream>>>(
      xmap, dymap, ymap, ps, pb, dss, dsq, part, M, K, N, prologue, relu,
      per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t kn = static_cast<size_t>(K) * N;
  wgrad_reduce_kernel<bf16><<<static_cast<unsigned>((kn + 255) / 256), 256,
                              0, stream>>>(part, static_cast<bf16*>(dw),
                                           slices, kn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// `bk` is the bf16 kernel's column tile (64, 128 or 256) and `per` the
// 64-row steps of M per slice; the f32 kernel takes slices of 64 * per
// rows and ignores `bk`.  part is (slices, K, N) f32 scratch with
// slices = ceil(ceil(M / 64) / per).
extern "C" int fused_matmul_bn_wgrad_bf16(const void* x, const float* ps,
                                          const float* pb, const void* dy,
                                          const void* y, const float* dss,
                                          const float* dsq, float* part,
                                          void* dw, int M, int K, int N,
                                          int bk, int per, int prologue,
                                          int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bk) {
    case 64:
      return wg::launch<64>(x, ps, pb, dy, y, dss, dsq, part, dw, M, K, N,
                            prologue, relu, per, s);
    case 128:
      return wg::launch<128>(x, ps, pb, dy, y, dss, dsq, part, dw, M, K, N,
                             prologue, relu, per, s);
    case 256:
      return wg::launch<256>(x, ps, pb, dy, y, dss, dsq, part, dw, M, K, N,
                             prologue, relu, per, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_matmul_bn_wgrad_f32(const void* x, const float* ps,
                                         const float* pb, const void* dy,
                                         const void* y, const float* dss,
                                         const float* dsq, float* part,
                                         void* dw, int M, int K, int N,
                                         int /*bk*/, int per, int prologue,
                                         int relu, void* stream) {
  return run_tiles<float>(x, ps, pb, dy, y, dss, dsq, part, dw, M, K, N,
                          wg::MS * per, prologue, relu,
                          static_cast<cudaStream_t>(stream));
}
