// flash_attention: softmax(q k^T * scale) v over (B, H, T, D) with the
// online softmax, returning O and the f32 row logsumexp.
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/flash_attention.py
// `_attn_kernel` (launched by `_flash_fwd_pallas`, public
// `flash_attention`).  In the Transformer LM it runs the attention core
// of every MultiHeadAttention forward: (8, 8, 512, 32) causal in bf16 at
// the trainer's defaults ((8, 8, 4096, 32) in the long-context step), f32
// in evaluation.
//
// What bounds it on an H100: 4*T*S*D operations (halved under causal)
// over the 2*(2*T*D + 2*S*D) bytes of q, k, v and O (bf16) is S/4
// operations per byte under causal with T == S (S/2 without), against
// the card's ~295: the LM's T = S = 512 is bound by memory, sequences
// above ~1200 keys (~600 non-causal) by the tensor cores.  Either way
// the (T, S) score matrix never leaves the chip.  At the LM's short
// sequences the kernel is bound by latency: 0.0025 ms of bytes spread
// over 512 blocks of a few key steps each.
//
// bf16: a warp-specialised wgmma kernel.  A block owns 64 query rows per
// consumer warpgroup (two, 128 rows, at D = 128 when the grid still
// fills twice the card's SMs; else one, so that short sequences keep
// enough blocks, and at D <= 64 two blocks share an SM), plus one
// producer warpgroup.
// One producer thread loads the Q tile once and the K and V tiles of 128
// keys into a three-stage ring with TMA (4-D tensor maps over the
// (b, h, t, d) views with their own strides, so the LM's (N, T, H, D)
// head view needs no copy; rows past T and S load as 0), each tile on
// its own mbarrier; the consumers release a stage on an "empty" mbarrier
// once both products have read it, so the next tiles load while the
// current one computes.  Each consumer warpgroup scales its Q rows in
// place (q * scale rounded to bf16, once), then per key tile issues
// S = Q K^T as wgmma with both operands K-major in shared memory, masks,
// runs the online softmax on the f32 accumulator in registers (exp as
// exp2 of a fused multiply-add), repacks p (rounded to bf16) as the
// register A operand of O += P V, and reads V as an MN-major operand
// through the descriptor, so V is never transposed.  Two consumer
// warpgroups take turns to issue Q K^T (named barriers), so one's
// softmax overlaps the other's products.  Causal blocks run heaviest
// first and stop at the diagonal; only the diagonal and ragged tiles are
// masked.  The tiles are laid out in the hardware's 128-byte swizzle
// (64-byte at D = 32), see hopper.cuh.
//
// f32 (evaluation): one block of 4 warps per 64 query rows walks the
// keys in tiles of 64 through shared memory with FMAs, P through a
// per-warp shared tile.  A TF32 wgmma would change its numbers.
//
// Rounding points, as the TPU kernel (and flash_attention_plain):
//   scale rounds to the input type and q * scale rounds to it (the
//   kernel's weakly typed `q_ref[:] * sm_scale`); scores, m, l and the
//   accumulator are f32; p rounds to v's type before PV against the
//   running max of its key block (so the bf16 kernel and the plain
//   version block keys alike: ops/flash_attention.py BLOCK_K); l is
//   clamped at 1e-30; O rounds once from acc / l; lse = m + log(l) in
//   f32.  Masked scores are -1e30, never -inf.
//
// Ragged T and S are masked here: padded keys score -1e30 and padded
// query rows are not written.  Under causal (T == S, checked by the
// caller) the mask is top-left, q_pos >= k_pos.
//
// C interface (ctypes): pointers are device addresses, the strides are
// in elements ((b, h, t) for each of q, k, v, o; d is contiguous),
// `stream` a cudaStream_t; returns cudaGetLastError() after the launch.
#include "fused_gemm_bn.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ===================================================== bf16: wgmma
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BKV = 128;  // keys per step (ops/flash_attention.py BLOCK_K)
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

template <int D, int NWG>
struct Cfg {
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle width, bytes
  static constexpr int CB = SWB / 2;               // columns per block
  static constexpr int NV = D / 8;                 // 16-byte chunks per row
  static constexpr int BQ = 64 * NWG;              // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);  // + the producer
  // two blocks per SM where shared memory allows (64 rows, D <= 64);
  // the producer's registers go to the consumers (setmaxnreg; 0: none)
  static constexpr int MIN_BLOCKS = NWG == 1 && D <= 64 ? 2 : 1;
  static constexpr int PRODUCER_REGS = NWG == 2 || MIN_BLOCKS == 2 ? 40 : 0;
  static constexpr int CONSUMER_REGS =
      NWG == 2 ? 232 : MIN_BLOCKS == 2 ? 216 : 0;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; 1 KB slack
  // to align the base to the 1024-byte swizzle atom
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// byte offset of (row, col) in a tile of R rows (see hopper.cuh)
template <int D>
__device__ __forceinline__ uint32_t tile_off(int R, int row, int col) {
  constexpr int SWB = D >= 64 ? 128 : 64, CB = SWB / 2;
  return (col / CB) * R * SWB + hopper::swz<SWB>(row, (col % CB) / 8);
}

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS,
                                  Cfg<D, NWG>::MIN_BLOCKS)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    bf16* __restrict__ o, float* __restrict__ lse, int H,
                    int Tq, int S, Strides so, float scale, int causal) {
  using C = Cfg<D, NWG>;
  using namespace hopper;
  constexpr int SWB = C::SWB, NV = C::NV, BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // heaviest query tiles first: under causal their key loop is longest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  int n_kt = (S + BKV - 1) / BKV;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BKV - 1) / BKV);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == NWG) {
    // ------------------------------------------------------ producer
    if constexpr (C::PRODUCER_REGS > 0) regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / C::CB; ++cb)
        tma_load_4d(sbase + cb * BQ * SWB, &qmap, q_full, cb * C::CB, q0, h,
                    b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[st], (kt / STAGES - 1) & 1);
        const uint32_t kd = sbase + C::K_OFF + st * C::KV_BYTES;
        const uint32_t vd = sbase + C::V_OFF + st * C::KV_BYTES;
        mbar_expect_tx(&k_full[st], C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / C::CB; ++cb)
          tma_load_4d(kd + cb * BKV * SWB, &kmap, &k_full[st], cb * C::CB,
                      kt * BKV, h, b);
        mbar_expect_tx(&v_full[st], C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / C::CB; ++cb)
          tma_load_4d(vd + cb * BKV * SWB, &vmap, &v_full[st], cb * C::CB,
                      kt * BKV, h, b);
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    if constexpr (C::CONSUMER_REGS > 0) regs_inc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row_w = 64 * wgi;  // the warpgroup's first row in the tile

    // this warpgroup's Q rows: q * scale, both rounded to bf16, in place
    mbar_wait(q_full, 0);
    const float sc = round_bf16(scale);
    for (int i = tid; i < 64 * NV; i += 128) {
      const int r = row_w + i / NV, c = (i % NV) * 8;
      uint4* pq = reinterpret_cast<uint4*>(smem + tile_off<D>(BQ, r, c));
      uint4 u = *pq;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16(__fmul_rn(f.x, sc), __fmul_rn(f.y, sc));
      }
      *pq = u;
    }
    fence_proxy_async();  // the scaled Q is read by wgmma
    named_sync(1 + wgi, 128);

    // acc[4 nd + r]: row g + 8 (r >> 1), column 8 nd + 2t + (r & 1) of
    // the warp's 16 x D output; m, l per row (g, g + 8)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    const int row0 = q0 + row_w + warp * 16 + g;
    const uint32_t q_tile = sbase;
    // two warpgroups take turns to issue Q K^T (named barriers 3 and 4:
    // warpgroup w waits on 3 + w, hands over on 4 - w), so one runs its
    // softmax while the other's product runs
    if constexpr (NWG == 2)
      if (wgi == 1) named_arrive(3, 256);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % STAGES, ph = (kt / STAGES) & 1;
      const int k0 = kt * BKV;
      const uint32_t k_tile = sbase + C::K_OFF + st * C::KV_BYTES;
      const uint32_t v_tile = sbase + C::V_OFF + st * C::KV_BYTES;

      // s[4 ni + r]: row g + 8 (r >> 1), key k0 + 8 ni + 2t + (r & 1)
      float s[BKV / 2];
      mbar_wait(&k_full[st], ph);
      if constexpr (NWG == 2) named_sync(3 + wgi, 256);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKV>(s, desc_k<SWB>(q_tile, BQ, row_w, kk * 16),
                      desc_k<SWB>(k_tile, BKV, 0, kk * 16), kk > 0);
      wgmma_commit();
      if constexpr (NWG == 2)
        if (wgi == 0 || kt + 1 < n_kt) named_arrive(4 - wgi, 256);
      wgmma_wait<0>();
      reg_fence(s);

      // mask the ragged key edge and, on the diagonal tile, the future
      if (k0 + BKV > S || (causal && k0 + BKV - 1 > q0 + row_w + warp * 16)) {
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int key = k0 + ni * 8 + 2 * t + (r & 1);
            const int row = row0 + 8 * (r >> 1);
            if (key >= S || (causal && key > row)) s[4 * ni + r] = NEG_INF;
          }
      }

      // online softmax; a row's scores are spread over the 4 lanes of
      // its quad (same g), so the row reductions are two shuffles
      float m_new[2], alpha[2], mb[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
          mx = fmaxf(mx, fmaxf(s[4 * ni + 2 * i], s[4 * ni + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[i] = fmaxf(m[i], mx);
        alpha[i] = exp2f((m[i] - m_new[i]) * LOG2E);
        mb[i] = m_new[i] * LOG2E;
      }
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[4 * ni + r] = exp2f(fmaf(s[4 * ni + r], LOG2E, -mb[r >> 1]));
          psum[r >> 1] += s[4 * ni + r];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
        l[i] = l[i] * alpha[i] + psum[i];
        m[i] = m_new[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // acc += round(p) @ v: the scores' accumulator layout is the A
      // fragment layout, so p stays in registers
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(&v_full[st], ph);
      fence_proxy_async();
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc_mn<SWB>(v_tile, BKV, kk * 16), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(&empty[st]);
    }

    // epilogue: O = acc / max(l, 1e-30) rounded once; lse = m + log(l)
    bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Tq) continue;
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        fgbn::store2(ob + row * so.t + nd * 8 + 2 * t,
                     acc[4 * nd + 2 * i] / lc, acc[4 * nd + 2 * i + 1] / lc);
      if (t == 0) lse[static_cast<size_t>(bh) * Tq + row] = m[i] + logf(lc);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int D, int NWG>
int launch_nwg(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Tq, int S, Strides sq,
               Strides sk, Strides sv, Strides so, float scale, int causal,
               cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // (D, T, H, B) views of q, k, v: boxes of (CB, rows) at one (h, b)
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  const Strides* st[3] = {&sq, &sk, &sv};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(i ? S : Tq),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {2ull * st[i]->t, 2ull * st[i]->h,
                                   2ull * st[i]->b};
    const cuuint32_t box[4] = {C::CB, static_cast<cuuint32_t>(i ? BKV : C::BQ),
                               1, 1};
    const int e = hopper::make_map<4>(&maps[i], base[i], dims, strides, box,
                                      C::SWB);
    if (e) return e;
  }
  dim3 grid((Tq + C::BQ - 1) / C::BQ, B * H);
  flash_fwd_wgmma<D, NWG><<<grid, C::THREADS, C::BYTES, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, H, Tq, S, so,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// 128 query rows per block (two consumer warpgroups taking turns) at
// D = 128 where (B * H) x 128-row tiles still fill the card twice; else
// 64 rows, and at D <= 64 two blocks per SM, which hide the softmax's
// latency better than turns do when the products are short
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int S, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, int causal, cudaStream_t stream) {
  if constexpr (D == 128) {
    const long long tiles =
        static_cast<long long>(B) * H * ((Tq + 127) / 128);
    if (tiles >= 2LL * sm_count())
      return launch_nwg<D, 2>(q, k, v, o, lse, B, H, Tq, S, sq, sk, sv, so,
                              scale, causal, stream);
  }
  return launch_nwg<D, 1>(q, k, v, o, lse, B, H, Tq, S, sq, sk, sv, so,
                          scale, causal, stream);
}

}  // namespace wg

// ====================================================== f32: FMAs
namespace f32 {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per step
constexpr int THREADS = 128;

template <int D>
struct Tile {
  static constexpr int LQ = D + 4;    // Qs[row][d], Ks[key][d]
  static constexpr int LV = BKV + 4;  // Vt[d][key]
  static constexpr int LP = BKV + 4;  // Ps[row][key]
  static constexpr size_t bytes =
      sizeof(float) * (static_cast<size_t>(BQ + BKV) * LQ + D * LV + BQ * LP);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int Tq, int S, Strides sq,
                  Strides sk, Strides sv, Strides so, float scale,
                  int causal) {
  using L = Tile<D>;
  constexpr int LQ = L::LQ, LV = L::LV, LP = L::LP;
  constexpr int NV = D / 8;  // 8-element vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LQ;
  float* Vt = Ks + BKV * LQ;
  float* Ps = Vt + D * LV;

  // heaviest query tiles first: under causal their key loop is longest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile

  // Q tile: q * scale; rows past Tq are 0
  for (int i = threadIdx.x; i < BQ * NV; i += THREADS) {
    const int r = i / NV, c = (i - r * NV) * 8;
    float f[8];
    if (q0 + r < Tq) {
      fgbn::load8(qb + (q0 + r) * sq.t + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], scale);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    fgbn::store8(Qs + r * LQ + c, f);
  }

  // acc[nd][r]: row g + 8 * (r >> 1), column nd * 8 + 2t + (r & 1) of
  // the warp's 16 x D output; m, l per row
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nd][r] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  int n_kt = (S + BKV - 1) / BKV;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BKV - 1) / BKV);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tiles are consumed
    for (int i = threadIdx.x; i < BKV * NV; i += THREADS) {
      const int r = i / NV, c = (i - r * NV) * 8;
      float kv[8], vv[8];
      if (k0 + r < S) {
        fgbn::load8(kb + (k0 + r) * sk.t + c, kv);
        fgbn::load8(vb + (k0 + r) * sv.t + c, vv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = vv[j] = 0.0f;
      }
      fgbn::store8(Ks + r * LQ + c, kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * LV + r] = vv[j];
    }
    __syncthreads();

    // s[ni][r]: row g + 8 * (r >> 1), key k0 + ni * 8 + 2t + (r & 1)
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[ni][r] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a0 = Qs[(wr + g) * LQ + d];
      const float a1 = Qs[(wr + g + 8) * LQ + d];
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const float b0 = Ks[(ni * 8 + 2 * t) * LQ + d];
        const float b1 = Ks[(ni * 8 + 2 * t + 1) * LQ + d];
        s[ni][0] = fmaf(a0, b0, s[ni][0]);
        s[ni][1] = fmaf(a0, b1, s[ni][1]);
        s[ni][2] = fmaf(a1, b0, s[ni][2]);
        s[ni][3] = fmaf(a1, b1, s[ni][3]);
      }
    }

    // mask the ragged key edge and, on the diagonal tile, the future
    const int row0 = q0 + wr + g;
    if (k0 + BKV > S || (causal && k0 + BKV - 1 > q0 + wr)) {
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + ni * 8 + 2 * t + (r & 1);
          const int row = row0 + 8 * (r >> 1);
          if (key >= S || (causal && key > row)) s[ni][r] = NEG_INF;
        }
    }

    // online softmax over the row's quad
    float m_new[2], alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
        mx = fmaxf(mx, fmaxf(s[ni][2 * i], s[ni][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[i] = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[ni][r] = expf(s[ni][r] - m_new[r >> 1]);
        psum[r >> 1] += s[ni][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * alpha[i] + psum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nd][r] *= alpha[r >> 1];

    // acc += p @ v through the warp's shared P tile
    float* pw = Ps + wr * LP;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pw[(g + 8 * (r >> 1)) * LP + ni * 8 + 2 * t + (r & 1)] = s[ni][r];
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < BKV; ++key) {
      const float p0 = pw[g * LP + key], p1 = pw[(g + 8) * LP + key];
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float v0 = Vt[(nd * 8 + 2 * t) * LV + key];
        const float v1 = Vt[(nd * 8 + 2 * t + 1) * LV + key];
        acc[nd][0] = fmaf(p0, v0, acc[nd][0]);
        acc[nd][1] = fmaf(p0, v1, acc[nd][1]);
        acc[nd][2] = fmaf(p1, v0, acc[nd][2]);
        acc[nd][3] = fmaf(p1, v1, acc[nd][3]);
      }
    }
    __syncwarp();
  }

  // epilogue: O = acc / max(l, 1e-30); lse = m + log(l)
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      fgbn::store2(ob + row * so.t + nd * 8 + 2 * t, acc[nd][2 * i] / lc,
                   acc[nd][2 * i + 1] / lc);
    if (t == 0) lse[static_cast<size_t>(bh) * Tq + row] = m[i] + logf(lc);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int S, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = Tile<D>::bytes;
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_f32<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Tq, S,
      sq, sk, sv, so, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// D in {32, 64, 128} on the family's launch<D>
template <typename Launch>
int by_head_dim(int D, Launch&& fn) {
  switch (D) {
    case 32:
      return fn(std::integral_constant<int, 32>{});
    case 64:
      return fn(std::integral_constant<int, 64>{});
    case 128:
      return fn(std::integral_constant<int, 128>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (b, h, t) of q, k, v, o in that order
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int H, int Tq, int S, int D,
                                        const long long* st, float scale,
                                        int causal, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  return by_head_dim(D, [&](auto d) {
    return wg::launch<decltype(d)::value>(q, k, v, o, lse, B, H, Tq, S, sq,
                                          sk, sv, so, scale, causal,
                                          static_cast<cudaStream_t>(stream));
  });
}

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int H, int Tq, int S, int D,
                                       const long long* st, float scale,
                                       int causal, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  return by_head_dim(D, [&](auto d) {
    return f32::launch<decltype(d)::value>(q, k, v, o, lse, B, H, Tq, S, sq,
                                           sk, sv, so, scale, causal,
                                           static_cast<cudaStream_t>(stream));
  });
}
