// flash_attention: softmax(q k^T * scale) v over (B, H, T, D) with the
// online softmax, returning O and the f32 row logsumexp.
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas/flash_attention.py
// `_attn_kernel` (launched by `_flash_fwd_pallas`, public
// `flash_attention`).  In the Transformer LM it runs the attention core
// of every MultiHeadAttention forward: (8, 8, 512, 32) causal in bf16 at
// the trainer's defaults, f32 in evaluation.
//
// What bounds it on an H100: 4*T*S*D operations (halved under causal)
// over the 2*(2*T*D + 2*S*D) bytes of q, k, v and O (bf16) is S/4
// operations per byte under causal with T == S (S/2 without), against
// the card's ~295: the LM's T = S = 512 is bound by memory, sequences
// above ~1200 keys (~600 non-causal) by the tensor cores.  Either way
// the (T, S) score matrix never leaves the chip.  The design keeps the running max m, sum l and the output
// accumulator of a query row in registers for the whole key loop (the
// TPU kernel carries them across sequential grid steps in VMEM scratch;
// Hopper's blocks run in no order, so the key loop is inside the
// block), and skips key tiles above the diagonal under causal.  It is
// the simple version: plain loads into shared memory, mma.sync, no
// cp.async/TMA pipeline, no wgmma, no warp specialisation.
//
// Blocking: one block of 4 warps owns 64 query rows of one (b, h); each
// warp owns 16 rows.  The block walks the keys in tiles of 64: K and V
// tiles go through shared memory (V stored transposed so a fragment's two
// consecutive keys are one 32-bit word).  bf16 runs QK^T and PV on the
// tensor cores with mma.sync.m16n8k16 and f32 accumulation; the scores'
// accumulator layout is reused as the A fragments of PV, so P never
// touches shared memory.  f32 runs the same fragment ownership with FMAs
// and passes P through a per-warp shared tile.
//
// Rounding points, as the TPU kernel (and flash_attention_plain):
//   scale rounds to the input type and q * scale rounds to it (the
//   kernel's weakly typed `q_ref[:] * sm_scale`); scores, m, l and the
//   accumulator are f32; p rounds to v's type before PV; l is clamped
//   at 1e-30; O rounds once from acc / l; lse = m + log(l) in f32.
//   Masked scores are -1e30, never -inf.
//
// Ragged T and S are masked here: padded keys score -1e30 and padded
// query rows are not written.  Under causal (T == S, checked by the
// caller) the mask is top-left, q_pos >= k_pos.
//
// C interface (ctypes): pointers are device addresses, the strides are
// in elements ((b, h, t) for each of q, k, v, o; d is contiguous),
// `stream` a cudaStream_t; returns cudaGetLastError() after the launch.
#include "fused_gemm_bn.cuh"

#include <math.h>

namespace {

using fgbn::copy8;
using fgbn::ld32;
using fgbn::load8;
using fgbn::mma_bf16;
using fgbn::store2;
using fgbn::store8;

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per step
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;
};

template <typename T, int D>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);  // 16 bytes per row
  static constexpr int LQ = D + PAD;          // Qs[row][d], Ks[key][d]
  static constexpr int LV = BKV + PAD;        // Vt[d][key]
  static constexpr int LP = BKV + 4;          // Ps[row][key], f32 only
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr size_t bytes =
      sizeof(T) * (static_cast<size_t>(BQ + BKV) * LQ + D * LV) +
      (F32 ? sizeof(float) * BQ * LP : 0);
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(x));
  else
    return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int S,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int causal) {
  using L = Tile<T, D>;
  constexpr int LQ = L::LQ, LV = L::LV, LP = L::LP;
  constexpr int NV = D / 8;  // 8-element vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LQ;
  T* Vt = Ks + BKV * LQ;
  float* Ps = reinterpret_cast<float*>(Vt + D * LV);  // f32 path only

  // heaviest query tiles first: under causal their key loop is longest
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile

  // Q tile: q * scale, both rounded to T; rows past Tq are 0
  const float sc = round_to<T>(scale);
  for (int i = threadIdx.x; i < BQ * NV; i += THREADS) {
    const int r = i / NV, c = (i - r * NV) * 8;
    float f[8];
    if (q0 + r < Tq) {
      load8(qb + (q0 + r) * sq.t + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], sc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    store8(Qs + r * LQ + c, f);
  }
  __syncthreads();

  uint32_t qf[D / 16][4];  // bf16: the warp's Q rows as A fragments
  if constexpr (!L::F32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* p = Qs + (wr + g) * LQ + kk * 16 + t * 2;
      qf[kk][0] = ld32(p);
      qf[kk][1] = ld32(p + 8 * LQ);
      qf[kk][2] = ld32(p + 8);
      qf[kk][3] = ld32(p + 8 * LQ + 8);
    }
  }

  // accumulator fragments: o[nd][r] is row g + 8 * (r >> 1), column
  // nd * 8 + 2t + (r & 1) of the warp's 16 x D output; m, l per row
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
      alignas(16) T kv[8], vv[8];
      if (k0 + r < S) {
        copy8(kv, kb + (k0 + r) * sk.t + c);
        copy8(vv, vb + (k0 + r) * sv.t + c);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = vv[j] = T(0.0f);
      }
      *reinterpret_cast<uint4*>(Ks + r * LQ + c) =
          *reinterpret_cast<const uint4*>(kv);
      if constexpr (L::F32)
        *reinterpret_cast<uint4*>(Ks + r * LQ + c + 4) =
            *reinterpret_cast<const uint4*>(kv + 4);
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
    if constexpr (!L::F32) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni) {
          const T* p = Ks + (ni * 8 + g) * LQ + kk * 16 + t * 2;
          const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
          mma_bf16(s[ni], qf[kk], bf);
        }
    } else {
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

    // online softmax; a row's 64 scores are spread over the 4 lanes of
    // its quad (same g), so the row reductions are two shuffles
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

    // acc += round(p) @ v
    if constexpr (!L::F32) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const T* p = Vt + (nd * 8 + g) * LV + kk * 16 + t * 2;
          const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
          mma_bf16(acc[nd], pa, bf);
        }
      }
    } else {
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
  }

  // epilogue: O = acc / max(l, 1e-30) rounded once; lse = m + log(l)
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(ob + row * so.t + nd * 8 + 2 * t, acc[nd][2 * i] / lc,
             acc[nd][2 * i + 1] / lc);
    if (t == 0) lse[static_cast<size_t>(bh) * Tq + row] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int S, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = Tile<T, D>::bytes;
  static bool attr_set = false;  // once per instantiation, before capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, S, sq, sk, sv,
      so, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Tq, int S, int D, const long long* st, float scale,
        int causal, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Tq, S, sq, sk, sv, so,
                           scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Tq, S, sq, sk, sv, so,
                           scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Tq, S, sq, sk, sv, so,
                            scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (b, h, t) of q, k, v, o in that order
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int H, int Tq, int S, int D,
                                        const long long* strides, float scale,
                                        int causal, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, S, D, strides, scale,
                            causal, stream);
}

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int H, int Tq, int S, int D,
                                       const long long* strides, float scale,
                                       int causal, void* stream) {
  return run<float>(q, k, v, o, lse, B, H, Tq, S, D, strides, scale, causal,
                    stream);
}
