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
// dense over 3.35 TB/s, about 590 operations per byte: a small batch
// (the fc at batch 32, an MLP at batch 8, the int8 KV score product) is
// bound by reading the weight, a large one (ResNet-50's 1x1 convs at
// batch 32, the FFN shapes at 4096 rows) sits near or above the ridge.
// The design keeps the s32 accumulators in registers and applies the
// dequant scale and the cast in the epilogue, so the int32 sum never
// exists in device memory (as on the TPU, where it stays in VMEM).  It is
// the simple version: register-staged loads into one shared buffer,
// mma.sync, no cp.async/TMA pipeline, no wgmma, no split-K.
//
// Blocking: one block of 8 warps owns a BM x BN output tile and walks K
// in steps of BK bytes through shared memory; each warp owns a
// (BM / WM) x (BN / WN) sub-tile of m16n8 fragments and runs
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (IMMA).  M <= 64 takes a
// 32 x 64 tile with BK = 128 (more blocks and fewer K steps for the
// weight-bound small batches), larger M a 128 x 128 tile with BK = 64.
//
// Shared layout: both operands are stored with k contiguous, 16-byte
// padded rows (LDW 32-bit words, LDW = 4 mod 8), so each A and B
// fragment register is one conflict-free 32-bit load.  The (K, N)
// row-major weight has n contiguous, the wrong axis for mma's `.col` B
// fragment (4 consecutive k of one n per register; ldmatrix.trans moves
// 16-bit elements, not bytes).  So it is transposed on the way in: each
// thread reads 4 bytes along n from 4 consecutive k rows and turns them
// into 4 words of 4 k each with 8 byte permutes; the lanes rotate the
// order of their 4 stores so a warp's stores hit 32 distinct banks.  A
// weight view with k contiguous (the transposed (L, D) key view of the
// int8 KV score product) is copied in directly, as x is.  Both strides
// of w_q are arguments, so no layout needs a copy.
//
// Ragged edges: loads past M, K and N read 0 (a zero adds nothing to an
// integer sum) and stores are masked, so any M, K and N is taken.  16-
// and 4-byte loads are used where the pointer, the stride and the edge
// allow them, single bytes elsewhere.
//
// Exactness: the s32 sum is exact (K * 127 * 127 < 2^31 for K < 133k),
// converted to f32 with round-to-nearest-even, multiplied by the f32
// scale (one rounding) and cast once (__float2bfloat16_rn).  No atomics:
// the result is bit-identical to int8_matmul_dequant_plain on every run.
//
// C interface (ctypes): pointers are device addresses; lda is x's row
// stride, sk and sn w_q's strides, all in elements; `stream` a
// cudaStream_t; returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int BM_, int BN_, int BK_, int WM_, int WN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_;  // warps along m and n
  static constexpr int LDW = BK / 4 + 4;    // words per shared row
  static constexpr int MT = BM / WM / 16;   // m16 fragments per warp
  static constexpr int NT = BN / WN / 8;    // n8 fragments per warp
  static constexpr int A_CHUNKS = BM * BK / 16;  // 16-byte pieces
  static constexpr int B_CHUNKS = BN * BK / 16;
  static_assert(WM * WN * 32 == THREADS, "8 warps");
  static_assert(MT >= 1 && NT >= 1, "warp tile");
  static_assert(A_CHUNKS % THREADS == 0 && B_CHUNKS % THREADS == 0,
                "whole chunks per thread");
  static_assert(BN % 32 == 0 && BK % 32 == 0, "transposing load groups");
};

using Small = Cfg<32, 64, 128, 2, 4>;
using Large = Cfg<128, 128, 64, 2, 4>;

__device__ __forceinline__ uint32_t byte_at(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(*p));
}

// 16 bytes of a k-contiguous operand: row `r` (of R), k .. k+15 (of K),
// zero past either edge.  `align` (16, 4 or 1) says which vector loads
// the pointer and the row stride allow.
__device__ __forceinline__ uint4 load_row16(const int8_t* base, long long ld,
                                            int r, int k, int R, int K,
                                            int align) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r >= R) return v;
  const int8_t* p = base + static_cast<long long>(r) * ld + k;
  if (align == 16 && k + 16 <= K) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kq = k + 4 * q;
    if (align >= 4 && kq + 4 <= K) {
      w[q] = *reinterpret_cast<const uint32_t*>(p + 4 * q);
    } else {
      uint32_t x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kq + j < K) x |= byte_at(p + 4 * q + j) << (8 * j);
      w[q] = x;
    }
  }
  v.x = w[0]; v.y = w[1]; v.z = w[2]; v.w = w[3];
  return v;
}

// 4 k rows x 4 n columns of the weight at (k, n), zero past the edges:
// in[i] holds k + i, its byte j column n + j.  `vec` when n is the
// contiguous axis and each row is 4-byte aligned.
__device__ __forceinline__ uint4 load_block4x4(const int8_t* w, long long sk,
                                               long long sn, int k, int n,
                                               int K, int N, bool vec) {
  uint32_t in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = 0;
    if (k + i < K) {
      const int8_t* p = w + static_cast<long long>(k + i) * sk;
      if (vec && n + 4 <= N) {
        x = *reinterpret_cast<const uint32_t*>(p + n);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) x |= byte_at(p + static_cast<long long>(n + j) * sn)
                              << (8 * j);
      }
    }
    in[i] = x;
  }
  return make_uint4(in[0], in[1], in[2], in[3]);
}

// (4 k) x (4 n) bytes -> 4 words, word j = the 4 k of column j (k + 0
// in the low byte), as mma's B fragment wants them.
__device__ __forceinline__ void transpose4x4(uint4 in, uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(in.x, in.y, 0x5140);
  const uint32_t hi01 = __byte_perm(in.x, in.y, 0x7362);
  const uint32_t lo23 = __byte_perm(in.z, in.w, 0x5140);
  const uint32_t hi23 = __byte_perm(in.z, in.w, 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float s) {
  return __fmul_rn(__int2float_rn(acc), s);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 h;
  h.x = __float2bfloat16_rn(a);
  h.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// B_KC: the weight view has k contiguous (sk == 1); else it is
// transposed on the way into shared memory.
template <typename C, bool B_KC, typename T>
__global__ void __launch_bounds__(THREADS)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y, int M,
                   int K, int N, long long lda, long long sk, long long sn,
                   int a_align, int b_align) {
  __shared__ __align__(16) uint32_t As[C::BM * C::LDW];
  __shared__ __align__(16) uint32_t Bs[C::BN * C::LDW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int wm = (warp / C::WN) * (C::BM / C::WM);
  const int wn = (warp % C::WN) * (C::BN / C::WN);

  constexpr int AP = C::A_CHUNKS / THREADS, BP = C::B_CHUNKS / THREADS;
  constexpr int ROW_CHUNKS = C::BK / 16;  // 16-byte pieces per k row
  constexpr int NGW = C::BN / 32;         // 8-group n runs per virtual warp
  uint4 ra[AP], rb[BP];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AP; ++i) {
      const int c = tid + i * THREADS;
      ra[i] = load_row16(x, lda, m0 + c / ROW_CHUNKS,
                         k0 + (c % ROW_CHUNKS) * 16, M, K, a_align);
    }
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      const int c = tid + i * THREADS;
      if (B_KC) {
        rb[i] = load_row16(w, sn, n0 + c / ROW_CHUNKS,
                           k0 + (c % ROW_CHUNKS) * 16, N, K, b_align);
      } else {
        // virtual warp vw: 8 consecutive n groups x 4 k groups, so each
        // global load reads 32 contiguous bytes of 4 rows
        const int l = c & 31, vw = c >> 5;
        const int ng = (l & 7) + 8 * (vw % NGW), kg = (l >> 3) + 4 * (vw / NGW);
        rb[i] = load_block4x4(w, sk, sn, k0 + 4 * kg, n0 + 4 * ng, K, N,
                              b_align == 4);
      }
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < AP; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[(c / ROW_CHUNKS) * C::LDW +
                                    (c % ROW_CHUNKS) * 4]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      const int c = tid + i * THREADS;
      if (B_KC) {
        *reinterpret_cast<uint4*>(&Bs[(c / ROW_CHUNKS) * C::LDW +
                                      (c % ROW_CHUNKS) * 4]) = rb[i];
      } else {
        const int l = c & 31, vw = c >> 5;
        const int ng = (l & 7) + 8 * (vw % NGW), kg = (l >> 3) + 4 * (vw / NGW);
        uint32_t o[4];
        transpose4x4(rb[i], o);
        const int rot = (l >> 1) & 3;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = (s + rot) & 3;
          const uint32_t v = j == 0 ? o[0] : j == 1 ? o[1] : j == 2 ? o[2] : o[3];
          Bs[(4 * ng + j) * C::LDW + kg] = v;
        }
      }
    }
  };

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  for (int k0 = 0; k0 < K; k0 += C::BK) {
    __syncthreads();  // the previous step's fragments are read
    store();
    __syncthreads();
    if (k0 + C::BK < K) load(k0 + C::BK);  // in flight during the MMAs
#pragma unroll
    for (int s = 0; s < C::BK / 32; ++s) {
      uint32_t a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const uint32_t* r = &As[(wm + 16 * i + g) * C::LDW + 8 * s + t];
        a[i][0] = r[0];
        a[i][1] = r[8 * C::LDW];
        a[i][2] = r[4];
        a[i][3] = r[8 * C::LDW + 4];
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const uint32_t* r = &Bs[(wn + 8 * j + g) * C::LDW + 8 * s + t];
        b[j][0] = r[0];
        b[j][1] = r[4];
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // epilogue: s32 -> f32 (nearest), times scale[n] in f32, one cast
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    const float s0 = scale[col], s1 = two ? scale[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * i + g + 8 * h;
        if (row >= M) continue;
        T* p = y + static_cast<long long>(row) * N + col;
        const float v0 = dequant(acc[i][j][2 * h], s0);
        if (two && pairs) {
          store2(p, v0, dequant(acc[i][j][2 * h + 1], s1));
        } else {
          store1(p, v0);
          if (two) store1(p + 1, dequant(acc[i][j][2 * h + 1], s1));
        }
      }
    }
  }
}

int align_of(const void* p, long long stride) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % 16 == 0 && stride % 16 == 0) return 16;
  if (a % 4 == 0 && stride % 4 == 0) return 4;
  return 1;
}

template <typename C, bool B_KC, typename T>
int launch(const int8_t* x, const int8_t* w, const float* scale, T* y, int M,
           int K, int N, long long lda, long long sk, long long sn,
           cudaStream_t stream) {
  const int a_align = align_of(x, lda);
  // k-contiguous weight: alignment of its n rows; else 4-byte loads
  // along n need n contiguous and 4-byte aligned k rows
  const int b_align = B_KC ? align_of(w, sn)
                           : (sn == 1 && align_of(w, sk) >= 4 ? 4 : 1);
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  int8_mm_kernel<C, B_KC, T><<<grid, THREADS, 0, stream>>>(
      x, w, scale, y, M, K, N, lda, sk, sn, a_align, b_align);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* w, const float* scale, void* y, int M,
        int K, int N, long long lda, long long sk, long long sn,
        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + 127) / 128 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  T* yp = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kc = sk == 1 && (sn != 1 || N == 1);
  if (M <= 64)
    return kc ? launch<Small, true>(xp, wp, scale, yp, M, K, N, lda, sk, sn, s)
              : launch<Small, false>(xp, wp, scale, yp, M, K, N, lda, sk, sn, s);
  return kc ? launch<Large, true>(xp, wp, scale, yp, M, K, N, lda, sk, sn, s)
            : launch<Large, false>(xp, wp, scale, yp, M, K, N, lda, sk, sn, s);
}

}  // namespace

extern "C" int int8_matmul_dequant_bf16(const void* x, const void* w,
                                        const float* scale, void* y, int M,
                                        int K, int N, long long lda,
                                        long long sk, long long sn,
                                        void* stream) {
  return run<__nv_bfloat16>(x, w, scale, y, M, K, N, lda, sk, sn, stream);
}

extern "C" int int8_matmul_dequant_f32(const void* x, const void* w,
                                       const float* scale, void* y, int M,
                                       int K, int N, long long lda,
                                       long long sk, long long sn,
                                       void* stream) {
  return run<float>(x, w, scale, y, M, K, N, lda, sk, sn, stream);
}
