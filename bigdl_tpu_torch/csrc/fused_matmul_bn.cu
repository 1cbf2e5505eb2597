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
// tensor cores.  The design reads x once per 64-column block (so x is
// read N/64 times; it stays in the 50 MB L2 for most shapes), applies the
// previous BatchNorm on the A-tile load so the normalised activation is
// never written, and takes the statistics from the accumulator in the
// epilogue so BatchNorm costs no extra pass.  The tile loop is not
// pipelined (no cp.async/TMA, no wgmma): see fused_gemm_bn.cuh.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_gemm_bn.cuh"

namespace {

template <typename T>
int run(const void* x, const void* w, const float* ps, const float* pb,
        void* y, float* part_sum, float* part_sq, float* ssum, float* ssq,
        int M, int K, int N, int prologue, int relu, void* stream) {
  return fgbn::launch<T, false>(x, w, ps, pb, y, part_sum, part_sq, ssum, ssq,
                                M, K, N, prologue, relu,
                                fgbn::ConvGeom{0, 0, 0},
                                static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int fused_matmul_bn_bf16(const void* x, const void* w,
                                    const float* ps, const float* pb, void* y,
                                    float* part_sum, float* part_sq,
                                    float* ssum, float* ssq, int M, int K,
                                    int N, int prologue, int relu,
                                    void* stream) {
  return run<__nv_bfloat16>(x, w, ps, pb, y, part_sum, part_sq, ssum, ssq, M,
                            K, N, prologue, relu, stream);
}

extern "C" int fused_matmul_bn_f32(const void* x, const void* w,
                                   const float* ps, const float* pb, void* y,
                                   float* part_sum, float* part_sq,
                                   float* ssum, float* ssq, int M, int K,
                                   int N, int prologue, int relu,
                                   void* stream) {
  return run<float>(x, w, ps, pb, y, part_sum, part_sq, ssum, ssq, M, K, N,
                    prologue, relu, stream);
}
