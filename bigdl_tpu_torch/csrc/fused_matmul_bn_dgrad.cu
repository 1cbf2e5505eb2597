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
// once per 64-column block of dx and never writes ytot: the statistics'
// cotangents fold into the A-tile load, and the prologue's backward and
// the d_ps/d_pb reductions fold into the epilogue, which reads the x
// tile beside the accumulator.  B is a contiguous W^T that the wrapper
// copies (at most 2048 x 512 elements).  The tile loop is the forward's
// (fused_gemm_bn.cuh): 128x64 tiles, mma.sync, not pipelined.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_dgrad_bn.cuh"

namespace {

template <typename T>
int run(const void* dy, const void* y, const float* dss, const float* dsq,
        const void* wt, const void* x, const float* ps, const float* pb,
        void* dx, float* part_gx, float* part_g, float* dps, float* dpb,
        int M, int K, int N, int prologue, int relu, void* stream) {
  return fgbn::launch_dgrad<T, false>(
      dy, y, dss, dsq, wt, x, ps, pb, dx, part_gx, part_g, dps, dpb, M, N, K,
      prologue, relu, fgbn::ConvGeom{0, 0, 0},
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// x (M, K), wt = W^T (N, K), dy/y (M, N); dx (M, K), d_ps/d_pb (K,).
extern "C" int fused_matmul_bn_dgrad_bf16(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* wt, const void* x, const float* ps, const float* pb, void* dx,
    float* part_gx, float* part_g, float* dps, float* dpb, int M, int K, int N,
    int prologue, int relu, void* stream) {
  return run<__nv_bfloat16>(dy, y, dss, dsq, wt, x, ps, pb, dx, part_gx,
                            part_g, dps, dpb, M, K, N, prologue, relu, stream);
}

extern "C" int fused_matmul_bn_dgrad_f32(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* wt, const void* x, const float* ps, const float* pb, void* dx,
    float* part_gx, float* part_g, float* dps, float* dpb, int M, int K, int N,
    int prologue, int relu, void* stream) {
  return run<float>(dy, y, dss, dsq, wt, x, ps, pb, dx, part_gx, part_g, dps,
                    dpb, M, K, N, prologue, relu, stream);
}
