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
// already the (9*C, Co) matrix, and columns are output channels.  The
// A-tile load gathers the shifted window straight from x, applies the
// prologue to in-image pixels only and writes 0 for out-of-image taps:
// the zero halo comes after the prologue, as in the TPU kernel, and
// never as relu(pb).
//
// What bounds it on an H100: 18*M*C*Co operations over
// 2*(M*C + 9*C*Co + M*Co) bytes is 190-1500 ops per byte at ResNet-50's
// shapes (C = Co = 64-512), so the narrowest stage is near the ridge and
// the rest are bound by the tensor cores.  Each input pixel is gathered
// nine times per 64-column block; the re-reads hit L1/L2.  Every batch
// size launches the kernel, batch 1 included.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_gemm_bn.cuh"

namespace {

template <typename T>
int run(const void* x, const void* w, const float* ps, const float* pb,
        void* y, float* part_sum, float* part_sq, float* ssum, float* ssq,
        int B, int H, int W, int C, int Co, int prologue, int relu,
        void* stream) {
  return fgbn::launch<T, true>(x, w, ps, pb, y, part_sum, part_sq, ssum, ssq,
                               B * H * W, 9 * C, Co, prologue, relu,
                               fgbn::ConvGeom{H, W, C},
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int fused_conv3x3_bn_bf16(const void* x, const void* w,
                                     const float* ps, const float* pb,
                                     void* y, float* part_sum, float* part_sq,
                                     float* ssum, float* ssq, int B, int H,
                                     int W, int C, int Co, int prologue,
                                     int relu, void* stream) {
  return run<__nv_bfloat16>(x, w, ps, pb, y, part_sum, part_sq, ssum, ssq, B,
                            H, W, C, Co, prologue, relu, stream);
}

extern "C" int fused_conv3x3_bn_f32(const void* x, const void* w,
                                    const float* ps, const float* pb, void* y,
                                    float* part_sum, float* part_sq,
                                    float* ssum, float* ssq, int B, int H,
                                    int W, int C, int Co, int prologue,
                                    int relu, void* stream) {
  return run<float>(x, w, ps, pb, y, part_sum, part_sq, ssum, ssq, B, H, W, C,
                    Co, prologue, relu, stream);
}
