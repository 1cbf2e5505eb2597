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
// the B*H*W input pixels, the reduction index is (tap, co) and the
// columns are Ci.  The A-tile load gathers the shifted ytot window from
// dy and y and forms ytot in-tile; a tap outside the image is 0, not
// dssum.  B is the flipped, io-swapped weight as a (9*Co, Ci) matrix,
// which the wrapper builds with w.flip(0, 1).transpose(2, 3) (9*Ci*Co
// elements).
//
// What bounds it on an H100: 18*M*Ci*Co operations over
// 2*(2*M*Co + 2*M*Ci + 9*Ci*Co) bytes is 140-670 ops per byte at
// ResNet-50's shapes (about 2.25 * C): the 64- and 128-channel stages
// sit below the card's ~295 ops/byte ridge, the wider ones are bound by
// the tensor cores.  Each ytot pixel is formed nine times per 64-column
// block (once per tap); the re-reads of dy and y hit L1/L2.
//
// C interface (ctypes): pointers are device addresses, `stream` a
// cudaStream_t; returns cudaGetLastError() after the launches.
#include "fused_dgrad_bn.cuh"

namespace {

template <typename T>
int run(const void* dy, const void* y, const float* dss, const float* dsq,
        const void* wf, const void* x, const float* ps, const float* pb,
        void* dx, float* part_gx, float* part_g, float* dps, float* dpb,
        int B, int H, int W, int Ci, int Co, int prologue, int relu,
        void* stream) {
  return fgbn::launch_dgrad<T, true>(
      dy, y, dss, dsq, wf, x, ps, pb, dx, part_gx, part_g, dps, dpb,
      B * H * W, 9 * Co, Ci, prologue, relu, fgbn::ConvGeom{H, W, Co},
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// x/dx (B, H, W, Ci), dy/y (B, H, W, Co), wf (3, 3, Co, Ci) = the
// flipped io-swapped weight; d_ps/d_pb (Ci,).
extern "C" int fused_conv3x3_bn_dgrad_bf16(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* wf, const void* x, const float* ps, const float* pb, void* dx,
    float* part_gx, float* part_g, float* dps, float* dpb, int B, int H, int W,
    int Ci, int Co, int prologue, int relu, void* stream) {
  return run<__nv_bfloat16>(dy, y, dss, dsq, wf, x, ps, pb, dx, part_gx,
                            part_g, dps, dpb, B, H, W, Ci, Co, prologue, relu,
                            stream);
}

extern "C" int fused_conv3x3_bn_dgrad_f32(
    const void* dy, const void* y, const float* dss, const float* dsq,
    const void* wf, const void* x, const float* ps, const float* pb, void* dx,
    float* part_gx, float* part_g, float* dps, float* dpb, int B, int H, int W,
    int Ci, int Co, int prologue, int relu, void* stream) {
  return run<float>(dy, y, dss, dsq, wf, x, ps, pb, dx, part_gx, part_g, dps,
                    dpb, B, H, W, Ci, Co, prologue, relu, stream);
}
