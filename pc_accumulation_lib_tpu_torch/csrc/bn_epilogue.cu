// Batch-norm epilogue of the semseg model's bf16 convolutions, in inference
// (pc_accumulation_lib_tpu_torch/ops/bn_epilogue.py).
//
// It replaces no TPU kernel: the JAX package leaves the batch norm, the
// residual add, the ReLU and the casts around each convolution to XLA, which
// fuses them on the TPU. On the H100 the port ran them as five memory
// passes a batch norm (a bf16 -> float32 copy, cuDNN's float32 batch norm,
// the ReLU, the residual add, the cast back to bf16); this kernel runs them
// as one. cuDNN keeps the convolutions.
//
// Per element of a channels-last (N, H, W, C) bf16 convolution output x:
//   y = x * scale[c] + shift[c]          (float32; c = offset mod C)
//   y = y + residual                     (when a float32 residual is given)
//   y = y < 0 ? 0 : y                    (when relu; NaN stays NaN)
// written as bf16 (what the next convolution reads), as float32 (what a
// residual add or the float32 classifier reads), or both.
// scale = weight / sqrt(var + eps) and shift = bias - mean * scale are
// formed here from the batch norm's own tensors, once per block.
//
// Bound: bytes. One FMA, an add and a compare per element against 4-12 B
// (2 B read, 2 B bf16 and/or 4 B float32 written, 4 B of residual read):
// ~0.5 operation a byte, far below the card's float32 line. At the layer3
// conv3 shape (6, 1024, 113, 200) with the residual and both outputs that
// is 1.67 GB, 497 us at 3.35 TB/s. The design:
//   * one pass: each element is read once and each output written once;
//   * 16 B per thread per access (8 bf16 in, 8 bf16 out, 2 x 4 float32),
//     neighbouring threads on neighbouring addresses;
//   * scale and shift for all C channels in shared memory, formed once per
//     block; a grid of up to kBlocksPerSM blocks per SM strides over the
//     8-element vectors, tracking each vector's channel by an add (no
//     division in the loop);
//   * templated on the residual, the ReLU and the outputs, so each variant
//     loads and stores only what it needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kVec = 8;   // bf16 elements in 16 bytes

template <bool kResidual, bool kRelu, bool kOutBf16, bool kOutF32>
__global__ void __launch_bounds__(kThreads)
    bn_epilogue_kernel(const uint4* __restrict__ x,
                       const float* __restrict__ weight,
                       const float* __restrict__ bias,
                       const float* __restrict__ mean,
                       const float* __restrict__ var, float eps,
                       const float4* __restrict__ residual,
                       uint4* __restrict__ out_bf16,
                       float4* __restrict__ out_f32, int64_t nvec, int C) {
  extern __shared__ float4 smem4[];
  float* scale = reinterpret_cast<float*>(smem4);
  float* shift = scale + C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float s = weight[c] / sqrtf(var[c] + eps);
    scale[c] = s;
    shift[c] = bias[c] - mean[c] * s;
  }
  __syncthreads();

  const int cvecs = C / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % cvecs);
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int cv = static_cast<int>(i % cvecs);
  for (; i < nvec; i += stride) {
    const uint4 raw = __ldg(x + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4* sc = reinterpret_cast<const float4*>(scale + cv * kVec);
    const float4* sh = reinterpret_cast<const float4*>(shift + cv * kVec);
    const float4 s0 = sc[0], s1 = sc[1], t0 = sh[0], t1 = sh[1];
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    float y[kVec] = {fmaf(a.x, s0.x, t0.x), fmaf(a.y, s0.y, t0.y),
                     fmaf(b.x, s0.z, t0.z), fmaf(b.y, s0.w, t0.w),
                     fmaf(c.x, s1.x, t1.x), fmaf(c.y, s1.y, t1.y),
                     fmaf(d.x, s1.z, t1.z), fmaf(d.y, s1.w, t1.w)};
    if (kResidual) {
      const float4 r0 = __ldg(residual + 2 * i);
      const float4 r1 = __ldg(residual + 2 * i + 1);
      y[0] += r0.x; y[1] += r0.y; y[2] += r0.z; y[3] += r0.w;
      y[4] += r1.x; y[5] += r1.y; y[6] += r1.z; y[7] += r1.w;
    }
    if (kRelu) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) y[k] = y[k] < 0.f ? 0.f : y[k];
    }
    if (kOutBf16) {
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k) {
        oh[k] = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
      }
      out_bf16[i] = o;
    }
    if (kOutF32) {
      out_f32[2 * i] = make_float4(y[0], y[1], y[2], y[3]);
      out_f32[2 * i + 1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    cv += step;
    if (cv >= cvecs) cv -= cvecs;
  }
}

template <bool kResidual, bool kRelu, bool kOutBf16, bool kOutF32>
cudaError_t launch(const void* x, const float* weight, const float* bias,
                   const float* mean, const float* var, float eps,
                   const void* residual, void* out_bf16, void* out_f32,
                   int64_t nvec, int C, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int64_t want = (nvec + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < int64_t{sms} * kBlocksPerSM ? want : int64_t{sms} * kBlocksPerSM);
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);
  bn_epilogue_kernel<kResidual, kRelu, kOutBf16, kOutF32>
      <<<blocks, kThreads, smem, stream>>>(
          static_cast<const uint4*>(x), weight, bias, mean, var, eps,
          static_cast<const float4*>(residual), static_cast<uint4*>(out_bf16),
          static_cast<float4*>(out_f32), nvec, C);
  return cudaGetLastError();
}

template <bool kResidual, bool kRelu>
cudaError_t by_outputs(const void* x, const float* weight, const float* bias,
                       const float* mean, const float* var, float eps,
                       const void* residual, void* out_bf16, void* out_f32,
                       int64_t nvec, int C, cudaStream_t stream) {
  if (out_bf16 != nullptr && out_f32 != nullptr) {
    return launch<kResidual, kRelu, true, true>(
        x, weight, bias, mean, var, eps, residual, out_bf16, out_f32, nvec,
        C, stream);
  }
  if (out_bf16 != nullptr) {
    return launch<kResidual, kRelu, true, false>(
        x, weight, bias, mean, var, eps, residual, out_bf16, out_f32, nvec,
        C, stream);
  }
  return launch<kResidual, kRelu, false, true>(
      x, weight, bias, mean, var, eps, residual, out_bf16, out_f32, nvec, C,
      stream);
}

}  // namespace

// x: n bf16 values of a channels-last tensor with C channels (C a multiple
// of 8, n a multiple of C), 16-byte aligned; weight, bias, mean, var: C
// float32 values each; residual: null or n float32 values (16-byte
// aligned); out_bf16, out_f32: n bf16 / n float32 values, either null but
// not both. Launches on ``stream`` and returns the launch's cudaError_t.
extern "C" int bn_epilogue_launch(const void* x, const float* weight,
                                  const float* bias, const float* mean,
                                  const float* var, float eps,
                                  const void* residual, void* out_bf16,
                                  void* out_f32, long long n, int C,
                                  int relu, void* stream) {
  if (C <= 0 || C % kVec != 0 || n % C != 0 ||
      (out_bf16 == nullptr && out_f32 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int64_t nvec = n / kVec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (residual != nullptr) {
    err = relu ? by_outputs<true, true>(x, weight, bias, mean, var, eps,
                                        residual, out_bf16, out_f32, nvec, C,
                                        s)
               : by_outputs<true, false>(x, weight, bias, mean, var, eps,
                                         residual, out_bf16, out_f32, nvec,
                                         C, s);
  } else {
    err = relu ? by_outputs<false, true>(x, weight, bias, mean, var, eps,
                                         residual, out_bf16, out_f32, nvec,
                                         C, s)
               : by_outputs<false, false>(x, weight, bias, mean, var, eps,
                                          residual, out_bf16, out_f32, nvec,
                                          C, s);
  }
  return static_cast<int>(err);
}
