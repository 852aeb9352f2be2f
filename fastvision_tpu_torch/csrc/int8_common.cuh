// The int8 conv's epilogue arithmetic, shared by csrc/int8.cu (the epilogue
// pass after the GEMM) and csrc/int8_conv.cu (the implicit-GEMM conv, which
// runs it from its registers), so that the two cannot round apart:
//
//   act((float(acc) * scale + bias) rounded to the output type), the
//   activation in float32 on the rounded value, rounded again,
//
// each float operation an explicit _rn intrinsic (the build passes
// --fmad=false too), as the plain PyTorch version (ops/int8.py::
// epilogue_plain) rounds. silu calls expf, whose last bit may differ from
// PyTorch's build of the same libdevice function.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fv_int8 {

// activation codes: 0 none, 1 relu, 2 leaky_relu (0.1), 3 silu
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.f ? v : 0.f;
    case 2: return v > 0.f ? v : __fmul_rn(v, 0.1f);
    case 3: return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
    default: return v;
  }
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_out(float v, const float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, const __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// one accumulator -> its output value in O (float or __nv_bfloat16)
template <typename O>
__device__ __forceinline__ O dequantize(int32_t acc, float scale, float bias, int act) {
  const O* tag = nullptr;
  const float v = round_to(__fadd_rn(__fmul_rn((float)acc, scale), bias), tag);
  return to_out(activate(v, act), tag);
}

}  // namespace fv_int8
