// The int8 conv's arithmetic, shared by csrc/int8.cu (the quantize and
// patches passes, the epilogue pass after the GEMM) and csrc/int8_conv.cu
// (the implicit-GEMM conv, which runs the epilogue, the residual add and
// the quantize of its consumer's input from its own tile), so that the
// routes cannot round apart:
//
//   the epilogue: act((float(acc) * scale + bias) rounded to the output
//   type), the activation in float32 on the rounded value, rounded again;
//   the residual add: float(res) + float(y) rounded to the output type, as
//   PyTorch adds two bfloat16 (or float32) tensors;
//   the quantize: clip(rint(v / scale), -127, 127) on the float value of
//   what the output type holds, with the IEEE division's result, half to
//   even, as the plain version (ops/int8.py::quantize_activation) rounds
//   (a product with the reciprocal where that gives the same integer);
//
// each float operation an explicit _rn intrinsic (the build passes
// --fmad=false too), as the plain PyTorch versions round. silu calls expf,
// whose last bit may differ from PyTorch's build of the same libdevice
// function.
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// one accumulator -> its output value in O (float or __nv_bfloat16)
template <typename O>
__device__ __forceinline__ O dequantize(int32_t acc, float scale, float bias, int act) {
  const O* tag = nullptr;
  const float v = round_to(__fadd_rn(__fmul_rn((float)acc, scale), bias), tag);
  return to_out(activate(v, act), tag);
}

// a residual value plus an output value, in O
template <typename O>
__device__ __forceinline__ O add(O res, O y) {
  const O* tag = nullptr;
  return to_out(__fadd_rn(to_float(res), to_float(y)), tag);
}

// The quantize's scale and its correctly rounded reciprocal, for `quantize`
// (0 where the reciprocal is subnormal or infinite: the division decides).
struct QScale {
  float scale, inv;
};
__device__ __forceinline__ QScale qscale(float s) {
  const float inv = __frcp_rn(s);
  return {s, inv >= 0x1p-126f && inv <= 0x1p127f ? inv : 0.f};
}

// The quantize: clip(rint(v / scale), -127, 127) with the IEEE division,
// computed as a product where that gives the same integer. t = v * rn(1 /
// scale) lies within 2^-23 (plus 2^-48) relative of v / scale, so for |t| <
// 128 within 2^-16 of it, and the rounded quotient rn(v / scale) within
// 2^-17 of v / scale: the two differ by less than 2^-14. Where t is 2^-14 or
// farther from every half-integer, both lie strictly on one side of the
// same one and round (half to even) to the same integer; nearer, the
// division decides. |t| >= 128 puts the quotient past 127.99: both clamp
// to +-127. NaN and the infinities take the same clamps on both. A scale
// whose reciprocal is subnormal or infinite has no such bound: the division
// decides there.

// the product's integer; `near` set where the division must decide
__device__ __forceinline__ float rint_product(float x, QScale s, bool& near) {
  const float t = __fmul_rn(x, s.inv);
  const float q = rintf(t);
  near |= s.inv == 0.f || (fabsf(t) < 128.f && fabsf(t - q) > 0.5f - 0x1p-14f);
  return q;
}

__device__ __forceinline__ int8_t clamp127(float q) {
  return (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
}

// one activation value -> int8 at `s.scale`
template <typename T>
__device__ __forceinline__ int8_t quantize(T v, QScale s) {
  const float x = to_float(v);
  bool near = false;
  float q = rint_product(x, s, near);
  if (near) q = rintf(__fdiv_rn(x, s.scale));
  return clamp127(q);
}
__device__ __forceinline__ int8_t quantize(int8_t v, QScale) { return v; }

// N float values -> their `quantize` integers, packed four to a 32-bit word
// (value i in byte i % 4 of word i / 4): one test for the N, the division
// redoing all N where any product lies near a half-integer, instead of a
// branch a value.
template <int N>
__device__ __forceinline__ void quantize_pack(const float (&x)[N], QScale s,
                                              uint32_t (&out)[N / 4]) {
  float q[N];
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = rint_product(x[i], s, near);
  if (near) {
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = rintf(__fdiv_rn(x[i], s.scale));
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) out[i] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i / 4] |= (uint32_t)(uint8_t)clamp127(q[i]) << (8 * (i % 4));
}

}  // namespace fv_int8
