// The int8 conv's two passes around the int8 GEMM, for Hopper (sm_90a).
//
// The JAX package's quantized ConvBN (fastvision_tpu/nn/layers.py:100-122)
// is an XLA program, not a Pallas kernel: quantize the input (:110-112), an
// int8 x int8 -> int32 conv (:114-119), dequantize (:120-122), which XLA
// fuses around its conv. In the port the product is torch._int_mm
// (cuBLASLt's int8 tensor-core GEMM) over the conv's patches; these two
// kernels are the passes around it, each one pass over memory where eager
// PyTorch needs five to seven:
//
//   1. patches_kernel: NHWC activations [B, H, W, C] (bfloat16 or float32,
//      quantized here as clip(rint(x / in_scale), -127, 127), half to even
//      and an IEEE division, as the plain version rounds; or int8, copied)
//      -> the conv's patches, int8 [B * Ho * Wo, K_pad], columns in
//      (kh, kw, cin) order (the JAX package's HWIO flatten), zero in the
//      padding (spatial and past K = k * k * C). A k x k conv of a float
//      input with C a multiple of 8 runs it twice: quantize into an int8
//      copy of the input (k = 1), then gather from that, so each element is
//      divided once and not once per tap (the division is most of the work
//      of a fused pass: ~10 instructions an element);
//   2. epilogue_kernel: int32 accumulators [M, N_pad] (the GEMM's output)
//      -> act((float(acc) * scale[n] + bias[n]) rounded to the output type)
//      [M, N] in bfloat16 or float32, the activation computed in float32 on
//      the rounded value and rounded again, as PyTorch's kernels do.
//
// What bounds them on an H100: bytes. The patches kernel writes K_pad bytes
// a row (9x the input for a 3x3 conv) and reads each input element up to
// k^2 times, mostly from L2; the epilogue reads 4 bytes of accumulator and
// writes 2 (bfloat16) an output. Where C (N) is a multiple of 8, every
// layer but an RGB stem, a thread moves 8 channels (outputs) with 16-byte
// accesses and decomposes its index once for them; the patches kernel's
// blocks take one tap of a run of rows, the taps of a run side by side, so
// the k^2 reads of an input pixel mostly hit L2. The other shapes (an RGB
// stem, C = 3, K_pad past K) take the line kernel: a block stages the
// input lines of a run of output lines in shared memory, quantized once,
// and writes the run's patch rows in 16-byte (or 8-byte) units, neighbouring
// threads on neighbouring units, where one thread a row stored K_pad bytes
// 4 at a time before (a sector of a warp's store carried 4 useful bytes).
//
// Exactness: every float operation is an explicit _rn intrinsic (the build
// passes --fmad=false too), so the quantized bytes and the epilogue equal
// the plain version's; silu calls expf, whose last bit may differ from
// PyTorch's build of the same libdevice function. The quantize and the
// epilogue are int8_common.cuh's, which csrc/int8_conv.cu shares.
//
// Since the implicit-GEMM conv (csrc/int8_conv.cu) took the eligible convs
// (C a multiple of 32, k 1 or 3, groups 1), these passes run on the others
// (an RGB stem, grouped convs) and, as the k = 1 float case of
// fv_int8_patches, as the quantize pass before the implicit GEMM where the
// conv's producer does not write its int8 input (int8_conv.cu's epilogue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using fv_int8::dequantize;
using fv_int8::quantize;

constexpr int kThreads = 256;
constexpr int kLineSmem = 48 * 1024;  // the line kernel's shared memory, at most
constexpr int kLineRun = 4;           // output lines a block of the line kernel builds

// The other layers (an RGB stem: C = 3; any K_pad > K): a block builds the
// patch rows of a run of up to kLineRun output lines (b, oh0 ..) over TW
// output columns from ow0. It quantizes the input lines the run reads, each
// value once, into shared memory as int8 (zero in the halo), reading them
// in 16-byte loads (where x is 16-byte aligned; x's last chunk, where its
// end cuts it short, element by element), neighbouring threads on
// neighbouring loads; then assembles the rows in U-byte units (16 where
// K_pad is a multiple of 16, else 8), neighbouring threads on neighbouring
// units of the run's output, which is contiguous where a tile spans the
// line. Each thread keeps one unit column g of the rows and its U column
// offsets (where patch column g + i of a row sits in the staged lines, or
// -1 past K) in registers, and walks the rows without dividing.
template <typename T, int U>
__global__ void patches_line_kernel(const T* __restrict__ x, const float* __restrict__ in_scale,
                                    int8_t* __restrict__ out, int H, int W, int C, int Ho, int Wo,
                                    int k, int stride, int pad, int K_pad, int run, int TW,
                                    int w_tiles, bool vec, long long n_elems) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int* col_off = reinterpret_cast<int*>(smem_raw);                  // [K_pad]
  int8_t* lines = reinterpret_cast<int8_t*>(smem_raw) + 4 * K_pad;  // [n_lines][span * C]
  const int runs = (Ho + run - 1) / run;
  const int w_tile = blockIdx.x % w_tiles;
  const int t = blockIdx.x / w_tiles;
  const int oh0 = (t % runs) * run;
  const long long b = t / runs;
  const int n_out = min(run, Ho - oh0);                  // output lines of this run
  const int ow0 = w_tile * TW, nw = min(TW, Wo - ow0);   // output columns of this tile
  const int span = (nw - 1) * stride + k;                // input columns the tile reads
  const int line_bytes = span * C;
  const int n_lines = (n_out - 1) * stride + k;          // input lines the run reads
  const int ih0 = oh0 * stride - pad, iw0 = ow0 * stride - pad;
  const int K = k * k * C;
  for (int col = threadIdx.x; col < K_pad; col += blockDim.x) {
    int off = -1;
    if (col < K) {
      const int tap = col / C, c = col - tap * C;
      const int kh = tap / k, kw = tap - kh * k;
      off = kh * line_bytes + kw * C + c;
    }
    col_off[col] = off;
  }
  // byte r of a staged line is input element e0 + r, r = (iw - iw0) * C + c;
  // [lo, hi) lies inside the image, the rest is the halo
  const int lo = max(0, -iw0) * C, hi = min(span, W - iw0) * C;
  const fv_int8::QScale scale = fv_int8::qscale(in_scale ? *in_scale : 1.f);
  constexpr int kVec = 16 / (int)sizeof(T);
  for (int l = 0; l < n_lines; ++l) {
    const int ih = ih0 + l;
    int8_t* dst = lines + l * line_bytes;
    const bool row_in = ih >= 0 && ih < H;
    for (int r = threadIdx.x; r < line_bytes; r += blockDim.x)
      if (!row_in || r < lo || r >= hi) dst[r] = 0;
    if (!row_in || hi <= lo) continue;
    const long long e0 = ((b * H + ih) * W + iw0) * (long long)C;
    if (vec) {  // the aligned 16-byte chunks of x that hold elements e0 + lo .. e0 + hi - 1
      const long long first = (e0 + lo) / kVec * kVec;
      const int chunks = (int)((e0 + hi - first + kVec - 1) / kVec);
      for (int ch = threadIdx.x; ch < chunks; ch += blockDim.x) {
        const long long e = first + (long long)ch * kVec;
        if (e + kVec <= n_elems) {
          const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
          const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int r = (int)(e + i - e0);
            if (r >= lo && r < hi) dst[r] = quantize(vals[i], scale);
          }
        } else {  // x's last chunk, cut short by its end: element by element, none past it
          for (int i = 0; i < kVec; ++i) {
            const int r = (int)(e + i - e0);
            if (r >= lo && r < hi) dst[r] = quantize(x[e + i], scale);
          }
        }
      }
    } else {
      for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) dst[r] = quantize(x[e0 + r], scale);
    }
  }
  __syncthreads();
  const int units_per_row = K_pad / U;
  const int rows = n_out * nw;  // the run's rows: line li of the run, column ow of the tile
  auto store = [&](int li, int ow, int g, const int (&off)[U]) {
    const int8_t* src = lines + li * stride * line_bytes + ow * stride * C;
    uint32_t v[U / 4] = {};  // the unit's bytes, packed into 32-bit words in registers
#pragma unroll
    for (int i = 0; i < U; ++i)
      v[i / 4] |= (off[i] >= 0 ? (uint32_t)(uint8_t)src[off[i]] : 0u) << (8 * (i % 4));
    int8_t* d = out + ((b * Ho + oh0 + li) * Wo + ow0 + ow) * (long long)K_pad + g;
    if constexpr (U == 16)
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(d) = make_uint2(v[0], v[1]);
  };
  const int per_pass = (int)blockDim.x / units_per_row;  // rows a pass of the block
  if (per_pass > 0) {
    if ((int)threadIdx.x >= per_pass * units_per_row) return;
    const int g = ((int)threadIdx.x % units_per_row) * U;
    int off[U];
#pragma unroll
    for (int i = 0; i < U; ++i) off[i] = col_off[g + i];
    int row = (int)threadIdx.x / units_per_row;
    int li = row / nw, ow = row - li * nw;
    const int dli = per_pass / nw, dow = per_pass - dli * nw;
    for (; row < rows; row += per_pass) {
      store(li, ow, g, off);
      li += dli;
      ow += dow;
      if (ow >= nw) {
        ow -= nw;
        ++li;
      }
    }
  } else {  // rows wider than the block: each thread walks units of the rows
    for (int u = threadIdx.x; u < rows * units_per_row; u += blockDim.x) {
      const int row = u / units_per_row, g = (u - row * units_per_row) * U;
      int off[U];
#pragma unroll
      for (int i = 0; i < U; ++i) off[i] = col_off[g + i];
      store(row / nw, row % nw, g, off);
    }
  }
}

// The layers whose C is a multiple of 8 (all but an RGB stem; then K_pad ==
// K): a thread moves 8 channels of one (row, tap) segment, one 16-byte load
// (bfloat16; two for float32, one 8-byte for int8) and one 8-byte store, and
// decomposes its row once per 8 outputs. Each block handles one tap of a
// run of rows; the taps of a run are neighbouring blocks, so the k^2 reads
// of an input pixel mostly hit L2.
template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  }
};
template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float* v) {
    float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <typename T>
__global__ void patches8_kernel(const T* __restrict__ x, const float* __restrict__ in_scale,
                                int8_t* __restrict__ out, int H, int W, int C, int Ho, int Wo,
                                int k, int stride, int pad, int K_pad) {
  const int taps = k * k;
  const int tap = blockIdx.x % taps;  // a block: one output line (b, oh) and one tap
  const int line = blockIdx.x / taps;
  const int kh = tap / k, kw = tap - kh * k;
  const int oh = line % Ho;
  const long long b = line / Ho;
  const int ih = oh * stride - pad + kh;
  const int cps = C / 8;  // chunks of 8 channels a segment
  const int n = Wo * cps;
  int8_t* line_out = out + (long long)line * Wo * K_pad + tap * C;
  if (ih < 0 || ih >= H) {  // the whole line is padding at this tap
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int ow = e / cps;
      *reinterpret_cast<uint2*>(line_out + (long long)ow * K_pad + (e - ow * cps) * 8) =
          make_uint2(0u, 0u);
    }
    return;
  }
  const T* line_in = x + (b * H + ih) * (long long)W * C;
  const fv_int8::QScale scale = fv_int8::qscale(in_scale ? *in_scale : 1.f);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int ow = e / cps;
    const int c = (e - ow * cps) * 8;
    const int iw = ow * stride - pad + kw;
    uint2 packed = make_uint2(0u, 0u);
    if (iw >= 0 && iw < W) {
      const T* src = line_in + (long long)iw * C + c;
      if constexpr (sizeof(T) == 1) {
        packed = *reinterpret_cast<const uint2*>(src);
      } else {  // 8 int8 values, packed into two 32-bit words in registers
        float v[8];
        uint32_t q[2];
        Vec8<T>::load(src, v);
        fv_int8::quantize_pack(v, scale, q);
        packed = make_uint2(q[0], q[1]);
      }
    }
    *reinterpret_cast<uint2*>(line_out + (long long)ow * K_pad + c) = packed;
  }
}

// acc [M, N_pad] -> out [M, N]
template <typename O, typename I>
__global__ void epilogue_kernel(const int32_t* __restrict__ acc, const float* __restrict__ scale,
                                const float* __restrict__ bias, O* __restrict__ out, I M, int N,
                                int N_pad, int act) {
  const I total = M * N;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (I)gridDim.x * blockDim.x) {
    const I m = i / N;
    const int n = (int)(i - m * N);
    out[i] = dequantize<O>(acc[m * N_pad + n], scale[n], bias[n], act);
  }
}

// N a multiple of 8 and N_pad == N: a thread dequantizes 8 outputs of a
// row (two 16-byte loads of accumulators, one 16- or 32-byte store)
template <typename O, typename I>
__global__ void epilogue8_kernel(const int32_t* __restrict__ acc, const float* __restrict__ scale,
                                 const float* __restrict__ bias, O* __restrict__ out, I units,
                                 int N, int act) {
  const int cpr = N / 8;
  for (I u = (I)blockIdx.x * blockDim.x + threadIdx.x; u < units; u += (I)gridDim.x * blockDim.x) {
    const I m = u / cpr;
    const int n = (int)(u - m * cpr) * 8;
    const I base = m * N + n;
    const int4 a0 = reinterpret_cast<const int4*>(acc + base)[0];
    const int4 a1 = reinterpret_cast<const int4*>(acc + base)[1];
    const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    O y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = dequantize<O>(a[i], scale[n + i], bias[n + i], act);
    if constexpr (sizeof(O) == 2) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(y);
    } else {
      reinterpret_cast<float4*>(out + base)[0] = reinterpret_cast<const float4*>(y)[0];
      reinterpret_cast<float4*>(out + base)[1] = reinterpret_cast<const float4*>(y)[1];
    }
  }
}

template <typename T>
cudaError_t launch_patches(const void* x, const float* in_scale, int8_t* out, int B, int H,
                           int W, int C, int k, int stride, int pad, int K_pad,
                           cudaStream_t st) {
  const int Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const int K = k * k * C;
  if (M == 0) return cudaSuccess;
  if (M >= (1LL << 30)) return cudaErrorInvalidValue;  // 32-bit rows, strides included
  if (C % 8 == 0 && K_pad == K && (reinterpret_cast<uintptr_t>(x) % 16) == 0) {
    const long long blocks = (long long)B * Ho * k * k;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    patches8_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)x, in_scale, out, H, W, C, Ho, Wo, k, stride, pad, K_pad);
  } else {
    // the run of lines and the tile of columns that fit the shared memory
    if (K_pad % 8 || reinterpret_cast<uintptr_t>(out) % 8) return cudaErrorInvalidValue;
    const int fixed = 4 * K_pad;
    int run = kLineRun < Ho ? kLineRun : Ho, TW = Wo;
    auto smem = [&](int r, int tw) {
      return fixed + (long long)((r - 1) * stride + k) * ((tw - 1) * stride + k) * C;
    };
    while (run > 1 && smem(run, TW) > kLineSmem) --run;
    if (smem(1, 1) > kLineSmem) return cudaErrorInvalidValue;  // one patch row's window
    if (smem(run, TW) > kLineSmem) {
      const long long per_col = (long long)k * stride * C;  // bytes each further column adds
      TW = (int)((kLineSmem - smem(1, 1)) / per_col) + 1;
      if (TW > Wo) TW = Wo;
    }
    const int w_tiles = (Wo + TW - 1) / TW;
    const long long blocks = (long long)B * ((Ho + run - 1) / run) * w_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int bytes = (int)smem(run, TW);
    const bool wide = K_pad % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const long long n_elems = (long long)B * H * W * C;
    if (wide)
      patches_line_kernel<T, 16><<<(unsigned)blocks, kThreads, bytes, st>>>(
          (const T*)x, in_scale, out, H, W, C, Ho, Wo, k, stride, pad, K_pad, run, TW, w_tiles,
          vec, n_elems);
    else
      patches_line_kernel<T, 8><<<(unsigned)blocks, kThreads, bytes, st>>>(
          (const T*)x, in_scale, out, H, W, C, Ho, Wo, k, stride, pad, K_pad, run, TW, w_tiles,
          vec, n_elems);
  }
  return cudaGetLastError();
}

int sm_count(int device, cudaError_t* err) {
  static int counts[64];
  int n = device >= 0 && device < 64 ? counts[device] : 0;
  if (n == 0) {
    *err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (*err == cudaSuccess && device >= 0 && device < 64) counts[device] = n;
  }
  return n;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8 (then in_scale is null: a copy).
// x NHWC [B, H, W, C] contiguous, out [B * Ho * Wo, K_pad] int8, 8-byte
// aligned, K_pad a multiple of 8. With a
// float input, a k > 1 conv and C a multiple of 8, `scratch` (int8, B * H *
// W * C bytes, 16-byte aligned, or null) takes the quantized input first,
// and the patches are gathered from it: each input element is then divided
// once, not once per tap (the division is most of the fused pass's work).
// Returns the first non-zero cudaError_t of the launches, 0 on success.
int fv_int8_patches(const void* x, int dtype, const float* in_scale, void* scratch, void* out,
                    int B, int H, int W, int C, int k, int stride, int pad, int K_pad,
                    int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K_pad < k * k * C || K_pad % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* o = (int8_t*)out;
  if (scratch && dtype != 2 && k > 1 && C % 8 == 0 && K_pad == k * k * C &&
      reinterpret_cast<uintptr_t>(scratch) % 16 == 0) {
    int8_t* q = (int8_t*)scratch;
    err = dtype == 0 ? launch_patches<float>(x, in_scale, q, B, H, W, C, 1, 1, 0, C, st)
                     : launch_patches<__nv_bfloat16>(x, in_scale, q, B, H, W, C, 1, 1, 0, C, st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_patches<int8_t>(q, nullptr, o, B, H, W, C, k, stride, pad, K_pad, st);
  }
  switch (dtype) {
    case 0: err = launch_patches<float>(x, in_scale, o, B, H, W, C, k, stride, pad, K_pad, st); break;
    case 1: err = launch_patches<__nv_bfloat16>(x, in_scale, o, B, H, W, C, k, stride, pad, K_pad, st); break;
    case 2: err = launch_patches<int8_t>(x, nullptr, o, B, H, W, C, k, stride, pad, K_pad, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// acc [M, N_pad] int32 contiguous, scale / bias [N] float32, out [M, N]
// (out_dtype 0 float32, 1 bfloat16), act 0 none / 1 relu / 2 leaky / 3 silu.
int fv_int8_epilogue(const int32_t* acc, const float* scale, const float* bias, void* out,
                     long long M, int N, int N_pad, int out_dtype, int act, int device,
                     void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  if (N > N_pad || act < 0 || act > 3) return (int)cudaErrorInvalidValue;
  const int n_sm = sm_count(device, &err);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (N % 8 == 0 && N_pad == N && (reinterpret_cast<uintptr_t>(acc) % 16) == 0 &&
      (reinterpret_cast<uintptr_t>(out) % 16) == 0) {
    const long long units = M * (N / 8);
    long long blocks = (units + kThreads - 1) / kThreads;
    if (blocks > 32LL * n_sm) blocks = 32LL * n_sm;  // a grid-stride loop past ~32 blocks an SM
    const bool narrow = M * N < (1LL << 30);
    if (out_dtype == 0 && narrow)
      epilogue8_kernel<float, int><<<(unsigned)blocks, kThreads, 0, st>>>(
          acc, scale, bias, (float*)out, (int)units, N, act);
    else if (out_dtype == 0)
      epilogue8_kernel<float, long long><<<(unsigned)blocks, kThreads, 0, st>>>(
          acc, scale, bias, (float*)out, units, N, act);
    else if (out_dtype == 1 && narrow)
      epilogue8_kernel<__nv_bfloat16, int><<<(unsigned)blocks, kThreads, 0, st>>>(
          acc, scale, bias, (__nv_bfloat16*)out, (int)units, N, act);
    else if (out_dtype == 1)
      epilogue8_kernel<__nv_bfloat16, long long><<<(unsigned)blocks, kThreads, 0, st>>>(
          acc, scale, bias, (__nv_bfloat16*)out, units, N, act);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  const long long total = M * N;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 32LL * n_sm) blocks = 32LL * n_sm;  // a grid-stride loop past ~32 blocks an SM
  const bool narrow = M * N_pad < (1LL << 30);  // 32-bit index arithmetic, strides included
  if (out_dtype == 0 && narrow)
    epilogue_kernel<float, int><<<(unsigned)blocks, kThreads, 0, st>>>(
        acc, scale, bias, (float*)out, (int)M, N, N_pad, act);
  else if (out_dtype == 0)
    epilogue_kernel<float, long long><<<(unsigned)blocks, kThreads, 0, st>>>(
        acc, scale, bias, (float*)out, M, N, N_pad, act);
  else if (out_dtype == 1 && narrow)
    epilogue_kernel<__nv_bfloat16, int><<<(unsigned)blocks, kThreads, 0, st>>>(
        acc, scale, bias, (__nv_bfloat16*)out, (int)M, N, N_pad, act);
  else if (out_dtype == 1)
    epilogue_kernel<__nv_bfloat16, long long><<<(unsigned)blocks, kThreads, 0, st>>>(
        acc, scale, bias, (__nv_bfloat16*)out, M, N, N_pad, act);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* fv_int8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
