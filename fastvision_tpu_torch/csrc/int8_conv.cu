// The int8 conv as one implicit-GEMM kernel with its epilogue fused, for
// Hopper (sm_90a).
//
// What it replaces. The JAX package's quantized ConvBN
// (fastvision_tpu/nn/layers.py:100-122, `_quantized_forward`) is an XLA
// program, not a Pallas kernel: an int8 x int8 -> int32
// conv_general_dilated with the dequantize fused around it. The port's
// first route (ops/int8.py, csrc/int8.cu) wrote the conv's int8 patches
// [M, K] to memory, multiplied them with torch._int_mm into int32
// accumulators [M, N], and read those back in an epilogue pass: 4.2 GB of
// patches and 4.9 GB of accumulators over YOLOv3-416's convs at batch 32,
// where the work itself is 1.26 GB of int8 input read once and 2.45 GB of
// bfloat16 output written once. This kernel reads the int8 NHWC input and
// the weight matrix and writes the output, nothing else.
//
// What it computes, for a conv with C a multiple of 32, k in {1, 3},
// stride in {1, 2}, padding k / 2, groups 1, N a multiple of 8:
//   x  int8 NHWC [B, H, W, C] (written by its producer's epilogue, below,
//      or by one quantize pass),
//   w  int8 [N, K], K = k * k * C in (kh, kw, cin) order (ops/int8.py::
//      gemm_weight: already K-major, the only layout 8-bit wgmma takes for
//      either operand),
//   out [M, N], M = B * Ho * Wo, in one of two modes:
//   (a) y = act((float(acc) * scale[n] + bias[n]) rounded to the output
//       type) in bfloat16 or float32, int8_common.cuh's arithmetic, the one
//       the epilogue pass of csrc/int8.cu runs, so both routes give the
//       same bytes; and with it, as the caller asks: s = residual + y
//       rounded to the output type (Darknet's skip, PyTorch's add), and
//       the int8 input of the conv that consumes this one, quantize(s or y)
//       at that conv's input scale (read from the device), so the consumer
//       needs no quantize pass; y (or s) itself may be left unwritten when
//       only int8 convs read it;
//   (b) the int32 accumulators themselves.
// The integer sums are exact in any order: |acc| <= 127^2 * 9 * 1024 ~
// 1.5e8 < 2^31 here.
//
// The design. A block of 256 threads (two warpgroups) owns an output tile
// of BM = 128 rows (output pixels) by BN = 32, 64 or 128 channels (from N
// on the host). The K loop walks (tap, BK-byte chunk of C), BK 32, 64 or
// 128 bytes (the widest that divides C), through a ring of stages in shared
// memory filled by cp.async.cg: the activation tile is gathered, never
// materialized: each row's chunk is 16-byte copies from the NHWC input at
// (oh * stride - pad + kh, ow * stride - pad + kw), with src-size 0
// zero-filling the halo and the rows past M; the weight tile is 16-byte
// copies of w's rows (zero past N). Both tiles are written in the 32-, 64-
// or 128-byte swizzle that wgmma's descriptors name, so its reads are free
// of bank conflicts. The math is wgmma.mma_async m64nNk32 s8 x s8 -> s32,
// one 64-row half of the tile per warpgroup, the accumulators in
// registers. The epilogue runs from the registers, writes the tile in the
// output type into shared memory, and stores it as 16-byte coalesced rows;
// the residual add and the consumer's quantize run in that store loop, on
// each 16-byte chunk (every value is in a register there, and the loop is
// coalesced both ways), the residual's tile copied into the free ring by
// cp.async while the epilogue's arithmetic runs.
//
// What bounds it on an H100: int8 operations (2 M N K at 1,979 TOP/s) for
// the 3x3 layers, bytes (int8 in once, the output once) for the 1x1 ones;
// blocks that share an input tile are neighbours in launch order (the N
// tiles of an M tile run side by side), so the gather's re-reads mostly
// hit L2. As built it reaches about a fifth of that bound at YOLOv3-416's
// widths: the copies are not overlapped with the math, and 128 x 128 tiles
// re-read the operands from L2 once per tile (PERF.md times the parts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "int8_common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kThreads = 256;

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;             // [M, N] in the output type, or null: int8 only
  const void* residual;  // [M, N] in the output type, added after the activation, or null
  const float* out_scale;  // the consumer's input scale (one float32), with out_q
  int8_t* out_q;         // [M, N] int8: the sum (or the output) quantized at *out_scale, or null
  long long M;
  int H, W, C, N, k, stride, pad, Ho, Wo, act, n_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the shared-memory writes of cp.async (the generic proxy) made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x N, int32, registers) += A (64 x 32, K-major) * B (32 x N, K-major),
// A and B in shared memory, named by descriptors
__device__ __forceinline__ void wgmma_m64n32k32(int32_t (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));  // scale-d 1: D += A * B
}

__device__ __forceinline__ void wgmma_m64n64k32(int32_t (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));  // scale-d 1: D += A * B
}

__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));  // scale-d 1: D += A * B
}

template <int N>
__device__ __forceinline__ void wgmma_k32(int32_t (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 128) wgmma_m64n128k32(d, a, b);
  else if constexpr (N == 64) wgmma_m64n64k32(d, a, b);
  else wgmma_m64n32k32(d, a, b);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A K-major tile of BK-byte rows (BK 32, 64 or 128: one swizzle atom wide)
// as wgmma reads it: 16-byte chunk c of row r sits at chunk c ^ (r / (128 /
// BK)) % (BK / 16) of its row (the 32-, 64- and 128-byte swizzles); the
// tile starts on a 1024-byte boundary
template <int BK>
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * BK + ((c ^ ((r / (128 / BK)) % (BK / 16))) << 4);
}

// the descriptor of such a tile at shared address `addr`: 8-row groups BK * 8
// bytes apart, layout 1 / 2 / 3 = the 128- / 64- / 32-byte swizzle
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = BK == 128 ? 1 : BK == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(BK * 8 >> 4) << 32) |
         (layout << 62);
}

// two neighbouring outputs of a row, from their accumulators, into shared memory
__device__ __forceinline__ void put2(int32_t* p, int32_t a0, int32_t a1, float, float, float,
                                     float, int) {
  *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
}
__device__ __forceinline__ void put2(float* p, int32_t a0, int32_t a1, float s0, float s1,
                                     float b0, float b1, int act) {
  *reinterpret_cast<float2*>(p) = make_float2(fv_int8::dequantize<float>(a0, s0, b0, act),
                                              fv_int8::dequantize<float>(a1, s1, b1, act));
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, int32_t a0, int32_t a1, float s0, float s1,
                                     float b0, float b1, int act) {
  __nv_bfloat162 v;
  v.x = fv_int8::dequantize<__nv_bfloat16>(a0, s0, b0, act);
  v.y = fv_int8::dequantize<__nv_bfloat16>(a1, s1, b1, act);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// A tile shape and its ring: BN output channels, BK bytes of K a stage,
// STAGES stages (STAGES - 1 loaded ahead of the one computed)
template <int BN_, int BK_, int STAGES_, typename O>
struct Tile {
  static constexpr int BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int kABytes = kBM * BK, kStageBytes = (kBM + BN) * BK;
  static constexpr int kChunks = BK / 16;  // 16-byte copies a row
  static constexpr int kARowsPerPass = kThreads / kChunks;
  static constexpr int kAPasses = kBM / kARowsPerPass;
  static constexpr int kBPasses = (BN * kChunks + kThreads - 1) / kThreads;
  static constexpr int kORow = BN * (int)sizeof(O) + 16;  // staged output row
  static constexpr int kSmem =
      (STAGES * kStageBytes > kBM * kORow ? STAGES * kStageBytes : kBM * kORow) + 1024;
  // the residual's tile staged beside the output's, where the ring holds both
  static constexpr bool kStageResidual = 2 * kBM * kORow <= STAGES * kStageBytes;
  static_assert(kABytes % 1024 == 0 && (BN * BK) % 1024 == 0, "1024-byte swizzle atoms");
  static_assert(2 * (kSmem + 1024) <= 232448, "two blocks an SM");
};

template <class T, typename O>
__global__ void __launch_bounds__(kThreads, 2) int8_conv_kernel(const Conv p) {
  constexpr int BN = T::BN, BK = T::BK, STAGES = T::STAGES;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int n0 = (blockIdx.x % p.n_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / p.n_tiles) * kBM;

  // this thread's rows of the activation tile, decomposed once
  const int chunk = tid % T::kChunks;
  int ih0[T::kAPasses], iw0[T::kAPasses];
  long long pix0[T::kAPasses];  // the pixel index of (b, 0, 0)
  bool row_ok[T::kAPasses];
#pragma unroll
  for (int i = 0; i < T::kAPasses; ++i) {
    const long long m = m0 + tid / T::kChunks + i * T::kARowsPerPass;
    row_ok[i] = m < p.M;
    const long long mm = row_ok[i] ? m : 0;
    const int ow = (int)(mm % p.Wo);
    const long long t = mm / p.Wo;
    const int oh = (int)(t % p.Ho);
    pix0[i] = (t / p.Ho) * p.H * p.W;
    ih0[i] = oh * p.stride - p.pad;
    iw0[i] = ow * p.stride - p.pad;
  }
  const int c_chunks = p.C / BK;
  const int KT = p.k * p.k * c_chunks;
  const long long K = (long long)p.k * p.k * p.C;

  auto load_stage = [&](int kt, int slot) {
    const int tap = kt / c_chunks;
    const int c0 = (kt - tap * c_chunks) * BK;
    const int kh = tap / p.k, kw = tap - kh * p.k;
    uint8_t* sa = smem + slot * T::kStageBytes;
    uint8_t* sb = sa + T::kABytes;
#pragma unroll
    for (int i = 0; i < T::kAPasses; ++i) {
      const int row = tid / T::kChunks + i * T::kARowsPerPass;
      const int ih = ih0[i] + kh, iw = iw0[i] + kw;
      const bool ok = row_ok[i] && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      const int8_t* src =
          ok ? p.x + (pix0[i] + (long long)ih * p.W + iw) * p.C + c0 + chunk * 16 : p.x;
      cp_async16(sa + swizzled<BK>(row, chunk), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < T::kBPasses; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < BN * T::kChunks) {
        const int row = idx / T::kChunks, ch = idx - row * T::kChunks;
        const bool ok = n0 + row < p.N;
        const int8_t* src = ok ? p.w + (long long)(n0 + row) * K + (long long)kt * BK + ch * 16
                               : p.w;
        cp_async16(sb + swizzled<BK>(row, ch), src, ok ? 16 : 0);
      }
    }
  };

  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt have landed
    fence_proxy_async();          // visible to wgmma
    __syncthreads();  // every thread's; every warpgroup is done with the slot refilled next
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t sa = smem_addr(smem + (kt % STAGES) * T::kStageBytes);
    const uint32_t a0 = sa + wg * 64 * BK, b0 = sa + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32)
      wgmma_k32<BN>(acc, smem_desc<BK>(a0 + ks), smem_desc<BK>(b0 + ks));
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile is staged there

  constexpr bool kFloat = !std::is_same<O, int32_t>::value;
  constexpr int kPerChunk = 16 / (int)sizeof(O);
  constexpr int kChunksOut = BN / kPerChunk;
  uint8_t* res_tile = smem + kBM * T::kORow;
  if constexpr (kFloat && T::kStageResidual) {
    if (p.residual) {  // the residual's tile by cp.async, in flight while the epilogue computes
      for (int idx = tid; idx < kBM * kChunksOut; idx += kThreads) {
        const int row = idx / kChunksOut, ch = idx - row * kChunksOut;
        const long long m = m0 + row;
        const int n = n0 + ch * kPerChunk;
        if (m < p.M && n < p.N)
          cp_async16(res_tile + row * T::kORow + ch * 16,
                     reinterpret_cast<const O*>(p.residual) + m * p.N + n, 16);
      }
      cp_async_commit();
    }
  }

  // the epilogue from the registers: in each warp's 16 rows, thread (g, tg)
  // holds rows g and g + 8, columns 8 j + 2 tg and 8 j + 2 tg + 1
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + tg * 2;
    const int n = n0 + col;  // n even, N a multiple of 8: n < N means n + 1 < N
    float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (p.scale && n < p.N) {  // mode (a)
      s0 = p.scale[n];
      s1 = p.scale[n + 1];
      b0 = p.bias[n];
      b1 = p.bias[n + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + h * 8;
      put2(reinterpret_cast<O*>(smem + row * T::kORow) + col, acc[4 * j + 2 * h],
           acc[4 * j + 2 * h + 1], s0, s1, b0, b1, p.act);
    }
  }
  cp_async_wait<0>();  // this thread's copies of the residual's tile have landed
  __syncthreads();
  // the staged tile to memory, 16-byte chunks of a row, neighbouring threads
  // on neighbouring chunks; on the way, in mode (a), the residual's matching
  // chunk added and the consumer's int8 input written (kPerChunk bytes)
  const fv_int8::QScale q_scale = fv_int8::qscale(kFloat && p.out_q ? *p.out_scale : 1.f);
  for (int idx = tid; idx < kBM * kChunksOut; idx += kThreads) {
    const int row = idx / kChunksOut, ch = idx - row * kChunksOut;
    const long long m = m0 + row;
    const int n = n0 + ch * kPerChunk;
    if (m >= p.M || n >= p.N) continue;
    const long long off = m * p.N + n;
    uint4 v = *reinterpret_cast<const uint4*>(smem + row * T::kORow + ch * 16);
    if constexpr (kFloat) {
      O* vals = reinterpret_cast<O*>(&v);
      if (p.residual) {
        const uint4 r =
            T::kStageResidual
                ? *reinterpret_cast<const uint4*>(res_tile + row * T::kORow + ch * 16)
                : *reinterpret_cast<const uint4*>(reinterpret_cast<const O*>(p.residual) + off);
        const O* res = reinterpret_cast<const O*>(&r);
#pragma unroll
        for (int i = 0; i < kPerChunk; ++i) vals[i] = fv_int8::add(res[i], vals[i]);
      }
      if (p.out_q) {  // kPerChunk int8 values, packed into 32-bit words in registers
        float f[kPerChunk];
#pragma unroll
        for (int i = 0; i < kPerChunk; ++i) f[i] = fv_int8::to_float(vals[i]);
        uint32_t q[kPerChunk / 4];
        fv_int8::quantize_pack(f, q_scale, q);
        if constexpr (kPerChunk == 8)
          *reinterpret_cast<uint2*>(p.out_q + off) = make_uint2(q[0], q[1]);
        else
          *reinterpret_cast<uint32_t*>(p.out_q + off) = q[0];
      }
    }
    if (p.out) *reinterpret_cast<uint4*>(reinterpret_cast<O*>(p.out) + off) = v;
  }
}

template <class T, typename O>
cudaError_t launch(Conv& p, cudaStream_t st) {
  // the ring takes more than the default 48 KB of dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<T, O>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.N + T::BN - 1) / T::BN;
  const long long blocks = (p.M + kBM - 1) / kBM * p.n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  int8_conv_kernel<T, O><<<(unsigned)blocks, kThreads, T::kSmem, st>>>(p);
  return cudaGetLastError();
}

// the tile for a conv: BN from N, BK the widest of 128 / 64 / 32 bytes that
// divides C, the ring as deep as two blocks an SM allow
template <int BN, typename O>
cudaError_t launch_bk(Conv& p, cudaStream_t st) {
  if (p.C % 128 == 0) return launch<Tile<BN, 128, 3, O>, O>(p, st);
  if (p.C % 64 == 0) return launch<Tile<BN, 64, 4, O>, O>(p, st);
  return launch<Tile<BN, 32, 4, O>, O>(p, st);
}

template <typename O>
cudaError_t launch_for(Conv& p, cudaStream_t st) {
  if (p.N >= 128) return launch_bk<128, O>(p, st);
  if (p.N >= 64) return launch_bk<64, O>(p, st);
  return launch_bk<32, O>(p, st);
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

extern "C" {

// x int8 NHWC [B, H, W, C] contiguous, w int8 [N, k * k * C] contiguous;
// out [B * Ho * Wo, N] contiguous: out_dtype 0 float32 or 1 bfloat16 (mode
// (a): scale, bias float32 [N], act 0 none / 1 relu / 2 leaky_relu / 3
// silu) or 3 int32 (mode (b): scale, bias unused). In mode (a) also:
// residual (out_dtype, [M, N], or null) added to the output; out_q (int8
// [M, N], or null) the result quantized at *out_scale (a float32 on the
// device); out null when only out_q is wanted. Every pointer 16-byte
// aligned. C % 32 == 0, N % 8 == 0, k 1 or 3, stride 1 or 2, padding k / 2.
// Returns the launch's cudaError_t, 0 on success.
int fv_int8_conv(const void* x, const void* w, const float* scale, const float* bias, void* out,
                 const void* residual, const float* out_scale, void* out_q, int B, int H, int W,
                 int C, int N, int k, int stride, int out_dtype, int act, int device,
                 void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; };
  const bool mode_b = out_dtype == 3;
  if (C <= 0 || C % 32 || N <= 0 || N % 8 || (k != 1 && k != 3) || (stride != 1 && stride != 2) ||
      act < 0 || act > 3 || (!mode_b && (!scale || !bias)) || (!out && !out_q) ||
      (mode_b && (residual || out_q || !out)) || (out_q && !out_scale) || misaligned(x) ||
      misaligned(w) || misaligned(out) || misaligned(residual) || misaligned(out_q))
    return (int)cudaErrorInvalidValue;
  Conv p;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.scale = mode_b ? nullptr : scale;
  p.bias = mode_b ? nullptr : bias;
  p.out = out;
  p.residual = residual;
  p.out_scale = out_q ? out_scale : nullptr;
  p.out_q = (int8_t*)out_q;
  p.H = H;
  p.W = W;
  p.C = C;
  p.N = N;
  p.k = k;
  p.stride = stride;
  p.pad = k / 2;
  p.Ho = (H + 2 * p.pad - k) / stride + 1;
  p.Wo = (W + 2 * p.pad - k) / stride + 1;
  p.M = (long long)B * p.Ho * p.Wo;
  p.act = act;
  if (p.M <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (out_dtype) {
    case 0: return (int)launch_for<float>(p, st);
    case 1: return (int)launch_for<__nv_bfloat16>(p, st);
    case 3: return (int)launch_for<int32_t>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fv_int8_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
