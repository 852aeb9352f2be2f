// Greedy NMS suppression mask for Hopper (sm_90a), batched over images.
//
// Replaces fastvision_tpu/ops/nms_pallas.py::_nms_kernel (and computes what
// fastvision_tpu/ops/nms.py::suppression_mask computes): over K boxes sorted
// by descending score, box i is kept iff its score is > -inf and no KEPT
// earlier box j has inter / (area_j + area_i - inter + 1e-7) > thr.
//
// Two kernels, both on the caller's stream, neither synchronises. Scratch
// mask: the upper-triangle 64x64 tiles (row tile t, column tile w >= t) of
// each image, n (n + 1) / 2 tiles of 64 words (n = ceil(K/64)), in row-tile
// order, so that a "chunk" (row tile t with all its column tiles) is one
// contiguous block. A tile holds one word per row: bit c of row i's word is
// set iff box j = 64 w + c > i and iou(i, j) > thr (rows past K: zero).
//
//   1. overlap_mask_kernel: only the upper-triangle tiles are launched; a
//      linear tile index maps to (row tile, column tile >= row tile). A
//      block of 256 threads builds 4 tiles with one thread per row, or 2
//      with two (every other column each, bits combined by a shuffle) while
//      those blocks fit in one wave: 8 images then get twice the warps to
//      hide latency, and 256 images blocks that live long enough. The
//      tiles' 64 column boxes and their areas are staged in shared memory.
//      The inner loop has no j > i test (the diagonal tile masks its bits
//      afterwards) and tests the x overlap before anything else: with class
//      offsets almost every pair is disjoint in x and costs two compares.
//      A tile's 64 words are stored by neighbouring threads (coalesced).
//   2. greedy_scan_kernel: one block per image, warp-specialised, the
//      warps handing work over through mbarriers:
//      - warp 0 (producer) copies one chunk at a time with one
//        cp.async.bulk (the copy takes uniform operands, so many small
//        copies would be issued one lane at a time) into a ring of kStages
//        stages, and builds the valid flags of all K rows as a bit vector
//        in shared memory;
//      - warp 1 (scanner) loads the chunk's 64 diagonal words (contiguous:
//        32 16-byte loads at fixed offsets) into registers and runs the
//        serial step over them, branch-free (row r kept iff its bit of `cur`
//        is clear; if kept, its diagonal word is OR-ed into `cur`, through
//        integer masks, two rows per step), starting from
//        cur = removed | ~valid; it ORs the kept rows' words of column tile
//        t + 1 itself (one warp reduction) and goes straight on to the next
//        chunk;
//      - warps 2-5 (updaters) meanwhile OR the kept rows' words of column
//        tiles w >= t + 2 into the removed set (a warp per tile, lanes over
//        rows). The removed set lives in shared memory (one word per 64
//        boxes), so any K up to kMaxK works.
//
// What bounds it on an H100: the pair work is ~K^2/2 pairs per image, two
// fp32 compares for a pair disjoint in x (almost all, with class offsets)
// and ~14 operations for the rest (no tensor cores), and the bytes are only
// the boxes and scores in and the keep mask out (~21 B per box), so phase 1
// is bound by operations; phase 2 is a K-step dependent chain per image,
// two integer operations per row on registers, with the mask's staging and
// the removed-set update off that chain. At small B the chain's latency, not
// any rate, sets the time.
//
// Exactness: the plain version rounds every intermediate as its own float32
// tensor. The arithmetic below uses the _rn intrinsics and the build passes
// --fmad=false, so nothing is contracted into an FMA (at class-offset
// magnitudes, ~3.3e5, a contracted area_i + area_j - iw * ih rounds
// otherwise and can flip a pair that sits on the threshold). Division is
// IEEE (__fdiv_rn), and the test is iou > thr in float32, as in the plain
// version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // boxes per tile: one 64-bit mask word
constexpr int kBlockThreads = 256;  // phase 1
constexpr int kStages = 3;          // phase 2: ring of staged chunks
constexpr int kUpdaters = 128;      // phase 2: warps 2-5
constexpr int kScanThreads = 64 + kUpdaters;
constexpr int kMaxK = 8192;         // 3 stages of up to 128 tiles: 192 KiB
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kBarStart = 1;        // named barriers (0 is __syncthreads)
constexpr int kBarUpdaters = 2;

typedef unsigned long long u64;

// First tile of row tile t in an image's upper triangle of n x n tiles.
__host__ __device__ __forceinline__ int chunk_start(int n, int t) {
  return t * n - t * (t - 1) / 2;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// kSplit threads per row of a tile, each on every kSplit-th column; a block
// of kBlockThreads builds kBlockThreads / (64 kSplit) tiles.
template <int kSplit>
__global__ void __launch_bounds__(kBlockThreads) overlap_mask_kernel(
    const float* __restrict__ boxes, u64* __restrict__ mask,
    int K, int n, int n_tiles, long long total, float thr) {
  constexpr int kTiles = kBlockThreads / (kTile * kSplit);
  const int g = threadIdx.x / (kTile * kSplit);  // the block's tile
  const int lt = threadIdx.x % (kTile * kSplit);
  // thread = (row t, columns q, q + kSplit, ...); a row's kSplit threads
  // are neighbouring lanes and combine their bits by shuffles
  const int t = lt / kSplit;
  const int q = lt % kSplit;
  // With iw == 0 or ih == 0 the IoU is 0, -0 or NaN, never > thr when
  // thr >= 0: the rest of the test is skipped for those pairs only then.
  const bool exact_all = !(thr >= 0.f);
  __shared__ float4 cols[kTiles][kTile];
  __shared__ float col_area[kTiles][kTile];

  const long long gt = (long long)blockIdx.x * kTiles + g;  // (image, tile), flattened
  const bool active = gt < total;
  const int b = active ? (int)(gt / n_tiles) : 0;
  const int tile = active ? (int)(gt % n_tiles) : 0;
  // tiles in column order over the upper triangle: column tile c holds row
  // tiles 0..c and starts at linear index c (c + 1) / 2
  int c = (int)((sqrtf(8.f * (float)tile + 1.f) - 1.f) * 0.5f);
  while (c * (c + 1) / 2 > tile) --c;
  while ((c + 1) * (c + 2) / 2 <= tile) ++c;
  const int r = tile - c * (c + 1) / 2;
  const float4* img = reinterpret_cast<const float4*>(boxes + (size_t)b * K * 4);
  const int i = r * kTile + t;
  const float4 bi = img[min(i, K - 1)];

  const int j0 = c * kTile;
  if (active && lt < kTile) {
    float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);  // past K: masked below
    if (j0 + lt < K) bj = img[j0 + lt];
    cols[g][lt] = bj;
    col_area[g][lt] = box_area(bj.x, bj.y, bj.z, bj.w);
  }
  __syncthreads();
  if (!active) return;  // whole groups of kTile * kSplit threads: whole warps

  const float area_i = box_area(bi.x, bi.y, bi.z, bi.w);
  u64 bits = 0ull;
#pragma unroll 16
  for (int u = 0; u < kTile / kSplit; ++u) {
    const int cc = u * kSplit + q;  // a warp's kSplit threads of a row read neighbouring boxes
    const float4 bj = cols[g][cc];
    // disjoint in x unless both compares hold (then min(x2) - max(x1) <= 0
    // exactly): two compares instead of the overlap's four operations
    if ((bj.x < bi.z && bi.x < bj.z) || exact_all) {
      const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      if (inter > 0.f || exact_all) {
        const float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_i, col_area[g][cc]), inter), 1e-7f);
        if (__fdiv_rn(inter, uni) > thr) bits |= 1ull << cc;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kSplit; m <<= 1) bits |= __shfl_xor_sync(kFullWarp, bits, m);
  if (q != 0) return;
  // rows past K get zero words: the scan reads whole tiles, and its step
  // needs every diagonal word free of bits at or below its own row
  if (i >= K) bits = 0ull;
  if (r == c) bits &= t == kTile - 1 ? 0ull : ~0ull << (t + 1);  // only j > i
  const int n_cols = K - j0;
  if (n_cols < kTile) bits &= (1ull << n_cols) - 1ull;
  mask[((size_t)b * n_tiles + chunk_start(n, r) + (c - r)) * kTile + t] = bits;
}

// --- Hopper asynchronous-copy and barrier primitives (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u64* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(u64* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completion is counted on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// Two serial steps, rows r and r + 1, on the 32-bit half `w` of cur that
// holds their bits (r even; bit = 1 << (r mod 32)); `o` is the other half
// (the higher one, or none), updated off the chain. Row r is kept iff its
// bit of w is clear; a kept row ORs its diagonal word (d0, d1: halves
// (w, o)) into cur. Integer masks instead of predicates: a predicate waits
// much longer before its first use than an integer result does. Since a
// diagonal word has no bit at or below its own row, (w & bit) - 1 is all
// ones if row r is kept and masks nothing of d0 otherwise; row r's effect on
// row r + 1 (e: row r suppresses row r + 1) is known before the chain. The
// chain is 4 dependent operations per 2 rows.
__device__ __forceinline__ void step_pair(uint32_t& w, uint32_t& o, uint32_t bit, uint32_t d0w,
                                          uint32_t d0o, uint32_t d1w, uint32_t d1o) {
  const uint32_t e = (d0w & (bit << 1)) ? ~0u : 0u;
  const uint32_t m0 = (w & bit) - 1u;                       // all ones iff row r kept
  const uint32_t m1 = ((w & (bit << 1)) - 1u) & ~(m0 & e);  // iff row r + 1 kept
  w = (w | (d0w & m0)) | (d1w & m1);
  // the other half needs all-or-nothing masks: the sign bits of m0, m1
  o |= (d0o & (uint32_t)((int32_t)m0 >> 31)) | (d1o & (uint32_t)((int32_t)m1 >> 31));
}

// The serial step over one staged chunk: diag[r] is row r's diagonal word.
// Row r is kept iff bit r of cur is clear; a kept row ORs its diagonal word
// (bits > r only) into cur. The 64 words are contiguous and loaded into
// registers first (16 bytes, two rows, per load at fixed offsets), so that
// nothing on the chain waits for memory. Rows 32..63 have nothing below
// bit 32 in their diagonal word.
__device__ __forceinline__ u64 scan_chunk(const u64* diag, u64 cur) {
  const uint4* d4 = reinterpret_cast<const uint4*>(diag);
  uint4 d[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) d[r] = d4[r];  // rows 2r (x, y) and 2r + 1 (z, w)
  uint32_t lo = (uint32_t)cur, hi = (uint32_t)(cur >> 32), none = 0u;
#pragma unroll
  for (int r = 0; r < 16; ++r) step_pair(lo, hi, 1u << (2 * r), d[r].x, d[r].y, d[r].z, d[r].w);
#pragma unroll
  for (int r = 16; r < 32; ++r) step_pair(hi, none, 1u << (2 * r - 32), d[r].y, 0u, d[r].w, 0u);
  return ((u64)hi << 32) | lo;
}

size_t scan_smem_bytes(int n) {
  return (size_t)kStages * n * kTile * 8  // staged chunks
         + (size_t)2 * n * 8              // removed set, valid flags
         + (size_t)kStages * 8            // each staged chunk's kept rows
         + (size_t)(3 * kStages + 2) * 8; // full, empty, kept_full, or_done
}

__global__ void __launch_bounds__(kScanThreads, 1) greedy_scan_kernel(
    const float* __restrict__ scores, const u64* __restrict__ mask,
    unsigned char* __restrict__ keep, int K, int n, int n_tiles) {
  extern __shared__ __align__(128) u64 smem[];
  const size_t stage_words = (size_t)n * kTile;
  u64* stages = smem;
  u64* removed = stages + kStages * stage_words;
  u64* valid = removed + n;
  u64* kept_ring = valid + n;
  u64* full = kept_ring + kStages;     // chunk staged (producer -> all)
  u64* empty = full + kStages;         // stage free (scanner + updaters -> producer)
  u64* kept_full = empty + kStages;    // chunk's kept rows known (scanner -> updaters)
  u64* or_done = kept_full + kStages;  // [2], by chunk parity (updaters -> scanner)

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* s = scores + (size_t)b * K;
  const u64* m = mask + (size_t)b * n_tiles * kTile;
  unsigned char* out = keep + (size_t)b * K;

  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], 2);
      mbar_init(&kept_full[q], 1);
    }
    mbar_init(&or_done[0], 1);
    mbar_init(&or_done[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int w = threadIdx.x; w < n; w += kScanThreads) removed[w] = 0ull;
  __syncthreads();

  if (warp == 0) {
    // --- producer: chunk t = tiles (t, t..n-1), staged from tile (t, t) on
    auto issue = [&](int t) {
      if (lane == 0) {
        const int q = t % kStages;
        const uint32_t bytes = (uint32_t)(n - t) * kTile * 8u;
        mbar_arrive_expect_tx(&full[q], bytes);
        bulk_copy(stages + q * stage_words, m + (size_t)chunk_start(n, t) * kTile, bytes, &full[q]);
      }
    };
    const int first = min(kStages, n);
    for (int t = 0; t < first; ++t) issue(t);
    // the valid flags of all rows, 32 loads in flight per lane (K = 1024
    // in one round trip)
    uint32_t* valid32 = reinterpret_cast<uint32_t*>(valid);
    for (int h0 = 0; h0 < 2 * n; h0 += 32) {
      float v[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int i = (h0 + q) * 32 + lane;
        v[q] = i < K ? s[i] : -INFINITY;
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const uint32_t bits = __ballot_sync(kFullWarp, v[q] > -INFINITY);
        if (lane == 0 && h0 + q < 2 * n) valid32[h0 + q] = bits;
      }
    }
    bar_arrive(kBarStart, 64);
    for (int t = first; t < n; ++t) {
      mbar_wait(&empty[t % kStages], (uint32_t)((t / kStages - 1) & 1));
      issue(t);
    }
  } else if (warp == 1) {
    // --- scanner: the serial step, chunk after chunk. removed[t] holds the
    // updaters' words from chunks <= t - 2 (or_done), `next` chunk t - 1's.
    bar_sync(kBarStart, 64);  // valid flags written
    u64 next = 0ull;
    for (int t = 0; t < n; ++t) {
      const int q = t % kStages;
      mbar_wait(&full[q], (uint32_t)((t / kStages) & 1));
      if (t >= 2) mbar_wait(&or_done[t & 1], (uint32_t)(((t - 2) >> 1) & 1));
      const u64* tiles = stages + q * stage_words;  // tile (t, w) at (w - t) * 64
      // each lane's two rows' words of column tile t + 1, loaded ahead
      const bool more = t + 1 < n;
      const u64 e0 = more ? tiles[kTile + lane] : 0ull;
      const u64 e1 = more ? tiles[kTile + 32 + lane] : 0ull;
      // rows past K have valid 0, so they start (and stay) in cur
      const u64 kept = ~scan_chunk(tiles, removed[t] | next | ~valid[t]);
      // the next chunk's removed word: OR of the kept rows' words
      const u64 v = (((kept >> lane) & 1ull) ? e0 : 0ull) |
                    (((kept >> (lane + 32)) & 1ull) ? e1 : 0ull);
      next = (u64)__reduce_or_sync(kFullWarp, (uint32_t)v) |
             ((u64)__reduce_or_sync(kFullWarp, (uint32_t)(v >> 32)) << 32);
      if (lane == 0) {
        kept_ring[q] = kept;
        mbar_arrive(&kept_full[q]);
      }
      const int i0 = t * kTile;
      if (i0 + lane < K) out[i0 + lane] = (unsigned char)((kept >> lane) & 1ull);
      if (i0 + 32 + lane < K) out[i0 + 32 + lane] = (unsigned char)((kept >> (32 + lane)) & 1ull);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[q]);
    }
  } else {
    // --- updaters: removed[w] |= the kept rows' words of column tile w, for
    // w >= t + 2, while the scanner goes on with chunk t + 1: a warp per
    // tile, lanes over its 64 rows (neighbouring words), one warp reduction
    const int uw = warp - 2;
    for (int t = 0; t < n; ++t) {
      const int q = t % kStages;
      mbar_wait(&kept_full[q], (uint32_t)((t / kStages) & 1));
      mbar_wait(&full[q], (uint32_t)((t / kStages) & 1));  // the copy's data, seen here too
      const u64 kept = kept_ring[q];
      const u64* tiles = stages + q * stage_words;
      const bool k0 = (kept >> lane) & 1ull, k1 = (kept >> (lane + 32)) & 1ull;
      if (kept != 0ull) {
        for (int w = t + 2 + uw; w < n; w += kUpdaters / 32) {
          const u64* tw = tiles + (size_t)(w - t) * kTile;
          const u64 v = (k0 ? tw[lane] : 0ull) | (k1 ? tw[lane + 32] : 0ull);
          const uint32_t lo = __reduce_or_sync(kFullWarp, (uint32_t)v);
          const uint32_t hi = __reduce_or_sync(kFullWarp, (uint32_t)(v >> 32));
          if (lane == 0) removed[w] |= ((u64)hi << 32) | lo;
        }
      }
      bar_sync(kBarUpdaters, kUpdaters);
      if (threadIdx.x == 64) {
        mbar_arrive(&empty[q]);
        mbar_arrive(&or_done[t & 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// boxes [B, K, 4] float32 xyxy, scores [B, K] float32, mask scratch of
// fv_nms_scratch_bytes(B, K) bytes ([B, n (n + 1) / 2, 64] uint64, n =
// ceil(K/64)), keep out [B, K] bytes (0/1). Returns the first non-zero cudaError_t of the launches, 0 on
// success.
int fv_nms_suppression_mask(const float* boxes, const float* scores, void* mask,
                            unsigned char* keep, int B, int K, float thr,
                            int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const int n = (K + kTile - 1) / kTile;
  const int n_tiles = n * (n + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  // per device, once: the SM count, and the scan's shared memory allowance
  // for the largest K (host calls that would otherwise come with every launch)
  static int sm_count[64];
  int n_sm = device < 64 ? sm_count[device] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(greedy_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scan_smem_bytes(kMaxK / kTile));
    if (err != cudaSuccess) return (int)err;
    if (device < 64) sm_count[device] = n_sm;
  }
  // two threads per row while those blocks fit in one wave (8 blocks of 256
  // threads per SM), else one
  const long long total = (long long)n_tiles * B;  // (image, tile) pairs
  if ((total + 1) / 2 <= 8LL * n_sm) {
    overlap_mask_kernel<2><<<(unsigned)((total + 1) / 2), kBlockThreads, 0, st>>>(
        boxes, (u64*)mask, K, n, n_tiles, total, thr);
  } else {
    overlap_mask_kernel<1><<<(unsigned)((total + 3) / 4), kBlockThreads, 0, st>>>(
        boxes, (u64*)mask, K, n, n_tiles, total, thr);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  greedy_scan_kernel<<<B, kScanThreads, scan_smem_bytes(n), st>>>(
      scores, (const u64*)mask, keep, K, n, n_tiles);
  return (int)cudaGetLastError();
}

int fv_nms_max_k(void) { return kMaxK; }

// Bytes of the mask scratch for B images of K boxes (the caller allocates
// it, 16-byte aligned).
long long fv_nms_scratch_bytes(int B, int K) {
  const long long n = (K + kTile - 1) / kTile;
  return (long long)B * (n * (n + 1) / 2) * kTile * 8;
}

const char* fv_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
