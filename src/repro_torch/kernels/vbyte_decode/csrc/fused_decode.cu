// Kernel 2: fused decode -> epilogue, formats vbyte, streamvbyte and
// binpack.
//
// Replaces the TPU kernel src/repro/kernels/vbyte_decode/epilogues.py
// (fused_decode_pallas) for its three decode cores and all 11 of its
// epilogues: stream, checksum, membership, membership_rows, bm25_accum,
// bm25_accum_rows, bm25_weighted, bm25_weighted_rows (the search path),
// bag_sum and dot_score (embedding-bag and retrieval serving), and
// adjacency_rebase (GIN over compressed adjacency).
//
// What bounds it on an H100: bytes for the row-aligned epilogues (the
// decoded block never leaves shared memory; each block writes one int32),
// for the broadcast ones (membership, bm25_accum, bm25_weighted) the
// [nb, P] int32 output they write, and the gathered table rows for bag_sum
// and dot_score (one d-wide row per valid id, or per slot).
//
// What the design does about it: the warp-per-block decode cores that
// kernels 1, 3 and 4 run (vbyte_core.cuh, svb_core.cuh, binpack_core.cuh),
// then the optional scan, then an epilogue — the reference's
// core-plus-epilogue shape, with the main stream's format and the
// epilogue as template parameters (3 x 11 instantiations). The weighted
// epilogues' impact stream may have another format than the main stream,
// as in the reference's API; it is decoded dense, non-differential, with
// the main row's count, through a branch on a run-time format argument
// that is uniform across the grid. The decoded row and the impact row stay
// in shared memory.
//
// The broadcast epilogues run their own kernel (probe_kernel). Comparing
// every slot with every probe (B x P per block, as the reference does) is
// what held the first version at 3-5% of its bound, yet on the search path
// both sides are sorted: the d-gap coded block ascends and the probe set is
// a sorted run padded with -1. So the kernel checks that on the card — the
// row's valid slots non-decreasing as uint32 (one __all_sync), the probe
// set a non-decreasing run of values >= 0 followed only by negative ones
// (one __syncthreads_and) — and where both hold, two binary searches cut
// the probes to [a, b), those inside [slot 0, slot cnt-1]; each of those
// takes a lower bound over the row and walks the run of equal slots there
// (a gap of 0 repeats a docid), and every other probe writes 0. A row that
// is not sorted (garbage, differential=False, a prefix sum that wraps mod
// 2^32) compares every slot with every probe in the same kernel: that is
// the contract on such input, and both branches give the same bits on
// sorted input (integer sums mod 2^32 do not depend on their order). The
// path's launches carry 1-16 rows, where one warp per row leaves the card
// nearly empty: while every row has an SM of its own, a CTA of 4 warps
// serves one row (the weights decode on a second warp beside the
// main stream, and all four split the probes and the stores); larger
// launches keep one warp per row. Once the compare was gone, a launch took
// the same time for 1 block as for 4096: the chain of dependent reads
// (probes, count, bytes, control or width, weights), one device-memory
// round trip each, set the pace. So every read of the CTA is issued at once
// at the start (cp.async into shared memory, 16 bytes at a time where
// aligned) and the decode cores read the staged copies; what remains is
// the launch, that one round trip and the decode. Each lane writes 4
// consecutive outputs with one 16-byte store where P % 4 == 0.
//
// The gather epilogues read the table (f32 or bf16, a uniform run-time
// branch) in 16-byte chunks: lane l owns chunk l of a row (8 bf16 or 4
// f32 values), so one d = 256 bf16 row is one coalesced 512-byte load by
// the warp. Ids are clamped to [0, V-1] (the reference's mode="clip").
// bag_sum accumulates each column in f32 over the block's valid slots in
// ascending order; dot_score loads four slots' rows at a time, multiplies
// each with every query row (held in shared memory as f32) and reduces
// across the warp with shuffles. Each sum is rounded once, to the table's
// type for bag_sum and to bf16 for dot_score when both operands are bf16 —
// as the reference's bf16 sum and einsum are. wgmma, TMA and more rows in
// flight are later work.
#include <cuda_bf16.h>

#include "binpack_core.cuh"
#include "svb_core.cuh"
#include "vbyte_core.cuh"

namespace {

enum Format : int { kVbyte = 0, kStreamVbyte = 1, kBinpack = 2 };

enum Epilogue : int {
  kStream = 0,
  kChecksum = 1,
  kMembership = 2,
  kMembershipRows = 3,
  kBm25Accum = 4,
  kBm25AccumRows = 5,
  kBm25Weighted = 6,
  kBm25WeightedRows = 7,
  kBagSum = 8,
  kDotScore = 9,
  kAdjacencyRebase = 10,
};

constexpr int kQueryGroup = 8;  // dot_score query rows per register pass
// probe_kernel's shared memory when it stages the rows' bytes as well
constexpr size_t kMaxProbeSmem = 96u << 10;

struct FusedParams {
  const uint8_t* bytes;  // vbyte payload or streamvbyte/binpack data [nb, S]
  const uint8_t* meta;   // streamvbyte control [nb, B/4] or binpack widths [nb, 1]
  const int* counts;
  const int* bases;
  long long nb;
  int S;
  int B;
  int differential;
  const int* probe;  // broadcast [P], or tiled [nb] for the *_rows epilogues
  int P;
  const int* impact;  // [1]
  int w_format;  // the aligned impact stream's format
  const uint8_t* w_bytes;  // [nb, S_w]
  const uint8_t* w_meta;   // [nb, B/4] or [nb, 1]
  int S_w;
  const void* table;  // bag_sum / dot_score [V, d], f32 or bf16
  long long V;
  int d;
  int table_bf16;
  int table_vec16;  // rows are 16-byte aligned chunks: vector loads
  const float* query;  // dot_score [nq, d]
  int nq;
  int round_bf16;  // dot_score: round each score to bf16 (both operands bf16)
  const int* edge_base;  // adjacency_rebase [nb, B]
  int* out;  // int32 outputs; dot_score's ids
  int* out2;  // checksum column [nb]
  void* fout;  // bag_sum [nb, d] in the table's type; dot_score f32 scores
};

// One row of any format into `slots` (all lanes of the warp call this).
__device__ __forceinline__ void decode_any(int fmt, const uint8_t* bytes,
                                           const uint8_t* meta, long long row,
                                           int S, int cnt, uint32_t* slots,
                                           int B, int lane) {
  if (fmt == kStreamVbyte) {
    svb::decode_row(meta + row * (B >> 2), bytes + row * S, S, cnt, slots, B,
                    lane);
  } else if (fmt == kBinpack) {
    binpack::decode_row(meta + row, bytes + row * S, S, cnt, slots, B, lane);
  } else {
    vbyte::decode_row(bytes + row * S, S, cnt, slots, B, lane);
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(vbyte::kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_sum_f(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(vbyte::kFull, x, off);
  return x;
}

// The table row of `id`, clamped to [0, V-1].
__device__ __forceinline__ const char* table_row(const FusedParams& p, int id) {
  const long long r = id < 0 ? 0 : (id >= p.V ? p.V - 1 : id);
  return static_cast<const char*>(p.table) + r * p.d * (p.table_bf16 ? 2 : 4);
}

// Chunk k of a table row as N floats (N = 8 bf16 or 4 f32 values, 16
// bytes); values past d read as 0. bf16 -> f32 is exact (a 16-bit shift).
template <int N>
__device__ __forceinline__ void load_chunk(const FusedParams& p,
                                           const char* row, int k,
                                           float v[N]) {
  const int c0 = k * N;
  if (p.table_vec16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + k);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (N == 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __uint_as_float(w[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = c0 + i;
      if (c >= p.d) {
        v[i] = 0.f;
      } else if constexpr (N == 8) {
        v[i] = __uint_as_float(
            static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(row)[c]) << 16);
      } else {
        v[i] = reinterpret_cast<const float*>(row)[c];
      }
    }
  }
}

// bag_sum: out[row, c] = sum over valid slots j (ascending) of
// table[clip(slot j), c], in f32, rounded once to the table's type.
template <int N>
__device__ __forceinline__ void bag_sum_row(const FusedParams& p,
                                            const uint32_t* slots, int cnt,
                                            long long row, int lane) {
  const int nk = (p.d + N - 1) / N;
  for (int k = lane; k < nk; k += 32) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      float v[N];
      load_chunk<N>(p, table_row(p, static_cast<int>(slots[j])), k, v);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += v[i];
    }
    const long long o = row * p.d + static_cast<long long>(k) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (k * N + i >= p.d) break;
      if constexpr (N == 8) {
        static_cast<__nv_bfloat16*>(p.fout)[o + i] = __float2bfloat16_rn(acc[i]);
      } else {
        static_cast<float*>(p.fout)[o + i] = acc[i];
      }
    }
  }
}

// Sum each of a lane's kQueryGroup partial dots over the warp: a
// transposing reduction (4 + 2 + 1 shuffles split the queries between lane
// halves, 2 more finish the sums), 9 shuffles where 8 butterflies take 40.
// Lane l ends with query ((l >> 4) & 1) * 4 + ((l >> 3) & 1) * 2 +
// ((l >> 2) & 1); the four lanes of a group hold the same sum.
__device__ __forceinline__ float reduce_queries(float a[kQueryGroup], int lane) {
  bool hi = lane & 16;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float send = hi ? a[t] : a[t + 4];
    const float keep = hi ? a[t + 4] : a[t];
    a[t] = keep + __shfl_xor_sync(vbyte::kFull, send, 16);
  }
  hi = lane & 8;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float send = hi ? a[t] : a[t + 2];
    const float keep = hi ? a[t + 2] : a[t];
    a[t] = keep + __shfl_xor_sync(vbyte::kFull, send, 8);
  }
  hi = lane & 4;
  float x = (hi ? a[1] : a[0]) +
            __shfl_xor_sync(vbyte::kFull, hi ? a[0] : a[1], 4);
  x += __shfl_xor_sync(vbyte::kFull, x, 2);
  x += __shfl_xor_sync(vbyte::kFull, x, 1);
  return x;
}

// dot_score: ids[row, j] = slot j (0 past the count); scores[row, j, q] =
// table[clip(id)] . query[q], an f32 sum rounded once to bf16 when
// round_bf16. Pad slots score row 0, as the reference's do. kSlots rows
// are loaded before any is used, so a warp keeps that many gathers in
// flight. The query matrix sits in shared memory chunk-major (for query
// q: [N/4][n_chunks][4] floats), so lane k's float4 reads of its chunk
// fall on consecutive banks.
constexpr int kSlots = 4;

template <int N>
__device__ __forceinline__ void dot_score_row(const FusedParams& p,
                                              const uint32_t* slots, int cnt,
                                              const float* q_s, long long row,
                                              int lane) {
  const int B = p.B;
  const int nq = p.nq;
  const int nk = (p.d + N - 1) / N;
  int* ids = p.out + row * B;
  float* sc = static_cast<float*>(p.fout) + row * B * nq;
  for (int j = lane; j < B; j += 32)
    ids[j] = j < cnt ? static_cast<int>(slots[j]) : 0;
  for (int j0 = 0; j0 < B; j0 += kSlots) {
    const char* r[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = j0 + s;
      r[s] = table_row(p, j < cnt ? static_cast<int>(slots[j]) : 0);
    }
    for (int q0 = 0; q0 < nq; q0 += kQueryGroup) {
      float acc[kSlots][kQueryGroup];
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int qi = 0; qi < kQueryGroup; ++qi) acc[s][qi] = 0.f;
      for (int k = lane; k < nk; k += 32) {
        float v[kSlots][N];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) load_chunk<N>(p, r[s], k, v[s]);
#pragma unroll
        for (int qi = 0; qi < kQueryGroup; ++qi) {
          if (q0 + qi >= nq) break;
          const float4* qr =
              reinterpret_cast<const float4*>(q_s + (q0 + qi) * nk * N);
          float qv[N];
#pragma unroll
          for (int h = 0; h < N / 4; ++h) {
            const float4 f = qr[h * nk + k];
            qv[4 * h] = f.x;
            qv[4 * h + 1] = f.y;
            qv[4 * h + 2] = f.z;
            qv[4 * h + 3] = f.w;
          }
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
#pragma unroll
            for (int i = 0; i < N; ++i)
              acc[s][qi] = fmaf(v[s][i], qv[i], acc[s][qi]);
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = j0 + s;
        if (j >= B) break;  // warp-uniform
        float* o = sc + static_cast<long long>(j) * nq + q0;
        if (nq == 1) {
          float x = warp_sum_f(acc[s][0]);
          if (p.round_bf16) x = __bfloat162float(__float2bfloat16_rn(x));
          if (lane == 0) o[0] = x;
        } else {
          float x = reduce_queries(acc[s], lane);
          if (p.round_bf16) x = __bfloat162float(__float2bfloat16_rn(x));
          const int q = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                        ((lane >> 2) & 1);
          if ((lane & 3) == 0 && q0 + q < nq) o[q] = x;
        }
      }
    }
  }
}

// Every epilogue but the broadcast ones (probe_kernel below).
template <int FMT, int EP>
__global__ void fused_decode_kernel(FusedParams p) {
  constexpr bool kWeighted = EP == kBm25WeightedRows;
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int B = p.B;
  uint32_t* slots = smem + warp * B;
  uint32_t* wslots = smem + (vbyte::kWarpsPerCta + warp) * B;
  float* query_s = reinterpret_cast<float*>(
      smem + (kWeighted ? 2 : 1) * vbyte::kWarpsPerCta * B);
  if constexpr (EP == kDotScore) {
    // chunk-major: element c = k*N + 4h + e of query q at
    // q*nk*N + (h*nk + k)*4 + e, zero past d (see dot_score_row)
    const int n = p.table_bf16 ? 8 : 4;
    const int nk = (p.d + n - 1) / n;
    for (int i = threadIdx.x; i < p.nq * nk * n; i += blockDim.x) {
      const int q = i / (nk * n);
      const int rem = i - q * nk * n;
      const int h = rem / (nk * 4);
      const int k = (rem - h * nk * 4) >> 2;
      const int c = k * n + h * 4 + (rem & 3);
      query_s[i] = c < p.d ? p.query[q * p.d + c] : 0.f;
    }
    __syncthreads();
  }
  const long long row =
      static_cast<long long>(blockIdx.x) * vbyte::kWarpsPerCta + warp;
  if (row >= p.nb) return;  // whole warp, after the CTA-wide barrier
  const int cnt = vbyte::clamp_count(p.counts[row], B);
  decode_any(FMT, p.bytes, p.meta, row, p.S, cnt, slots, B, lane);
  if (p.differential)
    vbyte::prefix_row(slots, B, cnt, static_cast<uint32_t>(p.bases[row]), lane);
  if (kWeighted)  // dense, non-differential, with the main row's count
    decode_any(p.w_format, p.w_bytes, p.w_meta, row, p.S_w, cnt, wslots, B,
               lane);
  const int impact = EP == kBm25AccumRows ? *p.impact : 1;

  if constexpr (EP == kBagSum) {
    if (p.table_bf16) {
      bag_sum_row<8>(p, slots, cnt, row, lane);
    } else {
      bag_sum_row<4>(p, slots, cnt, row, lane);
    }
  } else if constexpr (EP == kDotScore) {
    if (p.table_bf16) {
      dot_score_row<8>(p, slots, cnt, query_s, row, lane);
    } else {
      dot_score_row<4>(p, slots, cnt, query_s, row, lane);
    }
  } else if constexpr (EP == kAdjacencyRebase) {
    // differential only: the decoded id minus the edge's row base, mod 2^32
    int* o = p.out + row * B;
    const int* eb = p.edge_base + row * B;
    for (int j = lane; j < B; j += 32)
      o[j] = j < cnt ? static_cast<int>(slots[j] - static_cast<uint32_t>(eb[j]))
                     : 0;
  } else if constexpr (EP == kStream || EP == kChecksum) {
    int* o = p.out + row * B;
    uint32_t cs = 0u;
    for (int j = lane; j < B; j += 32) {
      o[j] = static_cast<int>(slots[j]);
      cs += slots[j] * static_cast<uint32_t>(2 * j + 1);  // mod 2^32
    }
    if (EP == kChecksum) {
      cs = warp_sum(cs);
      if (lane == 0) p.out2[row] = static_cast<int>(cs);
    }
  } else {  // *_rows: block `row` against its own probe
    const int pr = p.probe[row];
    uint32_t acc = 0u;
    for (int j = lane; j < cnt; j += 32) {
      if (static_cast<int>(slots[j]) == pr) acc += kWeighted ? wslots[j] : 1u;
    }
    if (kWeighted) {
      acc = warp_sum(acc);
    } else {
      acc = __any_sync(vbyte::kFull, acc != 0u) ? 1u : 0u;
    }
    if (lane == 0)
      p.out[row] = pr >= 0 ? static_cast<int>(acc) * impact : 0;
  }
}

// First index in [lo, hi) of the non-decreasing s whose value is >= v
// (kUpper: > v), as uint32.
template <bool kUpper>
__device__ __forceinline__ int search_u32(const uint32_t* s, int lo, int hi,
                                          uint32_t v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kUpper ? s[mid] <= v : s[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Probe v against a sorted row: the lower bound from `lo` (updated, so the
// next, larger probe starts there), then the run of slots equal to v.
template <bool kWeighted>
__device__ __forceinline__ uint32_t match_sorted(const uint32_t* slots,
                                                 const uint32_t* wslots,
                                                 int cnt, uint32_t v, int& lo) {
  lo = search_u32<false>(slots, lo, cnt, v);
  uint32_t acc = 0u;
  for (int j = lo; j < cnt && slots[j] == v; ++j) {
    if (!kWeighted) return 1u;
    acc += wslots[j];  // mod 2^32
  }
  return acc;
}

// Probe pi against any row: every valid slot, as the reference does.
// Masked slots (j >= cnt) never match, and only probes >= 0 count.
template <bool kWeighted>
__device__ __forceinline__ uint32_t match_all(const uint32_t* slots,
                                              const uint32_t* wslots, int cnt,
                                              int pi) {
  uint32_t acc = 0u;
  if (pi < 0) return acc;
  for (int j = 0; j < cnt; ++j) {
    if (static_cast<int>(slots[j]) == pi) {
      if (!kWeighted) return 1u;
      acc += wslots[j];
    }
  }
  return acc;
}

// Copy n bytes from global src to shared dst with threads t of T: 16- or
// 4-byte cp.async where both ends and n allow (dst is 16-byte aligned by
// construction), plain byte loads otherwise. Completes at
// cp.async.wait_all.
__device__ __forceinline__ void stage_async(uint8_t* dst, const uint8_t* src,
                                            int n, int t, int T) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (a % 16 == 0 && n % 16 == 0) {
    for (int i = 16 * t; i < n; i += 16 * T)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + i),
                   "l"(src + i));
  } else if (a % 4 == 0 && n % 4 == 0) {
    for (int i = 4 * t; i < n; i += 4 * T)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + i),
                   "l"(src + i));
  } else {
    for (int i = t; i < n; i += T) dst[i] = src[i];
  }
}

// Control or width bytes per row of a format's stream.
__host__ __device__ __forceinline__ int meta_bytes(int fmt, int B) {
  return fmt == kStreamVbyte ? B >> 2 : (fmt == kBinpack ? 1 : 0);
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// Staged bytes per row: main stream, its control or width, then the
// weight stream's, each rounded up to 16 bytes.
__host__ __device__ __forceinline__ int stage_row_bytes(const FusedParams& p,
                                                        int fmt,
                                                        bool weighted) {
  return round16(p.S) + round16(meta_bytes(fmt, p.B)) +
         (weighted ? round16(p.S_w) + round16(meta_bytes(p.w_format, p.B))
                   : 0);
}

// The broadcast epilogues: out[row, i] for every probe i (see the note at
// the top). `rows` rows per CTA of kWarpsPerCta warps, 1 or kWarpsPerCta,
// uniform across the grid; `vec4`: P % 4 == 0 and `out` 16-byte aligned;
// `stage`: the rows' bytes are copied to shared memory first (they fit).
template <int FMT, int EP>
__global__ void __launch_bounds__(vbyte::kWarpsPerCta * 32)
    probe_kernel(FusedParams p, int rows, int vec4, int stage) {
  constexpr bool kWeighted = EP == kBm25Weighted;
  // [staged bytes per row][probes P][slots rows x B][weights rows x B]
  extern __shared__ __align__(16) uint8_t probe_smem[];
  __shared__ int s_run;  // probes before the first negative one
  __shared__ int s_sorted[vbyte::kWarpsPerCta];  // per row of the CTA
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int B = p.B;
  const int P = p.P;
  const int W = vbyte::kWarpsPerCta / rows;  // warps per row
  const int r = warp / W;                    // this warp's row in the CTA
  const int sub = warp - r * W;              // and its place among them
  const int t = sub * 32 + lane;             // thread of the row, of T
  const int T = W * 32;
  const int row_bytes = stage ? stage_row_bytes(p, FMT, kWeighted) : 0;
  uint8_t* staged = probe_smem + r * row_bytes;
  int* probe_s = reinterpret_cast<int*>(probe_smem + rows * row_bytes);
  uint32_t* slots = reinterpret_cast<uint32_t*>(probe_s + P) + r * B;
  uint32_t* wslots = reinterpret_cast<uint32_t*>(probe_s + P) + (rows + r) * B;

  // every read from device memory issued at once: the probe set, the
  // row's count and base, its bytes and control or width, the weights'
  const long long row = static_cast<long long>(blockIdx.x) * rows + r;
  const bool live = row < p.nb;  // uniform over the row's warps
  const long long at_row = live ? row : 0;
  const int m = meta_bytes(FMT, B);
  const int mw = kWeighted ? meta_bytes(p.w_format, B) : 0;
  const uint8_t* bytes = p.bytes + at_row * p.S;
  const uint8_t* meta = m ? p.meta + at_row * m : p.meta;
  const uint8_t* w_bytes = kWeighted ? p.w_bytes + at_row * p.S_w : nullptr;
  const uint8_t* w_meta = mw ? p.w_meta + at_row * mw : p.w_meta;
  if (threadIdx.x == 0) s_run = P;
  stage_async(reinterpret_cast<uint8_t*>(probe_s),
              reinterpret_cast<const uint8_t*>(p.probe), 4 * P, threadIdx.x,
              blockDim.x);
  if (live && stage) {
    uint8_t* at = staged;
    stage_async(at, bytes, p.S, t, T);
    bytes = at;
    at += round16(p.S);
    if (m) {
      stage_async(at, meta, m, t, T);
      meta = at;
      at += round16(m);
    }
    if (kWeighted) {
      stage_async(at, w_bytes, p.S_w, t, T);
      w_bytes = at;
      at += round16(p.S_w);
      if (mw) {
        stage_async(at, w_meta, mw, t, T);
        w_meta = at;
      }
    }
  }
  const int cnt = live ? vbyte::clamp_count(p.counts[row], B) : 0;
  const uint32_t base =
      live && p.differential ? static_cast<uint32_t>(p.bases[row]) : 0u;
  const uint32_t scale =
      EP == kBm25Accum ? static_cast<uint32_t>(*p.impact) : 1u;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the probe set: a non-decreasing run of values >= 0 followed only by
  // negative ones? (s_run then marks where the run ends)
  int ok = 1;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int cur = probe_s[i];
    const int prev = i ? probe_s[i - 1] : 0;
    if (cur >= 0) {
      ok &= prev >= 0 && prev <= cur;
    } else if (prev >= 0) {
      s_run = i;  // one writer when the set is sorted
    }
  }
  if (live && sub == 0) {
    decode_any(FMT, bytes, meta, 0, p.S, cnt, slots, B, lane);
    if (p.differential) vbyte::prefix_row(slots, B, cnt, base, lane);
    bool up = true;  // the valid slots non-decreasing as uint32
    for (int j = lane + 1; j < cnt; j += 32) up &= slots[j - 1] <= slots[j];
    up = __all_sync(vbyte::kFull, up);
    if (lane == 0) s_sorted[r] = up;
  }
  // dense, non-differential, with the main row's count; beside the main
  // stream when the row has a second warp
  if (kWeighted && live && sub == (W > 1 ? 1 : 0))
    decode_any(p.w_format, w_bytes, w_meta, 0, p.S_w, cnt, wslots, B, lane);
  const bool probes_sorted = __syncthreads_and(ok);
  if (!live) return;

  int* o = p.out + row * P;
  if (probes_sorted && s_sorted[r]) {
    // only probes in [a, b) lie inside [slots[0], slots[cnt - 1]]; a row
    // whose first value is >= 2^31 has none (probes are < 2^31)
    const uint32_t* pu = reinterpret_cast<const uint32_t*>(probe_s);
    int a = 0, b = 0;
    if (cnt > 0) {
      a = search_u32<false>(pu, 0, s_run, slots[0]);
      b = search_u32<true>(pu, a, s_run, slots[cnt - 1]);
    }
    if (vec4) {
      for (int q = t; q < (P >> 2); q += T) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        const int i0 = q << 2;
        if (i0 + 3 >= a && i0 < b) {
          int lo = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + e;
            if (i >= a && i < b)
              v[e] = match_sorted<kWeighted>(slots, wslots, cnt, pu[i], lo) *
                     scale;
          }
        }
        reinterpret_cast<int4*>(o)[q] =
            make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]),
                      static_cast<int>(v[2]), static_cast<int>(v[3]));
      }
    } else {
      for (int i = t; i < P; i += T) {
        int lo = 0;
        o[i] = i >= a && i < b
                   ? static_cast<int>(match_sorted<kWeighted>(
                                          slots, wslots, cnt, pu[i], lo) *
                                      scale)
                   : 0;
      }
    }
  } else {
    for (int i = t; i < P; i += T)
      o[i] = static_cast<int>(
          match_all<kWeighted>(slots, wslots, cnt, probe_s[i]) * scale);
  }
}

template <int FMT, int EP>
int launch_probe(const FusedParams& p, cudaStream_t stream) {
  constexpr bool kWeighted = EP == kBm25Weighted;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one CTA per row while every row has an SM of its own; one warp per
  // row beyond
  const int rows = p.nb <= n_sm ? 1 : vbyte::kWarpsPerCta;
  const dim3 grid(static_cast<unsigned>((p.nb + rows - 1) / rows));
  const dim3 block(vbyte::kWarpsPerCta * 32);
  const size_t work = sizeof(uint32_t) * (p.P + (kWeighted ? 2 : 1) * rows * p.B);
  // the rows' bytes go to shared memory too while they fit beside it
  const size_t staged =
      static_cast<size_t>(rows) * stage_row_bytes(p, FMT, kWeighted);
  const int stage = work + staged <= kMaxProbeSmem;
  const size_t smem = work + (stage ? staged : 0);
  if (smem > (48u << 10)) {
    e = cudaFuncSetAttribute(probe_kernel<FMT, EP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec4 =
      p.P % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  probe_kernel<FMT, EP><<<grid, block, smem, stream>>>(p, rows, vec4, stage);
  return static_cast<int>(cudaGetLastError());
}

// floats per query row in shared memory: d rounded up to whole chunks
inline int query_width(const FusedParams& p) {
  const int n = p.table_bf16 ? 8 : 4;
  return (p.d + n - 1) / n * n;
}

template <int FMT, int EP>
int launch(const FusedParams& p, cudaStream_t stream) {
  if constexpr (EP == kMembership || EP == kBm25Accum ||
                EP == kBm25Weighted) {
    return launch_probe<FMT, EP>(p, stream);
  } else {
    constexpr bool kWeighted = EP == kBm25WeightedRows;
    const dim3 grid(static_cast<unsigned>((p.nb + vbyte::kWarpsPerCta - 1) /
                                          vbyte::kWarpsPerCta));
    const dim3 block(vbyte::kWarpsPerCta * 32);
    const size_t smem =
        sizeof(uint32_t) * (kWeighted ? 2 : 1) * vbyte::kWarpsPerCta * p.B +
        (EP == kDotScore ? sizeof(float) * p.nq * query_width(p) : 0);
    fused_decode_kernel<FMT, EP><<<grid, block, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int FMT>
int launch_epilogue(int epilogue, const FusedParams& p, cudaStream_t s) {
  switch (epilogue) {
    case kStream: return launch<FMT, kStream>(p, s);
    case kChecksum: return launch<FMT, kChecksum>(p, s);
    case kMembership: return launch<FMT, kMembership>(p, s);
    case kMembershipRows: return launch<FMT, kMembershipRows>(p, s);
    case kBm25Accum: return launch<FMT, kBm25Accum>(p, s);
    case kBm25AccumRows: return launch<FMT, kBm25AccumRows>(p, s);
    case kBm25Weighted: return launch<FMT, kBm25Weighted>(p, s);
    case kBm25WeightedRows: return launch<FMT, kBm25WeightedRows>(p, s);
    case kBagSum: return launch<FMT, kBagSum>(p, s);
    case kDotScore: return launch<FMT, kDotScore>(p, s);
    case kAdjacencyRebase: return launch<FMT, kAdjacencyRebase>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_decode_launch(int format, int epilogue, const void* bytes,
                                   const void* meta, int S, const void* counts,
                                   const void* bases, long long nb, int B,
                                   int differential, const void* probe, int P,
                                   const void* impact, int w_format,
                                   const void* w_bytes, const void* w_meta,
                                   int S_w, const void* table, long long V,
                                   int d, int table_bf16, const void* query,
                                   int nq, int round_bf16,
                                   const void* edge_base, void* out,
                                   void* out2, void* fout, void* stream) {
  if (nb <= 0) return 0;
  const int vec16 =
      table != nullptr && (d * (table_bf16 ? 2 : 4)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(table) % 16 == 0;
  FusedParams p{static_cast<const uint8_t*>(bytes),
                static_cast<const uint8_t*>(meta),
                static_cast<const int*>(counts),
                static_cast<const int*>(bases),
                nb, S, B, differential,
                static_cast<const int*>(probe), P,
                static_cast<const int*>(impact),
                w_format,
                static_cast<const uint8_t*>(w_bytes),
                static_cast<const uint8_t*>(w_meta), S_w,
                table, V, d, table_bf16, vec16,
                static_cast<const float*>(query), nq, round_bf16,
                static_cast<const int*>(edge_base),
                static_cast<int*>(out), static_cast<int*>(out2), fout};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (format) {
    case kVbyte: return launch_epilogue<kVbyte>(epilogue, p, s);
    case kStreamVbyte: return launch_epilogue<kStreamVbyte>(epilogue, p, s);
    case kBinpack: return launch_epilogue<kBinpack>(epilogue, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
