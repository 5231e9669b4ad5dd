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
// What the design does about it: the decode cores that kernels 1, 3 and 4
// run (vbyte_core.cuh, svb_core.cuh, binpack_core.cuh), then the optional
// scan, then an epilogue — the reference's core-plus-epilogue shape, with
// the main stream's format and the epilogue as template parameters (3 x 11
// instantiations). The weighted epilogues' impact stream may have another
// format than the main stream, as in the reference's API; it is decoded
// dense, non-differential, with the main row's count, through a branch on
// a run-time format argument that is uniform across the grid. The decoded
// row and the impact row stay in shared memory.
//
// The row-aligned epilogues (stream, checksum, the *_rows forms, bag_sum,
// adjacency_rebase: one block in, one row or one value out) run
// fused_decode_kernel, the staged shape of kernels 1, 3 and 4. What held
// its first version back on the search path's launches of 1-512 gathered
// blocks was the chain of dependent reads a block took (count, then the
// bytes 32 at a time or a control byte and then single data bytes, then
// the weight stream after the main one, then the edge_base row), one
// device-memory round trip each. Now a warp per block, four warps per CTA,
// as many CTAs as stay resident, each warp walking its blocks grid-stride;
// every read of a block is issued at once by cp.async into the warp's
// shared memory — count, base and probe (one 4-byte copy each), the bytes
// (with a zero tail), the control row, the weight stream's bytes and
// control row, the edge_base row; 16-byte pieces where the stride and base
// allow, 4-byte or byte copies otherwise; the binpack widths, single bytes,
// as register loads beside them — and the next block's reads are in
// flight while the current one is decoded from shared memory by the
// staged cores, scanned in one warp scan (vbyte::scan_row) and written in
// 16-byte stores. bm25_weighted_rows at launches of at most one block per
// SM takes a CTA of two warps a block instead, the weights decoded on the
// second beside the main stream. Rows wider than kMaxStagedStride, or
// whose parts do not fit a CTA's shared memory, are read in place by the
// cores that read device memory. probe_kernel and dot_kernel stage a
// block's bytes too but decode the staged copy with the in-place cores
// (decode_any, vbyte::prefix_row): the staged cores measured slower there
// at the search and two_tower paths' shapes (PERF.md §6).
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
// bag_sum reads the table (f32 or bf16, a uniform run-time branch) in
// 16-byte chunks: lane l owns chunk l of a row (8 bf16 or 4 f32 values),
// so one d = 256 bf16 row is one coalesced 512-byte load by the warp, and
// accumulates each column in f32 over the block's valid slots in ascending
// order. Ids are clamped to [0, V-1] (the reference's mode="clip"). Each
// sum is rounded once, to the table's type for bag_sum and to bf16 for
// dot_score when both operands are bf16, as the reference's bf16 sum and
// einsum are.
//
// dot_score runs its own kernel (dot_kernel). What bounds it is the
// gathered rows: one d-wide table row per slot (pad slots read row 0), 512
// bytes at the retrieval path's bf16 d = 256, so its 2^20 slots move 512
// MiB, 0.16 ms at 3.35 TB/s, though scattered 512-byte rows do not stream
// at that rate (index_select of the same rows, which reads and writes
// them, moves ~1.7 TB/s: chip_smoke.py's parity_dot_score_path). A warp
// that loads a few rows, computes and loads again waits one round trip
// per step, so a CTA of 4 warps serves one block: the block's bytes and the query are copied to shared memory
// at once (cp.async), warp 0 decodes the block while the others lay out
// the query, then each warp takes every 4th tile of 16 slots and streams
// the tiles' rows through a ring of kDotStages stages of its own (cp.async
// 16 bytes a lane where the rows allow, so one warp instruction moves one
// 512-byte row; 4-byte copies or plain 2-byte loads otherwise; pad rows
// through L1), issuing the next stages' copies before it computes on the
// current one. At B = 128 each warp has both of its tiles in flight: 16 KB
// a warp, 64 KB a CTA, and three CTAs of ~72 KB of shared memory fit an SM,
// so an SM keeps up to ~190 KB of rows in flight where Little's law asks
// ~25 KB (3.35 TB/s x ~1 us over 132 SMs). Rows wider than 512 bytes are
// staged in chunks of at most 512 bytes (columns past d zero-filled); a
// sum over several chunks is carried in the f32 output and rounded after
// the last. Each staged row is padded by 16 bytes, so the 8 rows one
// ldmatrix reads fall on different banks.
//
// The products run on the tensor cores (mma.sync, f32 accumulation), for
// every pair of types. A is 16 staged rows x 32 bytes (ldmatrix.x4 from
// the ring), B the query's slice for 8 query rows, C 16 slots x 8 query
// rows in f32, stored as [j, q] straight from the fragment; query rows
// past nq and columns past d are zero. bf16 table and bf16 query
// (round_bf16, the path's case): one m16n8k16 bf16 mma a k-step, the
// sums rounded once to bf16; where one n-tile and one chunk cover the
// query (nq <= 8, d <= 256) its B fragments (16 k-steps x 2 registers a
// lane at d = 256) stay in registers for the whole CTA. bf16 table, f32
// query: the query split in three bf16 parts, three mma, every product
// exact in f32. f32 table: rows and query split in hi + lo tf32 parts,
// three m16n8k8 mma (hi*hi + hi*lo + lo*hi), each product to ~2^-21
// relative, inside the f32 sums' rounding bound the scores are held to;
// one TF32 mma alone would not be, and scalar f32 FMAs on the CUDA cores
// held the f32 table at 1.4-1.7x the bf16 table's time at 12 warps an SM.
// At nq <= 8 the product does ~8 flop a byte, far below the ~295 where the
// tensor cores would bind, so mma.sync suffices (no wgmma).

#include <cuda_bf16.h>

#include <algorithm>

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

constexpr int kDotTile = 16;    // dot_score slots per tile (mma's m16)
constexpr int kDotStages = 2;   // dot_score ring stages per warp
constexpr int kDotChunk = 512;  // dot_score staged bytes per row and stage
constexpr int kDotCtasPerSm = 3;  // dot_score: registers for 3 CTAs an SM
constexpr int kDotMaxStaged = 8192;  // dot_score: a block's bytes to stage
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

// One row of any format from its staged copy (the staged cores: `bytes`
// 16-byte aligned with a zero tail, `meta` the staged control row; `w` the
// binpack width), into `slots`.
__device__ __forceinline__ void decode_staged(int fmt, const uint8_t* bytes,
                                              const uint8_t* meta, int w,
                                              int S, int cnt, uint32_t* slots,
                                              int B, int lane) {
  if (fmt == kStreamVbyte) {
    svb::decode_staged_row(meta, bytes, S, cnt, slots, B, lane);
  } else if (fmt == kBinpack) {
    binpack::decode_staged_row(bytes, S, w, cnt, slots, B, lane);
  } else {
    vbyte::decode_staged_row(bytes, S, cnt, slots, B, lane);
  }
}

// Control or width bytes per row of a format's stream.
__host__ __device__ __forceinline__ int meta_bytes(int fmt, int B) {
  return fmt == kStreamVbyte ? B >> 2 : (fmt == kBinpack ? 1 : 0);
}

// Zero bytes [S, stage_bytes(S)) of a staged row: the tail the staged
// binpack and Stream-VByte cores read past the row end.
__device__ __forceinline__ void zero_tail(uint8_t* row, int S, int t, int T) {
  for (int i = S + t; i < vbyte::stage_bytes(S); i += T) row[i] = 0;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
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

// The row-aligned kernel's shared-memory plan, computed on the host. A
// warp's region: its slots, the weights' slots (bm25_weighted_rows), then
// two staged rows (none when rows are read in place). A staged row: 16
// bytes of count, base and probe, the row's bytes with their zero tail,
// its control row (streamvbyte), the weight stream's bytes with their
// tail and control row (bm25_weighted_rows), its edge_base row
// (adjacency_rebase).
struct RowLayout {
  int region;    // bytes per warp
  int off_w;     // the weights' slots
  int off_rows;  // the first staged row
  int row;       // bytes per staged row
  int staged;    // rows are staged (else read in place)
  int at_meta, at_wbytes, at_wmeta, at_eb;  // offsets in a staged row
  int g_bytes, g_meta, g_wbytes, g_wmeta, g_eb;  // stage_gran of each
  int split;  // bm25_weighted_rows: a CTA per row, the weights on warp 1
};

constexpr int kRowBytesAt = 16;  // a staged row's bytes, after its header
constexpr size_t kMaxRowSmem = 227u << 10;  // a CTA's shared memory

template <int EP>
struct RowEp {
  static constexpr bool kWeighted = EP == kBm25WeightedRows;
  static constexpr bool kProbe =
      EP == kMembershipRows || EP == kBm25AccumRows || kWeighted;
  static constexpr bool kRebase = EP == kAdjacencyRebase;
};

// Issue the reads of row r's main stream into staged row `at` (all lanes of
// a warp): count, base and probe (lanes 0-2, one 4-byte cp.async each),
// the bytes, the control row, the edge_base row. Returns the binpack width
// (a register load: cp.async moves 4 bytes at least).
template <int FMT, int EP>
__device__ __forceinline__ int issue_main(const FusedParams& p,
                                          const RowLayout& L, long long r,
                                          uint8_t* at, int lane) {
  const int B = p.B;
  if (lane == 0) vbyte::stage_word(at, p.counts + r);
  if (lane == 1) vbyte::stage_word(at + 4, p.bases + r);
  if (RowEp<EP>::kProbe && lane == 2) vbyte::stage_word(at + 8, p.probe + r);
  vbyte::stage_any(at + kRowBytesAt, p.bytes + r * p.S, p.S, L.g_bytes, lane);
  if constexpr (FMT == kStreamVbyte)
    vbyte::stage_any(at + L.at_meta, p.meta + r * (B >> 2), B >> 2, L.g_meta,
                     lane);
  if constexpr (RowEp<EP>::kRebase)
    vbyte::stage_any(at + L.at_eb,
                     reinterpret_cast<const uint8_t*>(p.edge_base + r * B),
                     4 * B, L.g_eb, lane);
  return FMT == kBinpack ? static_cast<int>(p.meta[r]) : 0;
}

// The weight stream's reads of row r (bm25_weighted_rows); returns its
// binpack width.
__device__ __forceinline__ int issue_weights(const FusedParams& p,
                                             const RowLayout& L, long long r,
                                             uint8_t* at, int lane) {
  const int mw = meta_bytes(p.w_format, p.B);
  vbyte::stage_any(at + L.at_wbytes, p.w_bytes + r * p.S_w, p.S_w, L.g_wbytes,
                   lane);
  if (p.w_format == kStreamVbyte)
    vbyte::stage_any(at + L.at_wmeta, p.w_meta + r * mw, mw, L.g_wmeta, lane);
  return p.w_format == kBinpack ? static_cast<int>(p.w_meta[r]) : 0;
}

// The epilogue of one decoded row (all lanes of the warp): `slots` holds
// the row (scanned where differential), `wslots` the weights, `pr` the
// row's probe, `eb` its edge_base row (shared or device memory).
template <int EP>
__device__ __forceinline__ void row_epilogue(const FusedParams& p,
                                             long long row, int cnt, int pr,
                                             uint32_t impact, const int* eb,
                                             const uint32_t* slots,
                                             const uint32_t* wslots,
                                             int lane) {
  const int B = p.B;
  if constexpr (EP == kBagSum) {
    if (p.table_bf16) {
      bag_sum_row<8>(p, slots, cnt, row, lane);
    } else {
      bag_sum_row<4>(p, slots, cnt, row, lane);
    }
  } else if constexpr (EP == kAdjacencyRebase) {
    // differential only: the decoded id minus the edge's row base, mod
    // 2^32, 0 past the count; 16-byte stores where B % 4 == 0
    int* o = p.out + row * B;
    if ((B & 3) == 0 && (reinterpret_cast<uintptr_t>(eb) & 15) == 0) {
      for (int q = lane; q < (B >> 2); q += 32) {
        const uint4 s = reinterpret_cast<const uint4*>(slots)[q];
        const int4 e = reinterpret_cast<const int4*>(eb)[q];
        const int j = q << 2;
        reinterpret_cast<uint4*>(o)[q] = make_uint4(
            j < cnt ? s.x - static_cast<uint32_t>(e.x) : 0u,
            j + 1 < cnt ? s.y - static_cast<uint32_t>(e.y) : 0u,
            j + 2 < cnt ? s.z - static_cast<uint32_t>(e.z) : 0u,
            j + 3 < cnt ? s.w - static_cast<uint32_t>(e.w) : 0u);
      }
    } else {
      for (int j = lane; j < B; j += 32)
        o[j] = j < cnt ? static_cast<int>(slots[j] -
                                          static_cast<uint32_t>(eb[j]))
                       : 0;
    }
  } else if constexpr (EP == kStream || EP == kChecksum) {
    vbyte::store_row(slots, p.out + row * B, B, lane);
    if constexpr (EP == kChecksum) {
      uint32_t cs = 0u;
      for (int j = lane; j < B; j += 32)
        cs += slots[j] * static_cast<uint32_t>(2 * j + 1);  // mod 2^32
      cs = warp_sum(cs);
      if (lane == 0) p.out2[row] = static_cast<int>(cs);
    }
  } else {  // *_rows: block `row` against its own probe
    constexpr bool kWeighted = EP == kBm25WeightedRows;
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
      p.out[row] = pr >= 0 ? static_cast<int>(acc * impact) : 0;
  }
}

// Every epilogue but the broadcast ones (probe_kernel) and dot_score
// (dot_kernel): stream, checksum, the *_rows forms, bag_sum and
// adjacency_rebase. A warp walks its rows grid-stride with the next row's
// reads in flight (see the note at the top); bm25_weighted_rows with
// L.split takes a CTA of two warps per row instead. STAGED: the rows are
// staged (else read in place); one decode path per instantiation keeps
// each kernel's code to what it runs.
template <int FMT, int EP, bool STAGED>
__global__ void __launch_bounds__(vbyte::kWarpsPerCta * 32)
    fused_decode_kernel(FusedParams p, RowLayout L) {
  constexpr bool kWeighted = RowEp<EP>::kWeighted;
  extern __shared__ __align__(16) uint8_t row_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int B = p.B;
  const int wf = p.w_format;
  const uint32_t impact =
      EP == kBm25AccumRows ? static_cast<uint32_t>(*p.impact) : 1u;

  if constexpr (kWeighted && STAGED) {
    if (L.split) {  // one row; warp 0 the main stream, warp 1 the weights
      const long long row = blockIdx.x;
      uint32_t* slots = reinterpret_cast<uint32_t*>(row_smem);
      uint32_t* wslots = reinterpret_cast<uint32_t*>(row_smem + L.off_w);
      uint8_t* at = row_smem + L.off_rows;
      const int* hdr = reinterpret_cast<const int*>(at);
      int w = 0;
      if (warp == 0) {
        zero_tail(at + kRowBytesAt, p.S, lane, 32);
        w = issue_main<FMT, EP>(p, L, row, at, lane);
      } else {
        zero_tail(at + L.at_wbytes, p.S_w, lane, 32);
        if (lane == 0) vbyte::stage_word(at + 12, p.counts + row);
        w = issue_weights(p, L, row, at, lane);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      if (warp == 0) {
        const int cnt = vbyte::clamp_count(hdr[0], B);
        decode_staged(FMT, at + kRowBytesAt, at + L.at_meta, w, p.S, cnt,
                      slots, B, lane);
        if (p.differential)
          vbyte::scan_row(slots, B, cnt, static_cast<uint32_t>(hdr[1]), lane);
      } else {  // dense, non-differential, with the main row's count
        decode_staged(wf, at + L.at_wbytes, at + L.at_wmeta, w, p.S_w,
                      vbyte::clamp_count(hdr[3], B), wslots, B, lane);
      }
      __syncthreads();
      if (warp == 0)
        row_epilogue<EP>(p, row, vbyte::clamp_count(hdr[0], B), hdr[2], 1u,
                         nullptr, slots, wslots, lane);
      return;
    }
  }

  const long long step =
      static_cast<long long>(gridDim.x) * vbyte::kWarpsPerCta;
  long long row =
      static_cast<long long>(blockIdx.x) * vbyte::kWarpsPerCta + warp;
  if (row >= p.nb) return;  // whole warp: the ragged edge of the grid
  uint8_t* region = row_smem + warp * L.region;
  uint32_t* slots = reinterpret_cast<uint32_t*>(region);
  uint32_t* wslots = reinterpret_cast<uint32_t*>(region + L.off_w);
  uint8_t* staged = region + L.off_rows;
  int cur = 0;
  int w = 0, ww = 0;  // binpack widths of the row in hand
  if constexpr (STAGED) {
    for (int b = 0; b < 2; ++b) {
      zero_tail(staged + b * L.row + kRowBytesAt, p.S, lane, 32);
      if (kWeighted)
        zero_tail(staged + b * L.row + L.at_wbytes, p.S_w, lane, 32);
    }
    w = issue_main<FMT, EP>(p, L, row, staged, lane);
    if (kWeighted) ww = issue_weights(p, L, row, staged, lane);
    vbyte::stage_commit();
  }
  for (;;) {
    // the next row's reads, in flight while this one is decoded
    const long long nxt = row + step;
    int cnt, pr = 0;
    const int* eb = nullptr;
    if constexpr (STAGED) {
      int w_n = 0, ww_n = 0;
      uint8_t* at_n = staged + (cur ^ 1) * L.row;
      if (nxt < p.nb) {
        w_n = issue_main<FMT, EP>(p, L, nxt, at_n, lane);
        if (kWeighted) ww_n = issue_weights(p, L, nxt, at_n, lane);
      }
      vbyte::stage_commit();
      vbyte::stage_wait_one();
      __syncwarp();
      const uint8_t* at = staged + cur * L.row;
      const int* hdr = reinterpret_cast<const int*>(at);
      cnt = vbyte::clamp_count(hdr[0], B);
      decode_staged(FMT, at + kRowBytesAt, at + L.at_meta, w, p.S, cnt, slots,
                    B, lane);
      if (p.differential)
        vbyte::scan_row(slots, B, cnt, static_cast<uint32_t>(hdr[1]), lane);
      if (kWeighted)  // dense, non-differential, with the main row's count
        decode_staged(wf, at + L.at_wbytes, at + L.at_wmeta, ww, p.S_w, cnt,
                      wslots, B, lane);
      if (RowEp<EP>::kProbe) pr = hdr[2];
      if (RowEp<EP>::kRebase) eb = reinterpret_cast<const int*>(at + L.at_eb);
      w = w_n;
      ww = ww_n;
    } else {  // in place, through the cores that read device memory
      cnt = vbyte::clamp_count(p.counts[row], B);
      decode_any(FMT, p.bytes, p.meta, row, p.S, cnt, slots, B, lane);
      if (p.differential)
        vbyte::scan_row(slots, B, cnt, static_cast<uint32_t>(p.bases[row]),
                        lane);
      if (kWeighted)
        decode_any(wf, p.w_bytes, p.w_meta, row, p.S_w, cnt, wslots, B, lane);
      if (RowEp<EP>::kProbe) pr = p.probe[row];
      if (RowEp<EP>::kRebase) eb = p.edge_base + row * B;
    }
    row_epilogue<EP>(p, row, cnt, pr, impact, eb, slots, wslots, lane);
    __syncwarp();
    if (nxt >= p.nb) break;
    row = nxt;
    cur ^= 1;
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

// Staged bytes per row: main stream, its control or width, then the
// weight stream's, each rounded up to 16 bytes.
__host__ __device__ __forceinline__ int stage_row_bytes(const FusedParams& p,
                                                        int fmt,
                                                        bool weighted) {
  return vbyte::round16(p.S) + vbyte::round16(meta_bytes(fmt, p.B)) +
         (weighted ? vbyte::round16(p.S_w) +
                         vbyte::round16(meta_bytes(p.w_format, p.B))
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
    at += vbyte::round16(p.S);
    if (m) {
      stage_async(at, meta, m, t, T);
      meta = at;
      at += vbyte::round16(m);
    }
    if (kWeighted) {
      stage_async(at, w_bytes, p.S_w, t, T);
      w_bytes = at;
      at += vbyte::round16(p.S_w);
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

// dot_score's shared-memory plan, computed on the host (see the note at the
// top). A staged row is `cb` bytes of a table row (a multiple of 32: whole
// mma k-steps, and two 16-byte-aligned halves) plus 16 bytes of padding.
struct DotLayout {
  int cb;         // staged bytes per row and stage, <= kDotChunk
  int nchunk;     // stages per tile: the row's bytes over cb, rounded up
  int ksteps;     // mma k-steps (16 bf16 columns) per chunk: cb / 32
  int qw;         // query columns: nchunk * cb / element, zero past d
  int qs;         // query row stride in shared memory, elements: qw + 8
  int ntiles;     // mma n-tiles (8 query rows each)
  int copy;       // bytes per copy: 16 or 4 (cp.async), 2 (plain loads)
  int stage;      // the block's compressed bytes are staged in shared memory
  int off_bytes;  // byte offsets in shared memory
  int off_query;
  int off_ring;
};

// dot_score's product (see dot_mma_tile); kDotBf16Hold holds the query's
// fragments in registers for the whole CTA (one n-tile, one chunk)
enum DotMode : int {
  kDotBf16Hold = 0,
  kDotBf16 = 1,
  kDotBf16x3 = 2,
  kDotTf32x3 = 3,
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// Stage chunk `chunk` of the table rows of tile `tile`'s 16 slots into
// `dst` (rows cb + 16 bytes apart). Slots past the count read row 0 (as the
// pad slots score it) through L1, where every pad slot of the SM finds it,
// since every CTA asking the same L2 line at once would queue on it; the
// other rows stream past L1. Slots past B and bytes past the row end read
// 0. The cp.async copies complete at the warp's next cp.async.wait_group.
__device__ __forceinline__ void dot_stage(const FusedParams& p,
                                          const DotLayout& L,
                                          const uint32_t* slots, int cnt,
                                          int tile, int chunk, uint8_t* dst,
                                          int lane) {
  const int rs = L.cb + 16;
  const long long row_bytes =
      static_cast<long long>(p.d) * (p.table_bf16 ? 2 : 4);
  const long long off0 = static_cast<long long>(chunk) * L.cb;
  const char* base = static_cast<const char*>(p.table);
#pragma unroll 4
  for (int r = 0; r < kDotTile; ++r) {
    const int j = tile * kDotTile + r;
    const char* src =
        j < p.B ? table_row(p, j < cnt ? static_cast<int>(slots[j]) : 0)
                : nullptr;
    uint8_t* drow = dst + r * rs;
    if (L.copy == 16 && j < cnt) {
      for (int i = 16 * lane; i < L.cb; i += 16 * 32) {
        const long long o = off0 + i;
        const int n = o < row_bytes ? 16 : 0;  // row_bytes % 16 == 0
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(drow + i)),
                     "l"(n ? src + o : base), "r"(n));
      }
    } else if (L.copy == 16) {
      for (int i = 16 * lane; i < L.cb; i += 16 * 32) {
        const long long o = off0 + i;
        const int n = src && o < row_bytes ? 16 : 0;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(drow + i)),
                     "l"(n ? src + o : base), "r"(n));
      }
    } else if (L.copy == 4) {
      for (int i = 4 * lane; i < L.cb; i += 4 * 32) {
        const long long o = off0 + i;
        const int n = src && o < row_bytes ? 4 : 0;  // row_bytes % 4 == 0
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_addr(drow + i)),
                     "l"(n ? src + o : base), "r"(n));
      }
    } else {  // a bf16 table at an odd element offset, or an odd d
      for (int i = 2 * lane; i < L.cb; i += 2 * 32) {
        const long long o = off0 + i;
        *reinterpret_cast<uint16_t*>(drow + i) =
            src && o < row_bytes
                ? __ldg(reinterpret_cast<const unsigned short*>(src + o))
                : static_cast<uint16_t>(0);
      }
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + mid + lo in bf16, exact to ~2^-24 relative: each part is the
// rounding of what the parts before it left (an exact f32 difference)
__device__ __forceinline__ void split_bf16(float x, float (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    part[i] = __bfloat162float(__float2bfloat16_rn(x));
    x -= part[i];
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The query's B fragment for n-tile nt and k-step ks (32 staged bytes:
// 16 bf16 or 8 f32 columns from `col`) of lane (g, t) = (lane / 4,
// lane % 4), from the query rows in shared memory (`qsm`, rows L.qs
// elements apart, zero past d; rows past nq read as zero). NP = 1 (bf16
// query): columns 2t, 2t + 1 and 8 + 2t, 8 + 2t + 1 of query row nt*8 + g,
// two bf16 pairs read as two words from bf16 rows. NP = 3 (f32 query, bf16
// table): the same columns' hi, mid and lo bf16 parts. tf32 (f32 table):
// columns t and t + 4, as hi and lo tf32 parts.
template <int MODE, int NP>
__device__ __forceinline__ void query_frag(const DotLayout& L,
                                           const void* qsm, int nq, int nt,
                                           int col, int lane,
                                           uint32_t (&b)[NP][2]) {
  const int n = nt * 8 + (lane >> 2);
  const int t = lane & 3;
  const bool on = n < nq;
  if constexpr (NP == 1) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(
        static_cast<const __nv_bfloat16*>(qsm) + n * L.qs + col);
    b[0][0] = on ? r[t] : 0u;
    b[0][1] = on ? r[t + 4] : 0u;
    return;
  }
  const float* r = static_cast<const float*>(qsm) + n * L.qs + col;
  if constexpr (MODE == kDotTf32x3) {
    const float x[2] = {on ? r[t] : 0.f, on ? r[t + 4] : 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b[0][e] = to_tf32(x[e]);
      b[1][e] = to_tf32(x[e] - __uint_as_float(b[0][e]));
    }
  } else {
    const int k = 2 * t;
    const float x[4] = {on ? r[k] : 0.f, on ? r[k + 1] : 0.f,
                        on ? r[k + 8] : 0.f, on ? r[k + 9] : 0.f};
    float part[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16(x[e], part[e]);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      b[i][0] = pack_bf16(part[0][i], part[1][i]);
      b[i][1] = pack_bf16(part[2][i], part[3][i]);
    }
  }
}

// scores[row, j, q] for one staged tile and chunk, on the tensor cores:
// per n-tile, a C fragment (16 slots x 8 queries) over the chunk's k-steps,
// started from the earlier chunks' sum; rounded to bf16 after the last
// chunk in the bf16 x bf16 modes.
//   kDotBf16Hold / kDotBf16: bf16 table, bf16 query, one mma per k-step.
//   kDotBf16x3: bf16 table, f32 query split in 3 bf16 parts: 3 mma, every
//     product exact in f32, so the sum is as an f32 sum is.
//   kDotTf32x3: f32 table (either query): rows and query split in hi + lo
//     tf32 parts, hi*hi + hi*lo + lo*hi in 3 mma (m16n8k8): each product to
//     ~2^-21 relative, inside the f32 sums' rounding bound; one TF32 mma
//     alone (2^-11) would not be.
template <int MODE>
__device__ __forceinline__ void dot_mma_tile(const FusedParams& p,
                                             const DotLayout& L,
                                             const void* qs,
                                             const uint32_t (&breg)[16][2],
                                             const uint8_t* stage, int tile,
                                             int chunk, float* sc, int lane) {
  constexpr bool kTf32 = MODE == kDotTf32x3;
  constexpr int NP = MODE == kDotBf16x3 ? 3 : (kTf32 ? 2 : 1);
  constexpr bool kRound = MODE == kDotBf16Hold || MODE == kDotBf16;
  const int rs = L.cb + 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m = lane >> 3;  // ldmatrix: lane l addresses row l % 8 of matrix m
  const uint32_t a_addr =
      smem_addr(stage + ((lane & 7) + (m & 1) * 8) * rs + (m >> 1) * 16);
  const bool last = chunk == L.nchunk - 1;
  const int col0 = chunk * L.cb / (kTf32 ? 4 : 2);  // the chunk's first column
  for (int nt = 0; nt < L.ntiles; ++nt) {
    float c[4], c2[4] = {0.f, 0.f, 0.f, 0.f};  // c2: the split's small terms
    int idx[4];
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = tile * kDotTile + g + (e >> 1) * 8;
      const int q = nt * 8 + 2 * t + (e & 1);
      ok[e] = j < p.B && q < p.nq;
      idx[e] = j * p.nq + q;
      c[e] = chunk > 0 && ok[e] ? sc[idx[e]] : 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      if (ks >= L.ksteps) break;  // uniform
      uint32_t a[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
          : "r"(a_addr + ks * 32));
      uint32_t b[NP][2];
      if constexpr (MODE == kDotBf16Hold) {
        b[0][0] = breg[ks][0];
        b[0][1] = breg[ks][1];
      } else {
        query_frag<MODE, NP>(L, qs, p.nq, nt,
                             col0 + ks * (kTf32 ? 8 : 16), lane, b);
      }
      if constexpr (kTf32) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __uint_as_float(a[e]);
          hi[e] = to_tf32(x);
          lo[e] = to_tf32(x - __uint_as_float(hi[e]));
        }
        mma_tf32(c2, lo, b[0][0], b[0][1]);
        mma_tf32(c2, hi, b[1][0], b[1][1]);
        mma_tf32(c, hi, b[0][0], b[0][1]);
      } else {
#pragma unroll
        for (int i = NP - 1; i > 0; --i) mma_bf16(c2, a, b[i][0], b[i][1]);
        mma_bf16(c, a, b[0][0], b[0][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[e]) continue;
      const float x = c[e] + c2[e];
      sc[idx[e]] = kRound && last ? __bfloat162float(__float2bfloat16_rn(x))
                                  : x;
    }
  }
}

// dot_score: ids[row, j] = slot j (0 past the count); scores[row, j, q] =
// table[clip(id)] . query[q], an f32 sum rounded once to bf16 when
// round_bf16 (MODE kDotBf16Hold / kDotBf16), else left f32. Pad slots
// score row 0, as the reference's do. One CTA of kWarpsPerCta warps
// per block (see the note at the top).
template <int FMT, int MODE>
__global__ void __launch_bounds__(vbyte::kWarpsPerCta * 32, kDotCtasPerSm)
    dot_kernel(FusedParams p, DotLayout L) {
  // [slots B][staged bytes][query f32 [nq][qs]][ring per warp]
  extern __shared__ __align__(16) uint8_t dot_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int B = p.B;
  const long long row = blockIdx.x;
  uint32_t* slots = reinterpret_cast<uint32_t*>(dot_smem);
  void* qs = dot_smem + L.off_query;
  // every read from device memory issued at once: the block's bytes and
  // control or width (so the decode reads shared memory, not one round
  // trip per 32 bytes), and the query as given, into the ring's space
  // until the ring fills (so its layout below is built from shared memory)
  const int m = meta_bytes(FMT, B);
  const uint8_t* bytes = p.bytes + row * p.S;
  const uint8_t* meta = m ? p.meta + row * m : p.meta;
  if (L.stage) {
    uint8_t* at = dot_smem + L.off_bytes;
    stage_async(at, bytes, p.S, threadIdx.x, blockDim.x);
    bytes = at;
    if (m) {
      stage_async(at + vbyte::round16(p.S), meta, m, threadIdx.x, blockDim.x);
      meta = at + vbyte::round16(p.S);
    }
  }
  const float* raw = reinterpret_cast<const float*>(dot_smem + L.off_ring);
  stage_async(dot_smem + L.off_ring,
              reinterpret_cast<const uint8_t*>(p.query), 4 * p.nq * p.d,
              threadIdx.x, blockDim.x);
  const int cnt = vbyte::clamp_count(p.counts[row], B);
  const uint32_t base = p.differential ? static_cast<uint32_t>(p.bases[row])
                                       : 0u;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // the query in rows L.qs elements apart, 0 past d: bf16 for a bf16
  // query (its values are bf16), f32 otherwise; warps 1-3 lay it out
  // while warp 0 decodes
  constexpr bool kBf16Query = MODE == kDotBf16Hold || MODE == kDotBf16;
  if (warp == 0) {
    decode_any(FMT, bytes, meta, 0, p.S, cnt, slots, B, lane);
    if (p.differential) vbyte::prefix_row(slots, B, cnt, base, lane);
  } else {  // two columns a thread and step (qw is even)
    for (int q = 0; q < p.nq; ++q) {
      const float* src = raw + q * p.d;
      for (int c = 2 * (threadIdx.x - 32); c < L.qw;
           c += 2 * (blockDim.x - 32)) {
        const float x0 = c < p.d ? src[c] : 0.f;
        const float x1 = c + 1 < p.d ? src[c + 1] : 0.f;
        if constexpr (kBf16Query) {
          reinterpret_cast<uint32_t*>(qs)[(q * L.qs + c) >> 1] =
              pack_bf16(x0, x1);
        } else {
          reinterpret_cast<float2*>(qs)[(q * L.qs + c) >> 1] =
              make_float2(x0, x1);
        }
      }
    }
  }
  __syncthreads();  // the copied query lies in the ring's space
  uint32_t breg[16][2];  // kDotBf16Hold: the query's B fragments
  if constexpr (MODE == kDotBf16Hold) {
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      uint32_t b[1][2] = {{0u, 0u}};
      if (ks < L.ksteps) query_frag<MODE, 1>(L, qs, p.nq, 0, ks * 16, lane, b);
      breg[ks][0] = b[0][0];
      breg[ks][1] = b[0][1];
    }
  }
  int* ids = p.out + row * B;
  for (int j = threadIdx.x; j < B; j += blockDim.x)
    ids[j] = j < cnt ? static_cast<int>(slots[j]) : 0;

  // this warp's tiles: warp, warp + 4, ...; each in nchunk stages
  const int n_tiles = (B + kDotTile - 1) / kDotTile;
  const int my_tiles =
      warp < n_tiles ? (n_tiles - warp + vbyte::kWarpsPerCta - 1) /
                           vbyte::kWarpsPerCta
                     : 0;
  const int n_items = my_tiles * L.nchunk;
  const int stage_bytes = kDotTile * (L.cb + 16);
  uint8_t* ring = dot_smem + L.off_ring + warp * kDotStages * stage_bytes;
  float* sc = static_cast<float*>(p.fout) + row * B * p.nq;
  auto tile_of = [&](int i) {
    return warp + vbyte::kWarpsPerCta * (i / L.nchunk);
  };
#pragma unroll
  for (int s = 0; s < kDotStages; ++s) {
    if (s < n_items)
      dot_stage(p, L, slots, cnt, tile_of(s), s % L.nchunk,
                ring + s * stage_bytes, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = 0; i < n_items; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDotStages - 1) : "memory");
    __syncwarp();
    const uint8_t* stage = ring + (i % kDotStages) * stage_bytes;
    dot_mma_tile<MODE>(p, L, qs, breg, stage, tile_of(i), i % L.nchunk, sc,
                       lane);
    __syncwarp();  // every lane is done with the stage before it refills
    const int next = i + kDotStages;
    if (next < n_items)
      dot_stage(p, L, slots, cnt, tile_of(next), next % L.nchunk,
                ring + (i % kDotStages) * stage_bytes, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

template <int FMT, int MODE>
int launch_dot_mode(const FusedParams& p, const DotLayout& L, size_t smem,
                    cudaStream_t stream) {
  if (smem > (48u << 10)) {
    cudaError_t e = cudaFuncSetAttribute(
        dot_kernel<FMT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    // all of L1 to shared memory: the rows stream past L1, and three CTAs
    // of ~72 KB fit an SM only so
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dot_kernel<FMT, MODE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dot_kernel<FMT, MODE><<<static_cast<unsigned>(p.nb),
                          vbyte::kWarpsPerCta * 32, smem, stream>>>(p, L);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_dot(const FusedParams& p, cudaStream_t stream) {
  const int es = p.table_bf16 ? 2 : 4;
  if (p.round_bf16 && !p.table_bf16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(p.d) * es;
  DotLayout L;
  L.nchunk = static_cast<int>((row_bytes + kDotChunk - 1) / kDotChunk);
  L.cb = (static_cast<int>((row_bytes + L.nchunk - 1) / L.nchunk) + 31) & ~31;
  L.ksteps = L.cb / 32;
  L.qw = L.nchunk * (L.cb / es);
  L.qs = L.qw + 8;
  L.ntiles = (p.nq + 7) / 8;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p.table);
  L.copy = p.table_vec16 ? 16 : (a % 4 == 0 && row_bytes % 4 == 0 ? 4 : 2);
  const int staged = vbyte::round16(p.S) + vbyte::round16(meta_bytes(FMT, p.B));
  L.stage = staged <= kDotMaxStaged;
  L.off_bytes = vbyte::round16(p.B * 4);
  // the query's rows in shared memory, bf16 for a bf16 query: rows
  // (qw + 8) / 2 = 4 x odd words apart (qw / 2 is a multiple of 8), so the
  // 8 rows one fragment read touches start on banks 4 x odd x g, and the
  // words of lanes (g, t) fall on 32 different banks; the ring's space
  // holds the query as given until the ring fills
  const bool hold = p.round_bf16 && L.ntiles == 1 && L.nchunk == 1;
  L.off_query = L.off_bytes + (L.stage ? staged : 0);
  L.off_ring =
      L.off_query + vbyte::round16((p.round_bf16 ? 2 : 4) * p.nq * L.qs);
  const int ring = vbyte::kWarpsPerCta * kDotStages * kDotTile * (L.cb + 16);
  const size_t smem =
      L.off_ring + std::max(ring, vbyte::round16(4 * p.nq * p.d));
  if (!p.table_bf16)
    return launch_dot_mode<FMT, kDotTf32x3>(p, L, smem, stream);
  if (!p.round_bf16)
    return launch_dot_mode<FMT, kDotBf16x3>(p, L, smem, stream);
  if (hold) return launch_dot_mode<FMT, kDotBf16Hold>(p, L, smem, stream);
  return launch_dot_mode<FMT, kDotBf16>(p, L, smem, stream);
}


// The row-aligned kernel's layout (RowLayout) and grid: staged where every
// part of a row can be (strides up to kMaxStagedStride, and the CTA's
// shared memory within kMaxRowSmem), else read in place.
template <int FMT, int EP>
int launch_rows(const FusedParams& p, cudaStream_t stream) {
  constexpr bool kWeighted = RowEp<EP>::kWeighted;
  constexpr bool kRebase = RowEp<EP>::kRebase;
  const int B = p.B;
  const int m = FMT == kStreamVbyte ? B >> 2 : 0;
  const int mw = kWeighted && p.w_format == kStreamVbyte ? B >> 2 : 0;
  RowLayout L{};
  L.off_w = vbyte::round16(4 * B);
  L.off_rows = L.off_w * (kWeighted ? 2 : 1);
  L.g_bytes = vbyte::stage_gran(p.bytes, p.S);
  L.g_meta = m ? vbyte::stage_gran(p.meta, m) : 16;
  L.g_wbytes = kWeighted ? vbyte::stage_gran(p.w_bytes, p.S_w) : 16;
  L.g_wmeta = mw ? vbyte::stage_gran(p.w_meta, mw) : 16;
  L.g_eb = kRebase ? vbyte::stage_gran(p.edge_base, 4 * B) : 16;
  L.at_meta = kRowBytesAt + vbyte::stage_bytes(p.S);
  L.at_wbytes = L.at_meta + vbyte::round16(m);
  L.at_wmeta = L.at_wbytes + (kWeighted ? vbyte::stage_bytes(p.S_w) : 0);
  L.at_eb = L.at_wmeta + vbyte::round16(mw);
  L.row = L.at_eb + (kRebase ? vbyte::round16(4 * B) : 0);
  L.staged = L.g_bytes && L.g_meta && L.g_wbytes && L.g_wmeta && L.g_eb &&
             static_cast<size_t>(vbyte::kWarpsPerCta) *
                     (L.off_rows + 2 * L.row) <= kMaxRowSmem;
  L.region = L.off_rows + (L.staged ? 2 * L.row : 0);
  int n_sm = 0;
  cudaError_t e = vbyte::sm_count(&n_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  // bm25_weighted_rows at launches of at most one row per SM: a CTA of
  // two warps per row, the weight stream decoded on the second beside the
  // main one (one warp doing both is 1.13-1.22x slower there)
  L.split = kWeighted && L.staged && p.nb <= n_sm;
  auto run = [&](auto kernel) {
    cudaError_t a = cudaSuccess;
    if (L.split) {
      const size_t smem = L.off_rows + L.row;
      if (smem > (48u << 10) &&
          (a = cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return static_cast<int>(a);
      kernel<<<static_cast<unsigned>(p.nb), 64, smem, stream>>>(p, L);
      return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = static_cast<size_t>(vbyte::kWarpsPerCta) * L.region;
    unsigned grid = 0;
    if ((a = vbyte::stage_grid(kernel, p.nb, smem, &grid)) != cudaSuccess)
      return static_cast<int>(a);
    kernel<<<grid, vbyte::kWarpsPerCta * 32, smem, stream>>>(p, L);
    return static_cast<int>(cudaGetLastError());
  };
  return L.staged ? run(fused_decode_kernel<FMT, EP, true>)
                  : run(fused_decode_kernel<FMT, EP, false>);
}

template <int FMT, int EP>
int launch(const FusedParams& p, cudaStream_t stream) {
  if constexpr (EP == kMembership || EP == kBm25Accum ||
                EP == kBm25Weighted) {
    return launch_probe<FMT, EP>(p, stream);
  } else if constexpr (EP == kDotScore) {
    return launch_dot<FMT>(p, stream);
  } else {
    return launch_rows<FMT, EP>(p, stream);
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
