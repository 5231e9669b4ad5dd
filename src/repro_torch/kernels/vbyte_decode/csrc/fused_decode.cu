// Kernel 2: fused decode -> query epilogue, formats vbyte, streamvbyte and
// binpack.
//
// Replaces the TPU kernel src/repro/kernels/vbyte_decode/epilogues.py
// (fused_decode_pallas) for its three decode cores and the epilogues the
// search path runs: stream, checksum, membership, membership_rows,
// bm25_accum, bm25_accum_rows, bm25_weighted, bm25_weighted_rows.
//
// What bounds it on an H100: bytes for the row-aligned epilogues (the
// decoded block never leaves shared memory; each block writes one int32),
// and integer compares for the broadcast ones, which check every decoded
// slot against every probe (B x P per block).
//
// What the design does about it: the warp-per-block decode cores that
// kernels 1, 3 and 4 run (vbyte_core.cuh, svb_core.cuh, binpack_core.cuh),
// then the optional scan, then an epilogue — the reference's
// core-plus-epilogue shape, with the main stream's format and the
// epilogue as template parameters (3 x 8 instantiations). The weighted
// epilogues' impact stream may have another format than the main stream,
// as in the reference's API; it is decoded dense, non-differential, with
// the main row's count, through a branch on a run-time format argument
// that is uniform across the grid. The decoded row and the impact row stay
// in shared memory; the broadcast probe set is loaded into shared memory
// once per CTA. The compare is brute force in this first version; a
// binary search over the sorted block is a later optimisation.
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
};

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
  int* out;
  int* out2;  // checksum column [nb]
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

template <int FMT, int EP>
__global__ void fused_decode_kernel(FusedParams p) {
  constexpr bool kBroadcast =
      EP == kMembership || EP == kBm25Accum || EP == kBm25Weighted;
  constexpr bool kWeighted = EP == kBm25Weighted || EP == kBm25WeightedRows;
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int B = p.B;
  uint32_t* slots = smem + warp * B;
  uint32_t* wslots = smem + (vbyte::kWarpsPerCta + warp) * B;
  int* probe_s = reinterpret_cast<int*>(
      smem + (kWeighted ? 2 : 1) * vbyte::kWarpsPerCta * B);
  if (kBroadcast) {
    for (int i = threadIdx.x; i < p.P; i += blockDim.x) probe_s[i] = p.probe[i];
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
  const int impact = (EP == kBm25Accum || EP == kBm25AccumRows) ? *p.impact : 1;

  if (EP == kStream || EP == kChecksum) {
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
  } else if (kBroadcast) {
    // masked slots (j >= cnt) compare as -1, and only probes >= 0 count
    int* o = p.out + row * p.P;
    for (int i = lane; i < p.P; i += 32) {
      const int pi = probe_s[i];
      uint32_t acc = 0u;
      if (pi >= 0) {
        for (int j = 0; j < cnt; ++j) {
          if (static_cast<int>(slots[j]) == pi) {
            if (kWeighted) {
              acc += wslots[j];
            } else {
              acc = 1u;
              break;
            }
          }
        }
      }
      o[i] = kWeighted ? static_cast<int>(acc) : static_cast<int>(acc) * impact;
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

template <int FMT, int EP>
int launch(const FusedParams& p, cudaStream_t stream) {
  constexpr bool kBroadcast =
      EP == kMembership || EP == kBm25Accum || EP == kBm25Weighted;
  constexpr bool kWeighted = EP == kBm25Weighted || EP == kBm25WeightedRows;
  const dim3 grid(static_cast<unsigned>((p.nb + vbyte::kWarpsPerCta - 1) /
                                        vbyte::kWarpsPerCta));
  const dim3 block(vbyte::kWarpsPerCta * 32);
  const size_t smem =
      sizeof(uint32_t) * (kWeighted ? 2 : 1) * vbyte::kWarpsPerCta * p.B +
      (kBroadcast ? sizeof(int) * p.P : 0);
  fused_decode_kernel<FMT, EP><<<grid, block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
                                   int S_w, void* out, void* out2,
                                   void* stream) {
  if (nb <= 0) return 0;
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
                static_cast<int*>(out), static_cast<int*>(out2)};
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
