// Kernel 4: blocked binpack decode with the fused differential sum.
//
// Replaces the TPU kernel src/repro/kernels/vbyte_decode/binpack_kernel.py
// (binpack_decode_blocked_pallas, tile cores binpack_decode_tile +
// prefix_sum_tile).
//
// What bounds it on an H100: bytes. Per block it reads the width byte,
// ceil(count·w/8) data bytes and 8 bytes of count/base, and writes 4·B
// output bytes; the shift and mask per integer are far below the card's
// integer rate.
//
// What the design does about it: a warp per block, four warps per CTA, as
// many CTAs as stay resident, each warp walking its blocks grid-stride.
// Every read of a block is issued at once: count, base, width and the data
// row (which does not depend on the width) — the row copied into shared
// memory by cp.async, 16 bytes a piece where the stride and base allow
// (4-byte or byte copies otherwise) — and the next block's reads are in
// flight while the warp decodes the current one (two staged rows a warp).
// The TPU fetched each value's 40-bit window with a one-hot MXU gather
// against five shifted copies of the data tile; here each lane reads two
// 32-bit words of the staged row and funnel-shifts them
// (binpack::decode_staged_row), with the reference kernel's semantics on
// garbage input (window start clamped to byte S-1, bytes past S read as 0,
// widths 0 and >= 32). The differential sum is one warp scan per row
// (vbyte::scan_row: a lane sums B/32 consecutive slots), and rows go out
// in 16-byte stores. Rows wider than kMaxStagedStride are decoded in place
// from device memory (binpack::decode_row).
#include "binpack_core.cuh"

namespace {

// GRAN: bytes per staging copy (16, 4, 1), or 0: rows read in place.
template <int GRAN>
__global__ void __launch_bounds__(vbyte::kWarpsPerCta * 32)
    binpack_decode_kernel(const uint8_t* __restrict__ widths,
                          const uint8_t* __restrict__ data,
                          const int* __restrict__ counts,
                          const int* __restrict__ bases,
                          int* __restrict__ out, long long nb, int S, int B,
                          int differential) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long step =
      static_cast<long long>(gridDim.x) * vbyte::kWarpsPerCta;
  long long row =
      static_cast<long long>(blockIdx.x) * vbyte::kWarpsPerCta + warp;
  if (row >= nb) return;  // whole warp: the ragged edge of the grid
  uint8_t* region = smem + warp * vbyte::warp_region(S, B, GRAN);
  uint32_t* slots = reinterpret_cast<uint32_t*>(region);
  uint8_t* staged = region + vbyte::round16(4 * B);
  const int SP = vbyte::stage_bytes(S);
  int cur = 0;
  if constexpr (GRAN != 0) {
    // the bytes past S in both staged rows stay 0
    for (int i = S + lane; i < SP; i += 32) staged[i] = staged[SP + i] = 0;
    vbyte::stage_row<GRAN>(staged, data + row * S, S, lane);
    vbyte::stage_commit();
  }
  int w = widths[row];
  int cnt = counts[row];
  uint32_t base = static_cast<uint32_t>(bases[row]);
  for (;;) {
    // the next row's reads, in flight while this one is decoded
    const long long nxt = row + step;
    int w_n = 0;
    int cnt_n = 0;
    uint32_t base_n = 0u;
    if (nxt < nb) {
      if constexpr (GRAN != 0)
        vbyte::stage_row<GRAN>(staged + (cur ^ 1) * SP, data + nxt * S, S,
                               lane);
      w_n = widths[nxt];
      cnt_n = counts[nxt];
      base_n = static_cast<uint32_t>(bases[nxt]);
    }
    const int c = vbyte::clamp_count(cnt, B);
    if constexpr (GRAN != 0) {
      vbyte::stage_commit();
      vbyte::stage_wait_one();
      __syncwarp();
      binpack::decode_staged_row(staged + cur * SP, S, w, c, slots, B,
                                 lane);
    } else {
      binpack::decode_row(widths + row, data + row * S, S, c, slots, B,
                          lane);
    }
    if (differential) vbyte::scan_row(slots, B, c, base, lane);
    vbyte::store_row(slots, out + row * B, B, lane);
    __syncwarp();
    if (nxt >= nb) break;
    row = nxt;
    cur ^= 1;
    w = w_n;
    cnt = cnt_n;
    base = base_n;
  }
}

template <int GRAN>
int launch(const void* widths, const void* data, const void* counts,
           const void* bases, void* out, long long nb, int S, int B,
           int differential, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(vbyte::kWarpsPerCta) *
                      vbyte::warp_region(S, B, GRAN);
  unsigned grid = 0;
  cudaError_t e =
      vbyte::stage_grid(binpack_decode_kernel<GRAN>, nb, smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  binpack_decode_kernel<GRAN>
      <<<grid, vbyte::kWarpsPerCta * 32, smem, stream>>>(
          static_cast<const uint8_t*>(widths),
          static_cast<const uint8_t*>(data), static_cast<const int*>(counts),
          static_cast<const int*>(bases), static_cast<int*>(out), nb, S, B,
          differential);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int binpack_decode_blocked_launch(const void* widths,
                                             const void* data,
                                             const void* counts,
                                             const void* bases, void* out,
                                             long long nb, int S, int B,
                                             int differential, void* stream) {
  if (nb <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vbyte::stage_gran(data, S)) {
    case 16:
      return launch<16>(widths, data, counts, bases, out, nb, S, B,
                        differential, st);
    case 4:
      return launch<4>(widths, data, counts, bases, out, nb, S, B,
                       differential, st);
    case 1:
      return launch<1>(widths, data, counts, bases, out, nb, S, B,
                       differential, st);
    default:
      return launch<0>(widths, data, counts, bases, out, nb, S, B,
                       differential, st);
  }
}

extern "C" const char* binpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
