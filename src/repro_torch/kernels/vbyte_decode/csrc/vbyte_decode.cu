// Kernel 1: blocked Masked-VByte decode with the fused differential sum.
//
// Replaces the TPU kernel src/repro/kernels/vbyte_decode/kernel.py
// (decode_blocked_pallas, tile cores decode_tile + prefix_sum_tile).
//
// What bounds it on an H100: bytes. Per block it reads at most S payload
// bytes plus 8 bytes of count/base and writes 4·B output bytes, and does a
// handful of integer operations per byte — far below the card's integer
// rate, so the floor is (payload + metadata + output bytes) / 3.35 TB/s.
//
// What the design does about it: a warp per block, four warps per CTA, as
// many CTAs as stay resident, each warp walking its blocks grid-stride.
// Every read of a block is issued at once — its whole payload row copied
// into shared memory by cp.async (16-byte pieces where the stride and base
// allow, 4-byte or byte copies otherwise) together with its count and
// base — and the next block's reads are in flight while the warp decodes
// the current one (two staged rows a warp). The decode is the shared
// core's walk over the staged bytes, not device memory, so a row no longer
// costs one round trip per 32 bytes (vbyte::decode_staged_row: a
// __ballot_sync over the continuation bits and __popc prefix counts per 32
// bytes, the routing the TPU did with 16-bit-split MXU matmuls, and a
// shared-memory atomicAdd per byte, which keeps the reference's sums on
// overlong runs; chunks of 32 one-byte integers are stored directly). The
// differential sum is one warp scan per row (vbyte::scan_row: a lane sums
// B/32 consecutive slots), and rows go out in 16-byte stores. Loading the
// full stride reads padding that the walk never needed; rows wider than
// kMaxStagedStride are walked in place.
#include "vbyte_core.cuh"

namespace {

// GRAN: bytes per staging copy (16, 4, 1), or 0: rows read in place.
template <int GRAN>
__global__ void __launch_bounds__(vbyte::kWarpsPerCta * 32)
    vbyte_decode_kernel(const uint8_t* __restrict__ payload,
                        const int* __restrict__ counts,
                        const int* __restrict__ bases, int* __restrict__ out,
                        long long nb, int S, int B, int differential) {
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
    vbyte::stage_row<GRAN>(staged, payload + row * S, S, lane);
    vbyte::stage_commit();
  }
  int cnt = counts[row];
  uint32_t base = static_cast<uint32_t>(bases[row]);
  for (;;) {
    // the next row's reads, in flight while this one is decoded
    const long long nxt = row + step;
    int cnt_n = 0;
    uint32_t base_n = 0u;
    if (nxt < nb) {
      if constexpr (GRAN != 0)
        vbyte::stage_row<GRAN>(staged + (cur ^ 1) * SP, payload + nxt * S, S,
                               lane);
      cnt_n = counts[nxt];
      base_n = static_cast<uint32_t>(bases[nxt]);
    }
    const int c = vbyte::clamp_count(cnt, B);
    if constexpr (GRAN != 0) {
      vbyte::stage_commit();
      vbyte::stage_wait_one();
      __syncwarp();
      vbyte::decode_staged_row(staged + cur * SP, S, c, slots, B, lane);
    } else {
      vbyte::decode_row(payload + row * S, S, c, slots, B, lane);
    }
    if (differential) vbyte::scan_row(slots, B, c, base, lane);
    vbyte::store_row(slots, out + row * B, B, lane);
    __syncwarp();
    if (nxt >= nb) break;
    row = nxt;
    cur ^= 1;
    cnt = cnt_n;
    base = base_n;
  }
}

template <int GRAN>
int launch(const void* payload, const void* counts, const void* bases,
           void* out, long long nb, int S, int B, int differential,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(vbyte::kWarpsPerCta) *
                      vbyte::warp_region(S, B, GRAN);
  unsigned grid = 0;
  cudaError_t e =
      vbyte::stage_grid(vbyte_decode_kernel<GRAN>, nb, smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  vbyte_decode_kernel<GRAN>
      <<<grid, vbyte::kWarpsPerCta * 32, smem, stream>>>(
          static_cast<const uint8_t*>(payload),
          static_cast<const int*>(counts),
          static_cast<const int*>(bases), static_cast<int*>(out), nb, S, B,
          differential);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vbyte_decode_blocked_launch(const void* payload,
                                           const void* counts,
                                           const void* bases, void* out,
                                           long long nb, int S, int B,
                                           int differential, void* stream) {
  if (nb <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vbyte::stage_gran(payload, S)) {
    case 16:
      return launch<16>(payload, counts, bases, out, nb, S, B, differential,
                        st);
    case 4:
      return launch<4>(payload, counts, bases, out, nb, S, B, differential,
                       st);
    case 1:
      return launch<1>(payload, counts, bases, out, nb, S, B, differential,
                       st);
    default:
      return launch<0>(payload, counts, bases, out, nb, S, B, differential,
                       st);
  }
}

extern "C" const char* vbyte_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
