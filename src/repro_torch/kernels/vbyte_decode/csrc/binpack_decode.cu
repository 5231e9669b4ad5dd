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
// What the design does about it: one warp per block, four blocks per CTA.
// The TPU fetched each value's 40-bit window with a one-hot MXU gather
// against five shifted copies of the data tile; here each lane computes
// bit position j·w and reads its 5-byte window directly
// (binpack_core.cuh) — no scan, no routing. The row goes through shared
// memory only for the prefix sum (vbyte::prefix_row); output rows are
// written coalesced. Simple first version: byte loads, no funnel shifts
// over wider words.
#include "binpack_core.cuh"

namespace {

__global__ void binpack_decode_kernel(const uint8_t* __restrict__ widths,
                                      const uint8_t* __restrict__ data,
                                      const int* __restrict__ counts,
                                      const int* __restrict__ bases,
                                      int* __restrict__ out, long long nb,
                                      int S, int B, int differential) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * vbyte::kWarpsPerCta + warp;
  if (row >= nb) return;  // whole warp: the ragged edge of the grid
  uint32_t* slots = smem + warp * B;
  const int cnt = vbyte::clamp_count(counts[row], B);
  binpack::decode_row(widths + row, data + row * S, S, cnt, slots, B, lane);
  if (differential)
    vbyte::prefix_row(slots, B, cnt, static_cast<uint32_t>(bases[row]), lane);
  int* o = out + row * B;
  for (int j = lane; j < B; j += 32) o[j] = static_cast<int>(slots[j]);
}

}  // namespace

extern "C" int binpack_decode_blocked_launch(const void* widths,
                                             const void* data,
                                             const void* counts,
                                             const void* bases, void* out,
                                             long long nb, int S, int B,
                                             int differential, void* stream) {
  if (nb <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((nb + vbyte::kWarpsPerCta - 1) /
                                        vbyte::kWarpsPerCta));
  const dim3 block(vbyte::kWarpsPerCta * 32);
  const size_t smem = sizeof(uint32_t) * vbyte::kWarpsPerCta * B;
  binpack_decode_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(widths), static_cast<const uint8_t*>(data),
      static_cast<const int*>(counts), static_cast<const int*>(bases),
      static_cast<int*>(out), nb, S, B, differential);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
