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
// What the design does about it: one warp per block, four blocks per CTA,
// no cross-block state (per-block count/base carry it all), so the grid
// is as wide as the block count and needs no padding to a tile multiple.
// The routing that the TPU did with 16-bit-split f32 matmuls and one-hot
// MXU scatters is a ballot + popcount per 32 bytes and one shared-memory
// atomicAdd per byte (vbyte_core.cuh); the walk stops at the first chunk
// that completes `count` integers, so padding bytes are mostly never read.
// Output rows are written coalesced, 32 consecutive int32 per warp store.
// This is the simple first version: one byte per lane per step and no
// wider loads, no TMA.
#include "vbyte_core.cuh"

namespace {

__global__ void vbyte_decode_kernel(const uint8_t* __restrict__ payload,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ bases,
                                    int* __restrict__ out, long long nb, int S,
                                    int B, int differential) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * vbyte::kWarpsPerCta + warp;
  if (row >= nb) return;  // whole warp: the ragged edge of the grid
  uint32_t* slots = smem + warp * B;
  const int cnt = vbyte::clamp_count(counts[row], B);
  vbyte::decode_row(payload + row * S, S, cnt, slots, B, lane);
  if (differential)
    vbyte::prefix_row(slots, B, cnt, static_cast<uint32_t>(bases[row]), lane);
  int* o = out + row * B;
  for (int j = lane; j < B; j += 32) o[j] = static_cast<int>(slots[j]);
}

}  // namespace

extern "C" int vbyte_decode_blocked_launch(const void* payload,
                                           const void* counts,
                                           const void* bases, void* out,
                                           long long nb, int S, int B,
                                           int differential, void* stream) {
  if (nb <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((nb + vbyte::kWarpsPerCta - 1) /
                                        vbyte::kWarpsPerCta));
  const dim3 block(vbyte::kWarpsPerCta * 32);
  const size_t smem = sizeof(uint32_t) * vbyte::kWarpsPerCta * B;
  vbyte_decode_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int*>(counts),
      static_cast<const int*>(bases), static_cast<int*>(out), nb, S, B,
      differential);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vbyte_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
