// Binpack block-decode core, shared by kernel 4 (binpack_decode.cu:
// decode only) and kernel 2 (fused_decode.cu: decode + query epilogue).
//
// Value j of a width-w block starts at bit j·w, LSB-first, so there is no
// scan: each lane decodes slots lane, lane+32, ... on its own. It reads
// the 5-byte window at byte0 = min(j·w >> 3, S-1), with bytes at index
// >= S reading as 0, and computes (lo24 >> shift) | (hi16 << (24 - shift))
// masked to w bits, shift = j·w & 7. These are the reference Pallas
// kernel's exact semantics (binpack_kernel.py, binpack_decode_tile),
// including its garbage-input cases: w = 0 gives zeros, w >= 32 (32 or a
// corrupt width) masks with all ones, and the hi16 shift wraps in 32
// bits (uint32 here, int32 there: the same bits).
#pragma once

#include "vbyte_core.cuh"

namespace binpack {

__device__ __forceinline__ uint32_t value(const uint8_t* __restrict__ row,
                                          int S, int w, int j) {
  const int bitpos = j * w;
  const int byte0 = min(bitpos >> 3, S - 1);
  const int shift = bitpos & 7;
  uint32_t b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    b[k] = (byte0 + k < S) ? static_cast<uint32_t>(row[byte0 + k]) : 0u;
  const uint32_t lo24 = b[0] | (b[1] << 8) | (b[2] << 16);
  const uint32_t hi16 = b[3] | (b[4] << 8);
  const uint32_t val = (lo24 >> shift) | (hi16 << (24 - shift));
  const uint32_t mask = (w >= 32) ? 0xffffffffu : ((1u << w) - 1u);
  return val & mask;
}

// All 32 lanes of a warp call this. `width` points at the block's width
// byte, `data` at its S data bytes; on return slots[j] holds integer j
// (uint32, 0 for j >= cnt).
__device__ __forceinline__ void decode_row(const uint8_t* __restrict__ width,
                                           const uint8_t* __restrict__ data,
                                           int S, int cnt, uint32_t* slots,
                                           int B, int lane) {
  const int w = static_cast<int>(*width);
  for (int j = lane; j < B; j += 32)
    slots[j] = (j < cnt) ? value(data, S, w, j) : 0u;
  __syncwarp();
}

// The same values from a row staged in shared memory (kernel 4): `row` is
// 16-byte aligned and holds the S data bytes followed by at least 8 zero
// bytes. Value j is the 32 bits of the byte stream from bit byte0·8 +
// (j·w & 7), byte0 = min(j·w >> 3, S-1) — the 40-bit window above shifted
// and cut to 32 bits — read from two 32-bit words with one funnel shift.
// Bytes at or past S are the zero padding. Lanes write slots lane,
// lane+32, ... (0 for j >= cnt).
__device__ __forceinline__ void decode_staged_row(const uint8_t* row, int S,
                                                  int w, int cnt,
                                                  uint32_t* slots, int B,
                                                  int lane) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const uint32_t mask = (w >= 32) ? 0xffffffffu : ((1u << w) - 1u);
  for (int j = lane; j < B; j += 32) {
    uint32_t v = 0u;
    if (j < cnt) {
      const int bitpos = j * w;
      const int start = min(bitpos >> 3, S - 1) * 8 + (bitpos & 7);
      const int i = start >> 5;
      v = __funnelshift_r(words[i], words[i + 1], start & 31) & mask;
    }
    slots[j] = v;
  }
  __syncwarp();
}

}  // namespace binpack
