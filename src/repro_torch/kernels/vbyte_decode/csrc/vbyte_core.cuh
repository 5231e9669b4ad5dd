// Masked-VByte block-decode core shared by both kernels of this directory
// (vbyte_decode.cu: decode only; fused_decode.cu: decode + query epilogue).
//
// One warp decodes one compressed block. The block's payload row is walked
// 32 bytes at a time, one byte per lane:
//
//   * __ballot_sync over the continuation bits (byte >> 7) is the paper's
//     pmovmskb: one 32-bit mask per chunk, held by every lane;
//   * out_idx = terminators before this chunk + __popc(~cont & lanemask_lt)
//     is the byte's output slot (the exclusive prefix sum over terminator
//     flags that the TPU kernel ran as a triangular matmul);
//   * pos = c1·(1 + c2·(1 + c3·(1 + c4))) over the 4 preceding
//     continuation bits (the previous chunk's last 4 bits at a chunk edge)
//     is the byte's position inside its integer, capped at 4;
//   * (byte & 0x7F) << 7·pos is added into a B-slot uint32 row in shared
//     memory with a shared atomicAdd. Adding (not OR-ing) is what the
//     reference's one-hot scatter-sum does; integer addition mod 2^32 is
//     order-free, so the row is bit-identical to it, including for
//     overlong or corrupt runs of more than 5 continuation bytes.
//
// Bytes whose out_idx >= count are dropped (zero padding bytes look like
// terminators of 0), and slots >= count are never written, so they stay 0.
// The walk stops at the first chunk that completes `count` integers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vbyte {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerCta = 4;

// All 32 lanes of a warp call this. `slots` is the warp's B-slot row in
// shared memory; on return slots[j] holds integer j (uint32, 0 for j >= cnt).
__device__ __forceinline__ void decode_row(const uint8_t* __restrict__ row,
                                           int S, int cnt, uint32_t* slots,
                                           int B, int lane) {
  for (int j = lane; j < B; j += 32) slots[j] = 0u;
  __syncwarp();
  const unsigned lanemask_lt = (1u << lane) - 1u;
  unsigned prev_cont = 0u;  // continuation bits of the previous chunk
  int seen = 0;             // terminators before this chunk (warp-uniform)
  for (int base = 0; base < S && seen < cnt; base += 32) {
    const int i = base + lane;
    const uint32_t b = (i < S) ? static_cast<uint32_t>(row[i]) : 0u;
    const unsigned cont = __ballot_sync(kFull, (b >> 7) != 0u);
    const unsigned in_row =
        (S - base >= 32) ? kFull : ((1u << (S - base)) - 1u);
    const unsigned end = ~cont & in_row;
    const int out_idx = seen + __popc(end & lanemask_lt);
    // bit 32 + lane of the window is this byte; bit 32 + lane - k is byte i-k
    const unsigned long long win =
        (static_cast<unsigned long long>(cont) << 32) | prev_cont;
    const unsigned c1 = static_cast<unsigned>(win >> (31 + lane)) & 1u;
    const unsigned c2 = static_cast<unsigned>(win >> (30 + lane)) & 1u;
    const unsigned c3 = static_cast<unsigned>(win >> (29 + lane)) & 1u;
    const unsigned c4 = static_cast<unsigned>(win >> (28 + lane)) & 1u;
    const unsigned pos = c1 * (1u + c2 * (1u + c3 * (1u + c4)));
    if (i < S && out_idx < cnt) atomicAdd(&slots[out_idx], (b & 0x7Fu) << (7u * pos));
    seen += __popc(end);
    prev_cont = cont;
  }
  __syncwarp();
}

// Fused differential epilogue: inclusive prefix sum of the row mod 2^32,
// plus the block's base, slots >= cnt zeroed afterwards. A warp scan over
// 32 slots at a time, carrying the running total between chunks.
__device__ __forceinline__ void prefix_row(uint32_t* slots, int B, int cnt,
                                           uint32_t base, int lane) {
  uint32_t carry = base;
  for (int c = 0; c < B; c += 32) {
    const int j = c + lane;
    uint32_t x = (j < B) ? slots[j] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    const uint32_t v = x + carry;
    if (j < B) slots[j] = (j < cnt) ? v : 0u;
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();
}

__device__ __forceinline__ int clamp_count(int count, int B) {
  return count < 0 ? 0 : (count > B ? B : count);
}

}  // namespace vbyte
