// Masked-VByte block-decode core shared by kernel 1 (vbyte_decode.cu:
// decode only) and kernel 2 (fused_decode.cu: decode + query epilogue),
// with the staging, scan and store steps that kernels 1-4 share (below).
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
// 32 slots at a time, carrying the running total between chunks. Kernel
// 2's probe_kernel and dot_kernel scan with it; the staged kernels use
// scan_row below.
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

// ---------------------------------------------------------------------------
// Staged rows (kernels 1, 3 and 4, and kernel 2). A warp walks its rows
// grid-stride: the next row's bytes are copied into shared memory
// (stage_row, cp.async) beside its count and base while the current row is
// decoded from its staged copy; then scan_row and store_row finish it.
// decode_row above stays for rows too wide to stage, and for kernel 2's
// probe_kernel and dot_kernel.
// ---------------------------------------------------------------------------

constexpr int kMaxStagedStride = 8192;  // wider rows are read in place

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// Shared bytes a staged row takes: its stride rounded up to 16, and 16
// bytes past it that stay 0 (binpack's 8-byte windows read them).
__host__ __device__ __forceinline__ int stage_bytes(int S) {
  return round16(S) + 16;
}

// Bytes per copy for rows of stride S from `base`: 16 or 4 (cp.async)
// where the base and S allow, 1 (plain loads) otherwise, 0 where the row
// is too wide to stage (decoded in place).
__host__ __forceinline__ int stage_gran(const void* base, int S) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (S > kMaxStagedStride) return 0;
  if (a % 16 == 0 && S % 16 == 0) return 16;
  if (a % 4 == 0 && S % 4 == 0) return 4;
  return 1;
}

// Copy one row's S bytes to shared `dst` by the warp. G = 16 or 4: cp.async
// (complete at this lane's cp.async.wait_group); G = 1: byte loads.
template <int G>
__device__ __forceinline__ void stage_row(uint8_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int S, int lane) {
  if constexpr (G == 1) {
    for (int i = lane; i < S; i += 32) dst[i] = src[i];
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    for (int i = G * lane; i < S; i += G * 32) {
      if constexpr (G == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         d + i),
                     "l"(src + i)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + i),
                     "l"(src + i)
                     : "memory");
    }
  }
}

// stage_row with the copy size chosen at run time (uniform over the warp).
__device__ __forceinline__ void stage_any(uint8_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int n, int gran, int lane) {
  if (gran == 16) {
    stage_row<16>(dst, src, n, lane);
  } else if (gran == 4) {
    stage_row<4>(dst, src, n, lane);
  } else {
    stage_row<1>(dst, src, n, lane);
  }
}

// One 4-byte word to shared `dst` by cp.async (the calling lane's group).
__device__ __forceinline__ void stage_word(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this lane's copy groups is pending.
__device__ __forceinline__ void stage_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// decode_row over a row staged in shared memory (kernel 1): the same walk
// and the same sums, with two changes. Each chunk's byte is read while the
// chunk before it is walked. And a 32-byte chunk without continuation bits
// whose previous byte ends an integer holds 32 whole one-byte integers:
// byte k of it is integer seen + k, stored as it is (what adding it to the
// zeroed slot gives), without the position arithmetic or the atomics. The
// search index's long lists are mostly such bytes. (A walk of 128 bytes a
// step, a 32-bit word a lane and four ballots, gave the same slots and was
// slower on the card.)
__device__ __forceinline__ void decode_staged_row(const uint8_t* row, int S,
                                                  int cnt, uint32_t* slots,
                                                  int B, int lane) {
  for (int j = lane; j < B; j += 32) slots[j] = 0u;
  __syncwarp();
  const unsigned lanemask_lt = (1u << lane) - 1u;
  unsigned prev_cont = 0u;
  int seen = 0;
  uint32_t next = (lane < S) ? static_cast<uint32_t>(row[lane]) : 0u;
  for (int base = 0; base < S && seen < cnt; base += 32) {
    const int i = base + lane;
    const uint32_t b = next;
    next = (i + 32 < S) ? static_cast<uint32_t>(row[i + 32]) : 0u;
    const unsigned cont = __ballot_sync(kFull, (b >> 7) != 0u);
    const unsigned in_row =
        (S - base >= 32) ? kFull : ((1u << (S - base)) - 1u);
    if (cont == 0u && (prev_cont >> 31) == 0u) {
      if (i < S && seen + lane < cnt) slots[seen + lane] = b;
      seen += __popc(in_row);
      prev_cont = 0u;
      continue;
    }
    const unsigned end = ~cont & in_row;
    const int out_idx = seen + __popc(end & lanemask_lt);
    const unsigned long long win =
        (static_cast<unsigned long long>(cont) << 32) | prev_cont;
    const unsigned c1 = static_cast<unsigned>(win >> (31 + lane)) & 1u;
    const unsigned c2 = static_cast<unsigned>(win >> (30 + lane)) & 1u;
    const unsigned c3 = static_cast<unsigned>(win >> (29 + lane)) & 1u;
    const unsigned c4 = static_cast<unsigned>(win >> (28 + lane)) & 1u;
    const unsigned pos = c1 * (1u + c2 * (1u + c3 * (1u + c4)));
    if (i < S && out_idx < cnt)
      atomicAdd(&slots[out_idx], (b & 0x7Fu) << (7u * pos));
    seen += __popc(end);
    prev_cont = cont;
  }
  __syncwarp();
}

// The differential epilogue over a decoded row: inclusive prefix sum mod
// 2^32 plus `base`, slots >= cnt zeroed (the TPU kernels' prefix_sum_tile,
// a triangular matmul there; prefix_row's result). `slots` is 16-byte
// aligned. Each lane takes
// ceil(B / 32) consecutive slots, sums them serially, and one warp scan of
// the lanes' totals gives each lane its carry.
__device__ __forceinline__ void scan_row(uint32_t* slots, int B, int cnt,
                                         uint32_t base, int lane) {
  const int k = (B + 31) >> 5;
  const int j0 = min(lane * k, B), j1 = min(j0 + k, B);
  const bool vec = (k & 3) == 0;  // j0 is then 16-byte aligned
  uint32_t total = 0;
  if (vec) {
    for (int j = j0; j < j1; j += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(slots + j);
      total += q.x + q.y + q.z + q.w;
    }
  } else {
    for (int j = j0; j < j1; ++j) total += slots[j];
  }
  uint32_t x = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  uint32_t run = base + (x - total);
  if (vec) {
    for (int j = j0; j < j1; j += 4) {
      uint4 q = *reinterpret_cast<const uint4*>(slots + j);
      q.x = j < cnt ? (run += q.x) : 0u;
      q.y = j + 1 < cnt ? (run += q.y) : 0u;
      q.z = j + 2 < cnt ? (run += q.z) : 0u;
      q.w = j + 3 < cnt ? (run += q.w) : 0u;
      *reinterpret_cast<uint4*>(slots + j) = q;
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      run += slots[j];
      slots[j] = j < cnt ? run : 0u;
    }
  }
  __syncwarp();
}

// The warp stores a finished row: 16-byte stores where B % 4 == 0 (`out`
// is then 16-byte aligned: the wrapper allocates it), 4-byte otherwise.
__device__ __forceinline__ void store_row(const uint32_t* slots,
                                          int* __restrict__ out, int B,
                                          int lane) {
  if ((B & 3) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(slots);
    uint4* o = reinterpret_cast<uint4*>(out);
    for (int q = lane; q < (B >> 2); q += 32) o[q] = s[q];
  } else {
    for (int j = lane; j < B; j += 32) out[j] = static_cast<int>(slots[j]);
  }
}

// Shared bytes a warp of kernel 1 or 4 takes: its slots, then two staged
// rows (none when the rows are decoded in place).
__host__ __device__ __forceinline__ int warp_region(int S, int B, int gran) {
  return round16(4 * B) + (gran ? 2 * stage_bytes(S) : 0);
}

// The device's SM count (read once).
__host__ inline cudaError_t sm_count(int* n_sm) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
  }
  *n_sm = cached;
  return cudaSuccess;
}

// The grid of a staged kernel (1, 3, 4, or kernel 2's row-aligned one):
// one CTA of kWarpsPerCta warps per kWarpsPerCta rows, at most as many as
// stay resident; the warps then walk the rows grid-stride. Sets the
// kernel's dynamic shared memory limit.
template <typename Kernel>
__host__ cudaError_t stage_grid(Kernel kernel, long long nb, size_t smem,
                                unsigned* grid) {
  int n_sm = 0;
  cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kWarpsPerCta * 32, smem)) != cudaSuccess)
    return e;
  const long long want = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  const long long most =
      static_cast<long long>(n_sm) * (per_sm < 1 ? 1 : per_sm);
  *grid = static_cast<unsigned>(want < most ? want : most);
  return cudaSuccess;
}

}  // namespace vbyte
