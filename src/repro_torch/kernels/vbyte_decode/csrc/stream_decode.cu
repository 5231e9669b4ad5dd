// Kernel 3: blocked Stream-VByte decode with the fused differential sum.
//
// Replaces the TPU kernel src/repro/kernels/vbyte_decode/stream_kernel.py
// (stream_decode_blocked_pallas, tile cores stream_decode_tile +
// prefix_sum_tile).
//
// What bounds it on an H100: bytes. Per block it reads B/4 control bytes,
// the data bytes the lengths name and 8 bytes of count/base, and writes
// 4·B output bytes; a few integer operations per integer are far below
// the card's integer rate. On the search path's launches (tens to
// thousands of blocks) the chain of dependent device-memory reads a block
// takes sets the pace instead: a block whose count, control byte and data
// bytes are read one after another costs a round trip each.
//
// What the design does about it: the staged shape of kernels 1 and 4. A
// warp per block, four warps per CTA, as many CTAs as stay resident, each
// warp walking its blocks grid-stride. Every read of a block is issued at
// once by cp.async into the warp's shared memory — its count and base (one
// 4-byte copy each), its data row (16-byte pieces where the stride and
// base allow, 4-byte or byte copies otherwise) and its control row — and
// the next two blocks' reads are in flight while the warp decodes the
// current one (three staged rows a warp: with one block ahead, as kernels 1
// and 4 keep, the scale shape ran 1.036x slower). The TPU routed bytes to
// integers with a one-hot rank tensor and MXU scatters; here each lane
// reads one control byte (four integers) from shared memory, a warp
// shuffle scan of the byte totals gives every integer's data offset, and
// each integer is cut from an 8-byte window of the staged row by one
// funnel shift and a length mask (svb::decode_staged_row). The staged
// row's zero tail stands for the bytes past the row end, which add nothing
// (the reference kernel's semantics on corrupt rows). The differential sum
// is one warp scan per row (vbyte::scan_row), and rows go out in 16-byte
// stores. Rows wider than kMaxStagedStride are decoded in place
// (svb::decode_row).
#include "svb_core.cuh"

namespace {

constexpr int kBytesAt = 16;  // a staged row: count and base, then bytes

// Shared bytes of one staged row: count and base, the data row with its
// zero tail, the control row.
__host__ __device__ __forceinline__ int staged_row(int S, int C) {
  return kBytesAt + vbyte::stage_bytes(S) + vbyte::round16(C);
}

// Shared bytes a warp takes: its slots, then three staged rows (none when
// the rows are decoded in place).
__host__ __device__ __forceinline__ int region(int S, int B, int gran) {
  return vbyte::round16(4 * B) + (gran ? 3 * staged_row(S, B >> 2) : 0);
}

// GRAN: bytes per copy of the data row (16, 4, 1), or 0: rows read in
// place; cgran: the same for the control row.
template <int GRAN>
__global__ void __launch_bounds__(vbyte::kWarpsPerCta * 32)
    stream_decode_kernel(const uint8_t* __restrict__ control,
                         const uint8_t* __restrict__ data,
                         const int* __restrict__ counts,
                         const int* __restrict__ bases,
                         int* __restrict__ out, long long nb, int S, int B,
                         int differential, int cgran) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = B >> 2;
  const long long step =
      static_cast<long long>(gridDim.x) * vbyte::kWarpsPerCta;
  long long row =
      static_cast<long long>(blockIdx.x) * vbyte::kWarpsPerCta + warp;
  if (row >= nb) return;  // whole warp: the ragged edge of the grid
  uint8_t* at0 = smem + warp * region(S, B, GRAN);
  uint32_t* slots = reinterpret_cast<uint32_t*>(at0);
  uint8_t* staged = at0 + vbyte::round16(4 * B);
  const int RB = staged_row(S, C);
  const int SP = vbyte::stage_bytes(S);
  // row r's reads into staged row `at`, all issued at once
  auto issue = [&](long long r, uint8_t* at) {
    if (lane == 0) vbyte::stage_word(at, counts + r);
    if (lane == 1) vbyte::stage_word(at + 4, bases + r);
    if constexpr (GRAN != 0)
      vbyte::stage_row<GRAN>(at + kBytesAt, data + r * S, S, lane);
    vbyte::stage_any(at + kBytesAt + SP, control + r * C, C, cgran, lane);
  };
  int cur = 0;
  if constexpr (GRAN != 0) {
    // the bytes past S in every staged row stay 0
    for (int i = S + lane; i < SP; i += 32)
      staged[kBytesAt + i] = staged[RB + kBytesAt + i] =
          staged[2 * RB + kBytesAt + i] = 0;
    issue(row, staged);
    vbyte::stage_commit();
    if (row + step < nb) issue(row + step, staged + RB);
    vbyte::stage_commit();
  }
  for (;;) {
    // the reads two rows on, in flight with the next row's while this one
    // is decoded
    const long long nxt = row + step;
    if constexpr (GRAN != 0) {
      const long long nxt2 = nxt + step;
      if (nxt2 < nb) issue(nxt2, staged + ((cur + 2) % 3) * RB);
      vbyte::stage_commit();
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      __syncwarp();
      const uint8_t* at = staged + cur * RB;
      const int c = vbyte::clamp_count(*reinterpret_cast<const int*>(at), B);
      svb::decode_staged_row(at + kBytesAt + SP, at + kBytesAt, S, c, slots,
                             B, lane);
      if (differential)
        vbyte::scan_row(slots, B, c,
                        *reinterpret_cast<const uint32_t*>(at + 4), lane);
    } else {
      const int c = vbyte::clamp_count(counts[row], B);
      svb::decode_row(control + row * C, data + row * S, S, c, slots, B,
                      lane);
      if (differential)
        vbyte::scan_row(slots, B, c, static_cast<uint32_t>(bases[row]),
                        lane);
    }
    vbyte::store_row(slots, out + row * B, B, lane);
    __syncwarp();
    if (nxt >= nb) break;
    row = nxt;
    cur = (cur + 1) % 3;
  }
}

template <int GRAN>
int launch(const void* control, const void* data, const void* counts,
           const void* bases, void* out, long long nb, int S, int B,
           int differential, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(vbyte::kWarpsPerCta) * region(S, B, GRAN);
  const int cgran = vbyte::stage_gran(control, B >> 2);
  unsigned grid = 0;
  cudaError_t e =
      vbyte::stage_grid(stream_decode_kernel<GRAN>, nb, smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_decode_kernel<GRAN>
      <<<grid, vbyte::kWarpsPerCta * 32, smem, stream>>>(
          static_cast<const uint8_t*>(control),
          static_cast<const uint8_t*>(data), static_cast<const int*>(counts),
          static_cast<const int*>(bases), static_cast<int*>(out), nb, S, B,
          differential, cgran);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stream_decode_blocked_launch(const void* control,
                                            const void* data,
                                            const void* counts,
                                            const void* bases, void* out,
                                            long long nb, int S, int B,
                                            int differential, void* stream) {
  if (nb <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vbyte::stage_gran(data, S)) {
    case 16:
      return launch<16>(control, data, counts, bases, out, nb, S, B,
                        differential, st);
    case 4:
      return launch<4>(control, data, counts, bases, out, nb, S, B,
                       differential, st);
    case 1:
      return launch<1>(control, data, counts, bases, out, nb, S, B,
                       differential, st);
    default:
      return launch<0>(control, data, counts, bases, out, nb, S, B,
                       differential, st);
  }
}

extern "C" const char* stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
