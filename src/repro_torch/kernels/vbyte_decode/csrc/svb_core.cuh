// Stream-VByte block-decode core, shared by kernel 3 (stream_decode.cu:
// decode only) and kernel 2 (fused_decode.cu: decode + query epilogue):
// decode_row reads the block in place from device memory,
// decode_staged_row from its copy in shared memory.
//
// One warp decodes one block. Lane l owns control byte l of each 32-byte
// chunk of the control row, i.e. the four integers 4l..4l+3 (at B=128 the
// warp covers the whole block in one step):
//
//   * it unpacks its four 2-bit codes (LSB-first) into lengths code+1,
//     or 0 at and past `count` (padding codes are 0 = length 1, so the
//     count mask is what keeps the padding out);
//   * a __shfl_up_sync inclusive scan of the per-lane byte totals, plus
//     the bytes of earlier chunks (a warp-uniform carry), gives the data
//     offset of its first integer — the exclusive prefix sum over lengths
//     that the TPU kernel ran as a triangular matmul;
//   * it assembles each integer from <= 4 little-endian data bytes.
//
// A data byte at or past the row end S is never read and adds nothing:
// that is the reference's dense routing (stream_kernel.py,
// _dense_stream_routing), which only routes bytes that exist. It matters
// only for corrupt rows whose lengths run past S. Every slot j < B is
// written (0 for j >= count).
#pragma once

#include "vbyte_core.cuh"

namespace svb {

// All 32 lanes of a warp call this. `control` is the block's B/4 control
// bytes, `data` its S data bytes, `slots` the warp's B-slot row in shared
// memory; on return slots[j] holds integer j (uint32, 0 for j >= cnt).
__device__ __forceinline__ void decode_row(const uint8_t* __restrict__ control,
                                           const uint8_t* __restrict__ data,
                                           int S, int cnt, uint32_t* slots,
                                           int B, int lane) {
  const int C = B >> 2;
  int carry = 0;  // data bytes owned by earlier chunks (warp-uniform)
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int ci = c0 + lane;
    const uint32_t ctrl = (ci < C) ? static_cast<uint32_t>(control[ci]) : 0u;
    int len[4];
    int total = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * ci + q;
      len[q] = (ci < C && j < cnt) ? static_cast<int>((ctrl >> (2 * q)) & 3u) + 1 : 0;
      total += len[q];
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(vbyte::kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int pos = carry + incl - total;  // first data byte of integer 4*ci
    if (ci < C) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0u;
        for (int k = 0; k < len[q]; ++k) {
          const int i = pos + k;
          if (i < S) v |= static_cast<uint32_t>(data[i]) << (8 * k);
        }
        slots[4 * ci + q] = v;
        pos += len[q];
      }
    }
    carry += __shfl_sync(vbyte::kFull, incl, 31);
  }
  __syncwarp();
}

// The same values from a row staged in shared memory (kernels 3 and 2):
// `control` holds the block's B/4 control bytes, `data` is 16-byte aligned
// and holds the S data bytes followed by at least 8 zero bytes. Lane l
// reads control byte l of each 32-byte chunk, one warp scan gives its
// four integers' data offsets (as decode_row), and each integer is cut
// from the 8-byte window of the staged row at its offset: two 32-bit
// words, one funnel shift, a mask of its length. Bytes at or past S are
// the zero padding, so they add nothing; an integer whose offset is at or
// past S (a corrupt row's lengths run past S) reads nothing and is 0. The
// lane stores its four slots with one 16-byte store (B % 4 == 0).
__device__ __forceinline__ void decode_staged_row(const uint8_t* control,
                                                  const uint8_t* data, int S,
                                                  int cnt, uint32_t* slots,
                                                  int B, int lane) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(data);
  const int C = B >> 2;
  int carry = 0;  // data bytes owned by earlier chunks (warp-uniform)
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int ci = c0 + lane;
    const uint32_t ctrl = (ci < C) ? static_cast<uint32_t>(control[ci]) : 0u;
    int len[4];
    int total = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * ci + q;
      len[q] = (ci < C && j < cnt)
                   ? static_cast<int>((ctrl >> (2 * q)) & 3u) + 1
                   : 0;
      total += len[q];
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(vbyte::kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int pos = carry + incl - total;  // first data byte of integer 4*ci
    if (ci < C) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = 0u;
        if (len[q] != 0 && pos < S) {
          const int i = pos >> 2;
          x = __funnelshift_r(words[i], words[i + 1], (pos & 3) * 8);
          if (len[q] < 4) x &= (1u << (8 * len[q])) - 1u;
        }
        v[q] = x;
        pos += len[q];
      }
      *reinterpret_cast<uint4*>(slots + 4 * ci) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    carry += __shfl_sync(vbyte::kFull, incl, 31);
  }
  __syncwarp();
}

}  // namespace svb
