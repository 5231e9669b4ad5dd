// owner_sum: out[i] = sum over e in [row_offsets[i], row_offsets[i+1]) of
// h[src[e]], edges with src[e] < 0 (masked) skipped, the adds in edge order.
//
// The aggregation of GIN over edges grouped by owner (CSR order). It
// stands for jax.ops.segment_sum in src/repro/nn/gnn.py (gin_layer) and
// src/repro/models/gnn.py (the graph readout), which XLA lowers to a
// scatter-add; the reference has no Pallas kernel there. On the CPU that
// scatter adds in edge order, so summing each owner's edges in edge order
// gives the reference's bits, on every run: no atomics, and no [E, d]
// message tensor. h is read in its own type (f32 or bf16) and widened in
// registers; the sum is f32, or, with round_bf16, rounded to bf16 after
// every add (the reference's bf16 segment_sum on the CPU). Starting from
// +0.0, a skipped edge and an added masked +0.0 give the same bits.
//
// What bounds it on an H100: bytes — one gathered row per valid edge (in
// h's type), src, row_offsets and the output, over 3.35 TB/s. The adds
// are a dependent chain per feature, so a row's only parallelism is its
// width, never a split of the edge list, which would change the order.
//
// What the design does about it: in-degrees are skewed (a power law puts
// ~1% of a large graph's edges on its top owner), so owners are taken
// longest first (`order`, sorted by in-degree on the host side) from a
// counter by persistent CTAs of 8 warps. The top owner's chain of adds is
// the critical path, and one SM gathers scattered rows at only some
// 10-25 GB/s, so an owner of at least LONG_ROW edges (the first n_long of
// `order`) is split by features: each 32-byte slice of its rows (one
// sector) is a task of its own, on its own CTA, the slices of one owner
// consecutive tasks. A slice's rows stream through a ring of kStages
// stages of `chunk` rows in shared memory, its src through a ring twice as
// deep, all by cp.async: a stage's src lands kStages stages before its
// rows are asked for, so no load waits inside the loop; a thread per
// feature adds. Every other owner gets a group of `lanes` lanes (a power
// of 2 covering the row's units; 32 / lanes owners a warp, 8 warps a task)
// that keeps kUnroll rows' loads in flight in registers ahead of the adds,
// the next window's src loads beside them.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 6;
constexpr int kSrcStages = 2 * kStages;
constexpr int kRingBytes = 48 * 1024;
constexpr int kMaxChunk = 256;     // rows a ring stage holds at most
constexpr int kConsumeUnroll = 8;  // staged rows read ahead of the adds
constexpr int kUnroll = 8;         // rows in flight per lane in group mode
constexpr int kSliceBytes = 32;    // a long owner's rows per CTA: a sector
constexpr unsigned kFull = 0xffffffffu;

template <int G>
struct Unit;
template <>
struct Unit<16> {
  using type = uint4;
};
template <>
struct Unit<8> {
  using type = uint2;
};
template <>
struct Unit<4> {
  using type = unsigned int;
};
template <>
struct Unit<2> {
  using type = unsigned short;
};

struct Args {
  const uint8_t* h;        // first feature of row 0 (of this column slice)
  long long ld_bytes;      // row stride of h in bytes
  int units;               // G-byte units of a row slice (<= 256)
  const int* src;          // [E], < 0: a masked edge
  const int* row_offsets;  // [n_owners + 1]
  const int* order;        // [n_owners]: owners, longest first
  const int* n_long;       // [1]: owners with >= LONG_ROW edges
  long long n_owners;
  int lanes;               // group mode: lanes per owner (power of 2)
  uint8_t* out;            // first output element of this column slice
  long long out_ld;        // output row stride in elements
  int* counter;            // task counter, zeroed before the launch
  int slice;               // long mode: units of a task's feature slice
  int chunk;               // long mode: rows per ring stage
};

// 32-bit word k of a unit
__device__ __forceinline__ unsigned word(const uint4& u, int k) {
  return k == 0 ? u.x : (k == 1 ? u.y : (k == 2 ? u.z : u.w));
}
__device__ __forceinline__ unsigned word(const uint2& u, int k) {
  return k == 0 ? u.x : u.y;
}
__device__ __forceinline__ unsigned word(unsigned int u, int) { return u; }
__device__ __forceinline__ unsigned word(unsigned short u, int) {
  return static_cast<unsigned>(u);
}

// The unit's VE elements as f32 (a bf16 is the high half of its f32)
template <typename T, int G>
__device__ __forceinline__ void widen(const typename Unit<G>::type& u,
                                      float* v) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < G / 4; ++k) v[k] = __uint_as_float(word(u, k));
  } else if constexpr (G == 2) {
    v[0] = __uint_as_float(word(u, 0) << 16);
  } else {
#pragma unroll
    for (int k = 0; k < G / 4; ++k) {
      const unsigned w = word(u, k);
      v[2 * k] = __uint_as_float(w << 16);
      v[2 * k + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}

template <bool RB>
__device__ __forceinline__ float add(float acc, float x) {
  const float s = acc + x;
  return RB ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

template <typename T, int G, bool RB>
__device__ __forceinline__ void add_unit(float* acc,
                                         const typename Unit<G>::type& u) {
  constexpr int VE = G / static_cast<int>(sizeof(T));
  float v[VE];
  widen<T, G>(u, v);
#pragma unroll
  for (int i = 0; i < VE; ++i) acc[i] = add<RB>(acc[i], v[i]);
}

template <bool RB>
__device__ __forceinline__ void store1(const Args& a, long long at, float v) {
  if (RB)
    reinterpret_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(a.out)[at] = v;
}

template <int G>
__device__ __forceinline__ typename Unit<G>::type load_unit(const uint8_t* p) {
  return __ldg(reinterpret_cast<const typename Unit<G>::type*>(p));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One G-byte unit from global to shared memory: cp.async (completes at a
// later cp.async.wait_group), or a plain 2-byte load and store for G = 2.
template <int G>
__device__ __forceinline__ void copy_unit(uint8_t* dst, const uint8_t* src) {
  if constexpr (G == 2) {
    *reinterpret_cast<unsigned short*>(dst) = load_unit<2>(src);
  } else if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(G)
                 : "memory");
  }
}

template <int G>
__device__ __forceinline__ void zero_unit(uint8_t* dst) {
  if constexpr (G == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (G == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else if constexpr (G == 4)
    *reinterpret_cast<unsigned*>(dst) = 0u;
  else
    *reinterpret_cast<unsigned short*>(dst) = 0u;
}

__device__ __forceinline__ void copy_int(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element j of a row staged in shared memory, widened to f32.
__device__ __forceinline__ float staged_elem(const float* p) { return *p; }
__device__ __forceinline__ float staged_elem(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

// Units [u0, u0 + nu) of a long owner: the whole CTA, the slice of each row
// through the ring (`ring`, kStages stages of C rows), its src through
// `s_src` (kSrcStages stages). Groups of copies, one committed a stage:
// rows of stage s + kStages - 1 and src of stage s + 2·kStages - 1 while
// stage s is added, a thread per feature, kConsumeUnroll staged rows read
// ahead of the adds, which need no test (masked slots hold zeros); two
// barriers a stage.
template <typename T, int G, bool RB>
__device__ void long_row(const Args& a, int owner, int u0, int nu,
                         uint8_t* ring, int (*s_src)[kMaxChunk]) {
  const int tid = threadIdx.x;
  const int C = a.chunk;
  const int row_bytes = nu * G;  // of the slice, in the ring
  const int n_elems = nu * G / static_cast<int>(sizeof(T));
  const uint8_t* h = a.h + static_cast<long long>(u0) * G;
  const int e0 = a.row_offsets[owner], e1 = a.row_offsets[owner + 1];
  const int n = e1 - e0;
  const int nchunks = (n + C - 1) / C;
  auto fetch_src = [&](int s) {  // stage s's src, the edges past e1 left
    if (s < nchunks && tid < C && e0 + s * C + tid < e1)
      copy_int(&s_src[s % kSrcStages][tid], a.src + e0 + s * C + tid);
  };
  // stage s's rows (its src has landed); a masked edge's slot, and the
  // slots past the last edge, are zeroed: the adds then take +0.0 there,
  // the same bits as skipping it (the sum starts at +0.0 and so is never
  // -0.0), and need no test
  auto issue = [&](int s) {
    if (s >= nchunks) return;
    const int* sv = s_src[s % kSrcStages];
    const int m = min(C, n - s * C);
    uint8_t* dst = ring + static_cast<size_t>(s % kStages) * C * row_bytes;
    for (int p = tid; p < C * nu; p += kThreads) {
      const int j = p / nu, u = p - j * nu;
      uint8_t* d = dst + j * row_bytes + u * G;
      if (j < m && sv[j] >= 0)
        copy_unit<G>(d, h + static_cast<long long>(sv[j]) * a.ld_bytes +
                            u * G);
      else
        zero_unit<G>(d);
    }
  };
  for (int s = 0; s < kStages; ++s) fetch_src(s);
  commit();
  wait_groups<0>();
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    fetch_src(s + kStages);
    commit();
  }
  float acc = 0.0f;  // thread tid sums element tid of the slice
  const int stride = row_bytes / static_cast<int>(sizeof(T));
  for (int k = 0; k < nchunks; ++k) {
    wait_groups<kStages - 2>();
    __syncthreads();  // rows of stage k and src of stage k + kStages - 1
    issue(k + kStages - 1);
    fetch_src(k + 2 * kStages - 1);
    commit();
    if (tid < n_elems) {
      const T* rows = reinterpret_cast<const T*>(
                          ring + static_cast<size_t>(k % kStages) * C *
                                     row_bytes) +
                      tid;
      const int m = min(C, n - k * C);
      // C % kConsumeUnroll == 0, and the slots past m hold zeros
      for (int j0 = 0; j0 < m; j0 += kConsumeUnroll) {
        float v[kConsumeUnroll];
#pragma unroll
        for (int q = 0; q < kConsumeUnroll; ++q)
          v[q] = staged_elem(rows + (j0 + q) * stride);
#pragma unroll
        for (int q = 0; q < kConsumeUnroll; ++q) acc = add<RB>(acc, v[q]);
      }
    }
    __syncthreads();  // stage k's rows and src slots are free again
  }
  wait_groups<0>();
  if (tid < n_elems)
    store1<RB>(a,
               static_cast<long long>(owner) * a.out_ld +
                   static_cast<long long>(u0) * (G / sizeof(T)) + tid,
               acc);
}

// Short owners: `lanes` lanes each, 32 / lanes a warp, from order[first].
template <typename T, int G, bool RB>
__device__ void group_rows(const Args& a, long long first) {
  constexpr int VE = G / static_cast<int>(sizeof(T));
  using U = typename Unit<G>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.lanes;
  const int sub = lane / L, sl = lane - sub * L;
  const long long idx = first + static_cast<long long>(warp) * (32 / L) + sub;
  if (idx >= a.n_owners) return;  // the whole group: its mask holds
  const unsigned mask = L == 32 ? kFull : ((1u << L) - 1u) << (sub * L);
  const int owner = a.order[idx];
  const int e0 = a.row_offsets[owner], e1 = a.row_offsets[owner + 1];
  for (int u0 = 0; u0 < a.units; u0 += L) {
    const int u = u0 + sl;
    const bool act = u < a.units;
    float acc[VE];
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] = 0.0f;
    int my_src = e0 + sl < e1 ? a.src[e0 + sl] : -1;
    for (int base = e0; base < e1; base += L) {
      const int m = min(L, e1 - base);
      const int cur_src = my_src;
      // the next window's src, in flight during this window's rows
      my_src = base + L + sl < e1 ? a.src[base + L + sl] : -1;
      for (int j0 = 0; j0 < m; j0 += kUnroll) {
        U buf[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const int s = __shfl_sync(mask, cur_src, (j0 + i) & (L - 1), L);
          ok[i] = j0 + i < m && s >= 0 && act;
          if (ok[i])
            buf[i] = load_unit<G>(a.h + static_cast<long long>(s) * a.ld_bytes +
                                  static_cast<long long>(u) * G);
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i)
          if (ok[i]) add_unit<T, G, RB>(acc, buf[i]);
      }
    }
    if (act)
#pragma unroll
      for (int i = 0; i < VE; ++i)
        store1<RB>(a,
                   static_cast<long long>(owner) * a.out_ld +
                       static_cast<long long>(u) * VE + i,
                   acc[i]);
  }
}

template <typename T, int G, bool RB>
__global__ void __launch_bounds__(kThreads)
    owner_sum_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int s_task;
  __shared__ __align__(16) int s_src[kSrcStages][kMaxChunk];
  const long long n_long = *a.n_long;
  const int slices = (a.units + a.slice - 1) / a.slice;
  const long long long_tasks = n_long * slices;
  const long long per_task = static_cast<long long>(kWarps) * (32 / a.lanes);
  const long long total =
      long_tasks + (a.n_owners - n_long + per_task - 1) / per_task;
  for (;;) {
    if (threadIdx.x == 0) s_task = atomicAdd(a.counter, 1);
    __syncthreads();
    const long long t = s_task;
    __syncthreads();
    if (t >= total) return;
    if (t < long_tasks) {
      // the slices of one owner are consecutive tasks: on as many CTAs
      const int u0 = static_cast<int>(t % slices) * a.slice;
      long_row<T, G, RB>(a, a.order[t / slices], u0,
                         min(a.slice, a.units - u0), ring, s_src);
    } else {
      group_rows<T, G, RB>(a, n_long + (t - long_tasks) * per_task);
    }
  }
}

template <typename T, int G, bool RB>
int launch(Args a, cudaStream_t stream) {
  a.slice = kSliceBytes / G;
  const int row_bytes = (a.slice < a.units ? a.slice : a.units) * G;
  int C = kRingBytes / (kStages * row_bytes);
  C = C > kMaxChunk ? kMaxChunk : C;
  C = C < kConsumeUnroll ? kConsumeUnroll : C - C % kConsumeUnroll;
  a.chunk = C;
  const size_t smem = static_cast<size_t>(kStages) * C * row_bytes;
  auto kern = owner_sum_kernel<T, G, RB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  if ((e = cudaMemsetAsync(a.counter, 0, sizeof(int), stream)) != cudaSuccess)
    return static_cast<int>(e);
  kern<<<n_sm * per_sm, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RB>
int launch_gran(const Args& a, int gran, cudaStream_t stream) {
  switch (gran) {
    case 16:
      return launch<T, 16, RB>(a, stream);
    case 8:
      return launch<T, 8, RB>(a, stream);
    case 4:
      return launch<T, 4, RB>(a, stream);
    default:
      if constexpr (sizeof(T) == 2) return launch<T, 2, RB>(a, stream);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// h: the first feature of this column slice; ld: h's row stride in
// elements; d: the slice's width; gran: bytes per unit (16, 8, 4, or 2 for
// bf16), dividing h's address, its row stride in bytes and d's bytes.
extern "C" int owner_sum_launch(const void* h, long long ld, int d,
                                int h_bf16, int gran, const void* src,
                                const void* row_offsets, const void* order,
                                const void* n_long, long long n_owners,
                                int lanes, void* out, long long out_ld,
                                int round_bf16, void* counter, void* stream) {
  if (n_owners <= 0 || d <= 0) return 0;
  const int es = h_bf16 ? 2 : 4;
  Args a;
  a.h = static_cast<const uint8_t*>(h);
  a.ld_bytes = ld * es;
  a.units = d * es / gran;
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.order = static_cast<const int*>(order);
  a.n_long = static_cast<const int*>(n_long);
  a.n_owners = n_owners;
  a.lanes = lanes;
  a.out = static_cast<uint8_t*>(out);
  a.out_ld = out_ld;
  a.counter = static_cast<int*>(counter);
  a.slice = 1;
  a.chunk = 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return round_bf16 ? launch_gran<__nv_bfloat16, true>(a, gran, st)
                      : launch_gran<__nv_bfloat16, false>(a, gran, st);
  return round_bf16 ? launch_gran<float, true>(a, gran, st)
                    : launch_gran<float, false>(a, gran, st);
}

extern "C" const char* owner_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
