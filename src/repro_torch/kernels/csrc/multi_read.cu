// Doorbell-batched multi-read (a multi-pointer row gather) for NVIDIA Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/multi_read.py, `multi_read` (Pallas body
// `_kernel`), reached from repro.kernels.ops.gather_many.
//
// Computes, for up to kMaxArrays store arrays that share R rows, each one
// flattened to (R, w_a) int32 and read where it lies, and one batch of
// keys (M,):
//   out_a[m, :] = arr_a[keys[m], :]   for keys in [0, R),
//   out_a[m, :] = 0                   for keys outside it,
// exact int32, each array into its own contiguous (M, w_a) output.  The
// one-array case is the TPU kernel's packed-table gather.
//
// What bounds it on this card: the bytes it must move are the M keys, the M
// rows read and the M rows written, for the engine's calls (M = 480 or 2400,
// sum of widths 2 to 9 words) under 200 KB: tens of nanoseconds at
// 3.35 TB/s.  So the launch and one chain of dependent loads (key, then row)
// are the whole cost, and the design removes work around the kernel rather
// than inside it.  The TPU kernel read one packed table, so the engine
// concatenated the whole store arrays into it on every call (up to 8 MB per
// call at paper scale); here the arrays' base pointers, widths and output
// pointers ride in one small struct passed by value as a kernel parameter,
// so one launch reads every array in place and nothing is copied first.
//
// Design: one thread per (row, array), the array from blockIdx.y.  The
// thread reads its key once (read-only path), then issues all of its row's
// loads before any store, so they are in flight together: 16-byte int4
// loads and stores where the width is a multiple of 4 words and both base
// pointers are 16-byte aligned (the MVCC wts rows, 4 words, and YCSB
// records, 16), scalar words elsewhere.  Neighbouring threads write
// neighbouring rows, so a warp's stores cover one contiguous span.  The
// block size suits M = 480 and 2400: 4 or 19 blocks per array, one wave far
// below the 132 SMs.  Tensor cores, TMA and shared memory have nothing to
// do in a gather of a few rows and are not used.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxArrays = 8;
constexpr int kBatch = 4;  // int4 chunks (or scalar words x 4) in flight per thread

struct Arrays {
  const int32_t* src[kMaxArrays];
  int32_t* dst[kMaxArrays];
  int width[kMaxArrays];  // words per row
  int vec[kMaxArrays];    // 1: 16-byte loads and stores
};

__global__ void __launch_bounds__(kBlock)
multi_read_kernel(const Arrays arrays, const int32_t* __restrict__ keys, int64_t R, int M) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (m >= M) return;
  // this block's array: constant indices into the parameter struct (a dynamic
  // index would copy the struct to the stack), selected by the uniform blockIdx.y
  const int32_t* base = nullptr;
  int32_t* out = nullptr;
  int w = 0, vec = 0;
#pragma unroll
  for (int i = 0; i < kMaxArrays; ++i) {
    if (i == static_cast<int>(blockIdx.y)) {
      base = arrays.src[i];
      out = arrays.dst[i];
      w = arrays.width[i];
      vec = arrays.vec[i];
    }
  }
  const int64_t k = __ldg(keys + m);
  const bool inside = k >= 0 && k < R;
  const int32_t* src = base + (inside ? k : 0) * w;
  int32_t* dst = out + m * w;
  if (vec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const int n = w >> 2;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = (inside && j0 + j < n) ? __ldg(s + j0 + j) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (j0 + j < n) d[j0 + j] = v[j];
    }
  } else {
    for (int j0 = 0; j0 < w; j0 += kBatch) {
      int32_t v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) v[j] = (inside && j0 + j < w) ? __ldg(src + j0 + j) : 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (j0 + j < w) dst[j0 + j] = v[j];
    }
  }
}

}  // namespace

// srcs/dsts: n host-side arrays of device pointers; widths: n words per row.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// more than kMaxArrays arrays or a negative width).
extern "C" int rt_multi_read_many(const void* const* srcs, void* const* dsts, const int* widths,
                                  int n, const void* keys, long long R, int M, void* stream) {
  if (n < 0 || n > kMaxArrays) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || M <= 0) return static_cast<int>(cudaSuccess);
  Arrays arrays = {};
  for (int a = 0; a < n; ++a) {
    if (widths[a] < 0) return static_cast<int>(cudaErrorInvalidValue);
    arrays.src[a] = static_cast<const int32_t*>(srcs[a]);
    arrays.dst[a] = static_cast<int32_t*>(dsts[a]);
    arrays.width[a] = widths[a];
    arrays.vec[a] = widths[a] % 4 == 0 && reinterpret_cast<uintptr_t>(srcs[a]) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dsts[a]) % 16 == 0;
  }
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(M) + kBlock - 1) / kBlock), static_cast<unsigned>(n));
  multi_read_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      arrays, static_cast<const int32_t*>(keys), R, M);
  return static_cast<int>(cudaGetLastError());
}

