// Doorbell-batched multi-read (packed row gather) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/multi_read.py, `multi_read` (Pallas body
// `_kernel`), reached from repro.kernels.ops.gather_many.
//
// Computes out[m, a] = table[keys[m], a] for keys in [0, R), and 0 for keys
// outside it (negative padding keys and keys >= R alike), exact int32.
//
// What bounds it on this card: the bytes it must move are the M keys, the
// M gathered rows and the M output rows (for the engine, M = 480 and
// A = 2 or 3: under 10 KB, nanoseconds at 3.35 TB/s), so the launch is the
// whole cost.
//
// Design: one thread per output word, which reads its key and one table
// word.  The TPU kernel streamed the whole table through VMEM and picked
// rows with a one-hot select-and-sum over all R rows; that was the TPU's
// way to gather, and here a direct indexed load replaces it: the kernel
// touches only the rows it needs.  The engine still packs the store arrays
// into one table per call (ops.pack_rows) as the JAX code does; a read from
// several base pointers that skips the repack is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
multi_read_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ keys,
                  int32_t* __restrict__ out, int64_t R, int A, int64_t total) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (w >= total) return;
  const int64_t m = w / A;
  const int a = static_cast<int>(w - m * A);
  const int64_t k = keys[m];
  out[w] = (k >= 0 && k < R) ? table[k * A + a] : 0;
}

}  // namespace

extern "C" int rt_multi_read(const void* table, const void* keys, void* out, long long R, int A,
                             int M, void* stream) {
  const int64_t total = static_cast<int64_t>(M) * A;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((total + kBlock - 1) / kBlock);
  multi_read_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(keys),
      static_cast<int32_t*>(out), R, A, total);
  return static_cast<int>(cudaGetLastError());
}
