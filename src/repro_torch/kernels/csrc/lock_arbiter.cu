// Lock-CAS arbitration for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lock_arbiter.py, `lock_arbiter` (Pallas body
// `_kernel`), reached from repro.kernels.ops.cas_arbitrate.
//
// Computes, per group g and request i:
//   won[g,i] = active[g,i] && !exists j: active[g,j] && keys[g,j] == keys[g,i]
//                                      && (hi[g,j], lo[g,j]) < (hi[g,i], lo[g,i])
// with signed int32 words compared lexicographically and no index tiebreak:
// exact ties leave several winners, as repro.core.arbiter.scatter_min_winner.
//
// What bounds it on this card: nothing of the card's.  The function needs one
// pass over its 14 bytes per request (three int32 words and a bool in, a bool
// out): 6.7 KB at the NOWAIT path's M = 480, 33.6 KB at MVCC's M = 2400, well
// under a microsecond at 3.35 TB/s.  The launch and the block's few
// synchronisations (a few microseconds) are the practical floor; the engine
// launches it once per tick.
//
// Design: the per-key minimum is a hash table, so the work is O(M), not the
// Pallas tile's all-pairs O(M^2).  Each priority packs into one 64-bit word,
//   pack(hi, lo) = ((uint64)((uint32)hi ^ 0x80000000) << 32) | ((uint32)lo ^ 0x80000000),
// whose unsigned order is the signed lexicographic order of (hi, lo).  A slot
// holds a key word (0 = empty, else 1 << 32 | (uint32)key: no int32 key can
// look empty) and the complement of the smallest packed priority seen, kept
// with a 64-bit atomicMax, so that a table of zeros starts empty.  Pass 1:
// each active request finds or claims its key's slot (atomicCAS, linear
// probing from a multiplicative hash's high bits) and folds its priority in.
// Requests are not combined within a warp first: both main paths spread their
// keys (SmallBank sends 25 % of accesses to 100 hot accounts, YCSB 10 % to 0.1 %
// of the records), and a slot that many requests hit costs no more than spread
// ones (PERF.md section 6).  Pass 2: a request wins iff it is active and its
// packed priority equals its slot's minimum; equal words are exact ties,
// which all win.  The table has a power-of-two size of at least 2*M slots
// (16 bytes each).
//   * M <= kSharedMaxM: one block of up to 1024 threads per group, the table
//     in dynamic shared memory (128 KB at M = 2400), one launch.  Each thread
//     loads its (at most kPer) requests once, up front, and keeps their slots
//     in registers for pass 2.  Both main paths (M = 480, 2400) take this path.
//   * larger M: the table lives in global scratch that the wrapper allocates
//     (rt_lock_arbiter_scratch_words says how much); the entry point zeroes it, then an insert launch
//     and a decide launch run over (ceil(M / 256), G) blocks.  Still O(M).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSharedMaxM = 4096;  // 2 * M rounds up to 8192 slots: 128 KB of shared memory
constexpr int kSharedBlock = 1024;
constexpr int kPer = kSharedMaxM / kSharedBlock;  // requests per thread on the shared path
constexpr int kGlobalBlock = 256;

__host__ __device__ __forceinline__ int table_slots(int M) {
  int t = 64;  // a power of two >= 2 * M, at least two warps' worth
  while (t < 2 * M) t <<= 1;
  return t;
}

__device__ __forceinline__ int hash_shift(int T) { return 32 - (31 - __clz(T)); }

__device__ __forceinline__ uint64_t pack_prio(int32_t hi, int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi) ^ 0x80000000u) << 32) |
         (static_cast<uint32_t>(lo) ^ 0x80000000u);
}

__device__ __forceinline__ uint64_t key_word(int32_t key) {
  return (1ull << 32) | static_cast<uint32_t>(key);
}

__device__ __forceinline__ uint32_t slot_of(int32_t key, int shift) {
  return (static_cast<uint32_t>(key) * 0x9E3779B1u) >> shift;  // multiplicative hash, high bits
}

// The slot of key word kw: found, or claimed if empty (linear probing).
__device__ __forceinline__ uint32_t claim(unsigned long long* tkey, uint64_t kw, int32_t key, int shift,
                                         uint32_t mask) {
  uint32_t s = slot_of(key, shift);
  while (true) {
    const unsigned long long prev = atomicCAS(&tkey[s], 0ull, static_cast<unsigned long long>(kw));
    if (prev == 0ull || prev == kw) return s;
    s = (s + 1) & mask;
  }
}

// The slot of key word kw, which pass 1 inserted.
__device__ __forceinline__ uint32_t find(const unsigned long long* tkey, uint64_t kw, int32_t key, int shift,
                                         uint32_t mask) {
  uint32_t s = slot_of(key, shift);
  while (tkey[s] != kw) s = (s + 1) & mask;
  return s;
}

// Pass 1 for one active request: finds or claims the slot of its key word kw and
// folds in inv, its complemented packed priority.  Returns the slot.
__device__ __forceinline__ uint32_t insert(unsigned long long* tkey, unsigned long long* tval, uint64_t kw,
                                           int32_t key, uint64_t inv, int shift, uint32_t mask) {
  const uint32_t s = claim(tkey, kw, key, shift, mask);
  atomicMax(&tval[s], static_cast<unsigned long long>(inv));
  return s;
}

__global__ void __launch_bounds__(kSharedBlock)
lock_arbiter_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ hi,
                    const int32_t* __restrict__ lo, const uint8_t* __restrict__ active,
                    uint8_t* __restrict__ won, int M) {
  extern __shared__ unsigned long long table[];
  const int T = table_slots(M);
  unsigned long long* tkey = table;
  unsigned long long* tval = table + T;
  const int shift = hash_shift(T);
  const uint32_t mask = static_cast<uint32_t>(T - 1);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * M;
  int32_t k[kPer];
  uint64_t inv[kPer];
  bool act[kPer];
  uint32_t slot[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {  // every load in flight before the table is cleared
    const int i = threadIdx.x + r * blockDim.x;
    const bool in = i < M;
    act[r] = in && active[base + i] != 0;
    k[r] = in ? keys[base + i] : 0;
    inv[r] = ~pack_prio(in ? hi[base + i] : 0, in ? lo[base + i] : 0);
  }
  for (int s = threadIdx.x; s < 2 * T; s += blockDim.x) table[s] = 0ull;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    slot[r] = act[r] ? insert(tkey, tval, key_word(k[r]), k[r], inv[r], shift, mask) : 0u;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i < M) won[base + i] = act[r] && tval[slot[r]] == inv[r];
  }
}

__global__ void __launch_bounds__(kGlobalBlock)
lock_arbiter_kernel_global_insert(const int32_t* __restrict__ keys, const int32_t* __restrict__ hi,
                           const int32_t* __restrict__ lo, const uint8_t* __restrict__ active,
                           unsigned long long* __restrict__ scratch, int M, int T) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * M;
  unsigned long long* tkey = scratch + static_cast<int64_t>(blockIdx.y) * 2 * T;
  const int i = blockIdx.x * kGlobalBlock + threadIdx.x;
  if (i >= M || !active[base + i]) return;
  const int32_t key = keys[base + i];
  insert(tkey, tkey + T, key_word(key), key, ~pack_prio(hi[base + i], lo[base + i]), hash_shift(T),
         static_cast<uint32_t>(T - 1));
}

__global__ void __launch_bounds__(kGlobalBlock)
lock_arbiter_kernel_global_decide(const int32_t* __restrict__ keys, const int32_t* __restrict__ hi,
                           const int32_t* __restrict__ lo, const uint8_t* __restrict__ active,
                           const unsigned long long* __restrict__ scratch, uint8_t* __restrict__ won, int M,
                           int T) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * M;
  const unsigned long long* tkey = scratch + static_cast<int64_t>(blockIdx.y) * 2 * T;
  const int i = blockIdx.x * kGlobalBlock + threadIdx.x;
  if (i >= M) return;
  bool w = false;
  if (active[base + i]) {
    const int32_t k = keys[base + i];
    const uint32_t s = find(tkey, key_word(k), k, hash_shift(T), static_cast<uint32_t>(T - 1));
    w = tkey[T + s] == ~pack_prio(hi[base + i], lo[base + i]);
  }
  won[base + i] = w;
}

}  // namespace

// Words of global scratch per group that rt_lock_arbiter needs for M requests: 0 when
// the table fits in shared memory (one launch), else 2 * table_slots(M) (an insert and
// a decide launch).  The wrapper sizes the scratch and counts launches from this.
extern "C" long long rt_lock_arbiter_scratch_words(int M) {
  return M <= kSharedMaxM ? 0ll : 2ll * table_slots(M);
}

// scratch: G * rt_lock_arbiter_scratch_words(M) 64-bit words (zeroed here), or NULL when that is 0.
extern "C" int rt_lock_arbiter(const void* keys, const void* prio_hi, const void* prio_lo,
                               const void* active, void* won, void* scratch, int G, int M, void* stream) {
  if (G <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* h = static_cast<const int32_t*>(prio_hi);
  const auto* l = static_cast<const int32_t*>(prio_lo);
  const auto* a = static_cast<const uint8_t*>(active);
  auto* w = static_cast<uint8_t*>(won);
  const int T = table_slots(M);
  if (M <= kSharedMaxM) {
    static bool configured = false;
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(lock_arbiter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 table_slots(kSharedMaxM) * 16);
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    const int threads = M >= kSharedBlock ? kSharedBlock : ((M + 31) / 32) * 32;
    lock_arbiter_kernel<<<G, threads, static_cast<size_t>(T) * 16, st>>>(k, h, l, a, w, M);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto* tab = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(tab, 0, static_cast<size_t>(G) * 2 * T * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kGlobalBlock - 1) / kGlobalBlock, G);
  lock_arbiter_kernel_global_insert<<<grid, kGlobalBlock, 0, st>>>(k, h, l, a, tab, M, T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lock_arbiter_kernel_global_decide<<<grid, kGlobalBlock, 0, st>>>(k, h, l, a, tab, w, M, T);
  return static_cast<int>(cudaGetLastError());
}
