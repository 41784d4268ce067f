// MVCC version read (the wts gather fused with the Cond R1 slot pick and the
// Cond R2 lock check) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mvcc_version_select.py, `mvcc_version_select`
// (Pallas body `_kernel`), reached from repro.kernels.ops.version_select,
// together with the repro.kernels.ops.gather_many calls that feed it.
//
// Computes, per op row m over its S version slots (signed int32 words,
// pairs compared lexicographically), with row r = keys[m] when keys are
// given (the store's (R, S) wts arrays and (R,) lock words, a key outside
// [0, R) reading zero words: every slot empty, the lock free) and r = m when
// they are not (wts are the op rows themselves, lock words per op), and
// ctts shared by the K consecutive ops of one transaction (t = m / K):
//   found[m] = exists s: (0,0) != wts[r,s] < ctts[t]
//   slot[m]  = the first s whose wts[r,s] is the largest such pair, else 0
//   ok[m]    = lock[r] == (0,0) || ctts[t] < lock[r]   (when a lock is given)
//   rows[m]  = wts[r, :]                                 (when asked for)
//
// What bounds it on this card: the bytes.  At the engine's shape (M = N*K =
// 2400 ops, N = 240, S = 4) one call reads 2400 keys, 2400 x 8 wts words,
// 2400 x 2 lock words and 240 ctts pairs and writes 2400 x (8 words + 6
// bytes): about 199 KB, 59 ns at 3.35 TB/s.  So the launch and one chain of
// dependent loads (key, then row) are the whole cost.  Before this kernel
// the engine gathered the wts rows and the lock pair in two launches (each
// after concatenating the whole store arrays into a packed table), copied
// the gathered column views, expanded ctts to one word per op and filled a
// zero lock where there was none: up to 11 launches and 10 MB of copies at
// paper scale for one pick.  One launch now does it all, reading the store
// in place.
//
// Design: one thread per op row.  It reads its key, then its ctts pair and
// lock words through the read-only path while its S slots arrive: 16-byte
// int4 loads when S is a multiple of 4 and the rows are 16-byte aligned (the
// paper's S = 4), scalar words otherwise (the slot-count ablation takes S
// from 1 to 16).  The pick is a loop over the slots whose strictly-greater
// update keeps the first index among tied winners, as the reference's argmax
// does.  The gathered rows go out with the same 16-byte stores.  Nothing is
// padded: the last block masks its ragged edge.  Tensor cores, TMA and
// shared memory have nothing to do here and are not used.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 128;

struct Params {
  const int32_t* wts_hi;
  const int32_t* wts_lo;
  int64_t stride;         // words between consecutive wts rows
  const int32_t* keys;    // nullptr: row m is row m
  int64_t R;              // rows of wts and lock when keys are given
  const int32_t* ctts_hi;
  const int32_t* ctts_lo;
  int K;                  // ops per ctts pair
  const int32_t* lock_hi;  // nullptr: no Cond R2
  const int32_t* lock_lo;
  uint8_t* found;
  int32_t* slot;
  uint8_t* ok;
  int32_t* rows_hi;       // nullptr: the gathered rows are not written
  int32_t* rows_lo;
  int64_t M;
  int S;
  int vec_in;             // 1: 16-byte wts loads
  int vec_out;            // 1: 16-byte row stores
};

__device__ __forceinline__ bool lex_lt(int32_t ah, int32_t al, int32_t bh, int32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

struct Pick {
  int32_t ch, cl, bh = 0, bl = 0;
  int best = 0;
  bool any = false;

  __device__ __forceinline__ void visit(int s, int32_t h, int32_t l) {
    const bool cand = lex_lt(h, l, ch, cl) && (h != 0 || l != 0);
    if (cand && (!any || lex_lt(bh, bl, h, l))) {
      any = true;
      bh = h;
      bl = l;
      best = s;
    }
  }
};

__global__ void __launch_bounds__(kBlock)
mvcc_version_select_kernel(const Params p) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (m >= p.M) return;
  int64_t r = m;
  bool inside = true;
  if (p.keys != nullptr) {
    const int64_t k = __ldg(p.keys + m);
    inside = k >= 0 && k < p.R;
    r = inside ? k : 0;
  }
  const int64_t t = m / p.K;
  Pick pick;
  pick.ch = __ldg(p.ctts_hi + t);
  pick.cl = __ldg(p.ctts_lo + t);
  int32_t lh = 0, ll = 0;
  if (p.lock_hi != nullptr && inside) {
    lh = __ldg(p.lock_hi + r);
    ll = __ldg(p.lock_lo + r);
  }
  const int S = p.S;
  const int32_t* wh = p.wts_hi + r * p.stride;
  const int32_t* wl = p.wts_lo + r * p.stride;
  int32_t* oh = p.rows_hi == nullptr ? nullptr : p.rows_hi + m * S;
  int32_t* ol = p.rows_lo == nullptr ? nullptr : p.rows_lo + m * S;
  if (p.vec_in) {
    for (int c = 0; c < S / 4; ++c) {
      const int4 zero = make_int4(0, 0, 0, 0);
      const int4 h = inside ? __ldg(reinterpret_cast<const int4*>(wh) + c) : zero;
      const int4 l = inside ? __ldg(reinterpret_cast<const int4*>(wl) + c) : zero;
      if (oh != nullptr) {
        if (p.vec_out) {
          reinterpret_cast<int4*>(oh)[c] = h;
          reinterpret_cast<int4*>(ol)[c] = l;
        } else {
          oh[4 * c] = h.x, oh[4 * c + 1] = h.y, oh[4 * c + 2] = h.z, oh[4 * c + 3] = h.w;
          ol[4 * c] = l.x, ol[4 * c + 1] = l.y, ol[4 * c + 2] = l.z, ol[4 * c + 3] = l.w;
        }
      }
      pick.visit(4 * c, h.x, l.x);
      pick.visit(4 * c + 1, h.y, l.y);
      pick.visit(4 * c + 2, h.z, l.z);
      pick.visit(4 * c + 3, h.w, l.w);
    }
  } else {
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const int32_t h = inside ? __ldg(wh + s) : 0;
      const int32_t l = inside ? __ldg(wl + s) : 0;
      if (oh != nullptr) {
        oh[s] = h;
        ol[s] = l;
      }
      pick.visit(s, h, l);
    }
  }
  p.found[m] = pick.any;
  p.slot[m] = pick.best;
  if (p.ok != nullptr) p.ok[m] = (lh == 0 && ll == 0) || lex_lt(pick.ch, pick.cl, lh, ll);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// keys, lock_hi/lock_lo, ok and rows_hi/rows_lo may be NULL (see Params).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// S < 1, K < 1 or a lock, ok or rows pointer given without its partner).
extern "C" int rt_mvcc_version_read(const void* wts_hi, const void* wts_lo, long long stride,
                                    const void* keys, long long R, const void* ctts_hi,
                                    const void* ctts_lo, int K, const void* lock_hi,
                                    const void* lock_lo, void* found, void* slot, void* ok,
                                    void* rows_hi, void* rows_lo, long long M, int S,
                                    void* stream) {
  if (S < 1 || K < 1 || (lock_hi == nullptr) != (lock_lo == nullptr) ||
      (lock_hi == nullptr) != (ok == nullptr) || (rows_hi == nullptr) != (rows_lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.wts_hi = static_cast<const int32_t*>(wts_hi);
  p.wts_lo = static_cast<const int32_t*>(wts_lo);
  p.stride = stride;
  p.keys = static_cast<const int32_t*>(keys);
  p.R = R;
  p.ctts_hi = static_cast<const int32_t*>(ctts_hi);
  p.ctts_lo = static_cast<const int32_t*>(ctts_lo);
  p.K = K;
  p.lock_hi = static_cast<const int32_t*>(lock_hi);
  p.lock_lo = static_cast<const int32_t*>(lock_lo);
  p.found = static_cast<uint8_t*>(found);
  p.slot = static_cast<int32_t*>(slot);
  p.ok = static_cast<uint8_t*>(ok);
  p.rows_hi = static_cast<int32_t*>(rows_hi);
  p.rows_lo = static_cast<int32_t*>(rows_lo);
  p.M = M;
  p.S = S;
  p.vec_in = S % 4 == 0 && stride % 4 == 0 && aligned16(wts_hi) && aligned16(wts_lo);
  p.vec_out = rows_hi != nullptr && S % 4 == 0 && aligned16(rows_hi) && aligned16(rows_lo);
  const unsigned blocks = static_cast<unsigned>((M + kBlock - 1) / kBlock);
  mvcc_version_select_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
