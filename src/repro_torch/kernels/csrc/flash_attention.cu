// Blocked online-softmax attention (causal or not) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` (Pallas
// body `_kernel`), reached from repro.kernels.ops.attention_op and
// repro.models.lm._attn_full.
//
// Computes, for q (B, H, Sq, Dh) and k, v (B, H, Sk, Dh), heads already
// GQA-expanded, scale = 1/sqrt(Dh):
//   s[r, c] = scale * <q[r], k[c]>               in float32 (q, k read as float32)
//   s[r, c] = -1e30 where c >= Sk, or causal and c > r   (top-left aligned)
//   o[r]    = sum_c softmax_c(s[r])_c * v[c]     online softmax: float32 m, l, acc
// with p cast to v's dtype before the PV product (as the reference does) and
// the output cast to q's dtype.  Types: float32 and bfloat16; Dh 32, 64, 112
// (kimi-k2's head dim), 128.
//
// What bounds it on this card: the operations.  At the serving shape (B = 4,
// H = 32, S = 2048, Dh = 64, causal, float32) the two products are
// 4*B*H*S^2*Dh/2 = 68.7 GFLOP, 1.03 ms at the 67 TFLOP/s of float32 FMA,
// against 134 MB of q, k, v and o (0.04 ms at 3.35 TB/s).  float32 cannot use
// the tensor cores (TF32 keeps 10 mantissa bits), so the products run as FMAs
// on the CUDA cores, and what stands between a SIMT kernel and that rate is
// its instruction mix: an SM issues 4 warp-instructions a clock and can run 4
// warp-FMAs a clock, so every shared-memory load, shuffle, exp and address
// computation takes a slot from an FMA, and shared memory serves one 128-byte
// wavefront a clock, so a warp-FMA may cost at most a quarter of one.
//
// Design: one block of 256 threads per (128-row q tile, head, batch row), a
// loop over 64-key K/V tiles that stops at the causal diagonal.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 16i (i < 8), keys
// tx + 16j (j < 4) of the 128 x 64 score tile, and the same 8 rows of the
// output at Dh/16 dims (in groups of W adjacent dims: W = 4 where Dh/16 is a
// multiple of 4, 2 where it is even; Dh = 112 gives 7 dims and W = 1, scalar
// V loads, 16 lanes on 16 consecutive floats).  Per 4 steps of d the score
// loop loads 4 K quads and 8 q quads (float4, or 4 bf16 converted at use)
// for 128 FMAs; the PV loop loads 4 V quads and 8 P quads per 4 keys for 128
// FMAs.  Within a warp the q and P loads are broadcasts to each half-warp and
// the K and V loads touch 16 distinct rows, so each load costs one or two
// wavefronts: about 8 FMAs a wavefront, twice what the FMA rate needs.  A row's 64 keys belong to the 16
// lanes of one half-warp, so its max is four xor-shuffles; its sum stays a
// per-thread partial until the end; P goes through shared memory only within
// that half-warp.  Rows are padded by 16 bytes (K, V, q: consecutive rows on
// other banks) and P rows by 16 floats (the two half-warps' rows apart).
// Scores are kept in the log2 domain (scale * log2 e folded into one
// multiply), so each p is one MUFU.EX2.
//
// Pipeline: q, K and V tiles arrive by cp.async 16-byte copies (raw bytes;
// bf16 converts at use), K and V in one buffer each, refilled out of phase:
// V[t] is copied while tile t's scores and softmax run, K[t+1] while its PV
// runs, so a tile takes two block barriers.  That keeps the shared memory at
// 108 KB for Dh = 64 in float32, so 2 blocks (16 warps) share an SM.  Masking runs only on tiles that cross
// the diagonal or Sk.  Blocks are issued heaviest q tile first across all
// heads (the q tile is the grid's slowest axis).  Views whose base or strides
// are not 16-byte aligned take the same loop with plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 128;  // q rows per block
constexpr int kBK = 64;   // keys per streamed tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;  // q rows per thread
constexpr int kCols = kBK / 16;  // keys per thread
constexpr int kPS = kBK + 16;    // P row stride (floats)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // elements; the Dh axis has stride 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// shared-memory row stride of a q, K or V tile, in elements: Dh plus 16 bytes
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() { return DH + 16 / static_cast<int>(sizeof(T)); }

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ + 2 * kBK) * row_stride<T, DH>() * sizeof(T) +
         static_cast<size_t>(kBQ) * kPS * sizeof(float);
}

// W consecutive elements of shared memory as floats (W = 1, 2 or 4)
template <int W>
__device__ __forceinline__ void lds(const float* p, float* x) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float* x) {
  if constexpr (W == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
  } else if constexpr (W == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

// 2^x in one MUFU.EX2 (relative error about 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every cp.async group of this thread but the newest `N` has landed
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Rows row0 .. row0 + ROWS - 1 of a (rows, Dh) view into a padded shared tile:
// 16-byte cp.async copies when the view is aligned, plain loads otherwise; rows
// at or past n are zero (so masked keys meet finite values).
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int row0, int n, bool aligned) {
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = DH / CH;        // chunks per row
  constexpr int RS = row_stride<T, DH>();
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (N % kThreads != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * CH, row = row0 + r;
    T* d = dst + r * RS + c;
    if (row >= n) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* s = src + row * rs + c;
    if (aligned) {
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(s));
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) d[e] = s[e];
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_out(T* p, const float* x, bool vec) {
  if constexpr (std::is_same<T, float>::value && W == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) p[w] = from_f<T>(x[w]);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, DH <= 64 && sizeof(T) == 4 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Sq, int Sk, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale_log2, int causal, int aligned_in, int aligned_out) {
  constexpr int RS = row_stride<T, DH>();
  constexpr int NE = DH / 16;  // output dims per thread
  constexpr int W = NE % 4 == 0 ? 4 : NE % 2 == 0 ? 2 : 1;
  constexpr int NG = NE / W;   // groups of W adjacent dims, 16 * W apart
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + kBQ * RS;
  T* Vs = Ks + kBK * RS;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * RS);

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const bool al = aligned_in != 0;

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  if (n_tiles > 0) {  // Sk = 0: no tile, q is never read and the output is zeros
    load_tile<T, DH, kBQ>(Qs, qb, sq.s, q0, Sq, al);
    load_tile<T, DH, kBK>(Ks, kb, sk.s, 0, Sk, al);
    cp_commit();
  }

  float acc[kRows][NE];
  float m[kRows], l[kRows];  // l: this thread's partial row sums until the end
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NE; ++n) acc[i][n] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    cp_wait<0>();     // this thread's copies of K[t] (and q) have landed
    __syncthreads();  // everyone's have; every warp is done with V[t-1]
    load_tile<T, DH, kBK>(Vs, vb, sv.s, k0, Sk, al);  // lands while the scores run
    cp_commit();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float kk[kCols][4];
#pragma unroll
      for (int j = 0; j < kCols; ++j) lds<4>(Ks + (tx + 16 * j) * RS + d, kk[j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float qq[4];
        lds<4>(Qs + (ty + 16 * i) * RS + d, qq);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qq[e], kk[j][e], s[i][j]);
      }
    }

    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > Sk;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int col = k0 + tx + 16 * j;
          if (col >= Sk || (causal && col > row)) x = kNegInf;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float corr = fast_exp2(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = fast_exp2(s[i][j] - mn);
        ps += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = to_f(from_f<T>(p));  // p in v's dtype for the PV product
      }
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int n = 0; n < NE; ++n) acc[i][n] *= corr;
    }

    cp_wait<0>();     // V[t] has landed
    __syncthreads();  // for every thread; and every warp is done with K[t]
    if (t + 1 < n_tiles) {  // lands while PV runs
      load_tile<T, DH, kBK>(Ks, kb, sk.s, k0 + kBK, Sk, al);
      cp_commit();
    }
#pragma unroll
    for (int c = 0; c < kBK; c += 4) {
      float vv[4][NE];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < NG; ++g) lds<W>(Vs + (c + u) * RS + g * 16 * W + tx * W, &vv[u][g * W]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float pp[4];
        lds<4>(Ps + (ty + 16 * i) * kPS + c, pp);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int n = 0; n < NE; ++n) acc[i][n] = fmaf(pp[u], vv[u][n], acc[i][n]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(li, 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float x[W];
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = acc[i][g * W + w] / den;
      store_out<T, W>(ob + row * so.s + g * 16 * W + tx * W, x, aligned_out != 0);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk, Strides sq,
           Strides sk, Strides sv, Strides so, float scale, int causal, int aligned_in, int aligned_out,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DH>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)  // all of the SM's unified memory that can be shared, so two blocks fit
      e = cudaFuncSetAttribute(flash_attention_kernel<T, DH>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nq = (Sq + kBQ - 1) / kBQ;
  if (B > 65535 || nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B, nq);  // the q tile is the slowest axis: heaviest tiles of every head first
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk,
      sq, sk, sv, so, scale * kLog2e, causal, aligned_in, aligned_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
                Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal, int al_in, int al_out,
                cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, al_in, al_out, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, al_in, al_out, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, al_in, al_out, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, al_in, al_out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a tensor's base and its b, h, s strides are all multiples of 16 bytes
bool aligned16(const void* p, const Strides& s, int esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * esize) % 16 == 0 && (s.h * esize) % 16 == 0 &&
         (s.s * esize) % 16 == 0;
}

}  // namespace

// strides: 12 values, (b, h, s) for q, k, v, o in that order, in elements.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                                  int Sk, int Dh, const long long* strides, float scale, int causal, int bf16,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, so{strides[9], strides[10], strides[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int es = bf16 ? 2 : 4;
  const int al_in = aligned16(q, sq, es) && aligned16(k, sk, es) && aligned16(v, sv, es);
  const int al_out = aligned16(o, so, es);
  if (bf16)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, al_in, al_out, st);
  return dispatch_dh<float>(Dh, q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, al_in, al_out, st);
}
