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
// the output cast to q's dtype.  Types: float32 and bfloat16; Dh 32, 64, 128.
//
// What bounds it on this card: the operations.  At the serving shape (B = 4,
// H = 32, S = 2048, Dh = 64, causal, float32) the two products are
// 4*B*H*S^2*Dh/2 = 68.7 GFLOP, 1.03 ms at the 67 TFLOP/s of float32 FMA,
// against 134 MB of q, k, v and o (0.04 ms at 3.35 TB/s).  float32 cannot use
// the tensor cores (TF32 keeps 10 mantissa bits), so the products run as FMAs
// on the CUDA cores.
//
// Design: one block of 256 threads per (64-row q tile, head, batch row).  The
// q tile sits in shared memory; a loop streams 64-row K/V tiles through shared
// memory (K transposed, so a thread reads its four key columns as one float4)
// and stops at the causal diagonal, so tiles above it are never loaded.  Each
// thread owns a 4x4 block of the 64x64 score tile and the same four rows of
// the output: the 16 threads of a half-warp share their rows, so a row's max
// and sum are four xor-shuffles, and P goes through shared memory only within
// that half-warp.  Blocks start with the last q tile, whose causal work is the
// largest.  Inputs may be strided views (the LM's (B, S, H, Dh) projections
// transposed to (B, H, S, Dh)) as long as Dh is contiguous.  No wgmma, TMA or
// cp.async pipelining yet: the loads of a tile wait for the tile before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per streamed tile
constexpr int kThreads = 256;
constexpr int kPad = 4;  // row padding (floats): spreads the banks, keeps float4 alignment
constexpr float kNegInf = -1e30f;

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

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + kPad) + DH * (kBK + kPad) + kBK * (DH + kPad) + kBQ * (kBK + kPad);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Sq, int Sk, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal) {
  constexpr int QS = DH + kPad;   // Qs row stride
  constexpr int KS = kBK + kPad;  // Kt row stride (Kt is [DH][KS])
  constexpr int VS = DH + kPad;   // Vs row stride
  constexpr int PS = kBK + kPad;  // Ps row stride
  constexpr int NV = DH / 16;     // output columns per thread
  constexpr int VW = NV < 4 ? NV : 4;
  constexpr int NG = NV / VW;     // column groups of VW adjacent columns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kt = Qs + kBQ * QS;
  float* Vs = Kt + DH * KS;
  float* Ps = Vs + kBK * VS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, row = q0 + r;
    Qs[r * QS + d] = row < Sq ? to_f(qb[row * sq.s + d]) : 0.f;
  }

  float acc[4][NV];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and Qs is loaded)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH, col = k0 + c;
      const bool in = col < Sk;
      Kt[d * KS + c] = in ? to_f(kb[col * sk.s + d]) : 0.f;
      Vs[c * VS + d] = in ? to_f(vb[col * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 kv = *reinterpret_cast<const float4*>(&Kt[(d + dd) * KS + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qd = comp(qv[i], dd);
          s[i][0] = fmaf(qd, kv.x, s[i][0]);
          s[i][1] = fmaf(qd, kv.y, s[i][1]);
          s[i][2] = fmaf(qd, kv.z, s[i][2]);
          s[i][3] = fmaf(qd, kv.w, s[i][3]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < Sk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        s[i][j] = to_f(from_f<T>(p));  // p in v's dtype for the PV product
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] *= corr;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * PS + tx * 4]) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncwarp();  // a half-warp reads only the P rows it wrote

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* vr = &Vs[c * VS + g * 16 * VW + tx * VW];
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vv[0] = t.x, vv[1] = t.y;
        }
#pragma unroll
        for (int e = 0; e < VW; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][g * VW + e] = fmaf(p[i], vv[e], acc[i][g * VW + e]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        ob[row * so.s + g * 16 * VW + tx * VW + e] = from_f<T>(acc[i][g * VW + e] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk, Strides sq,
           Strides sk, Strides sv, Strides so, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk,
      sq, sk, sv, so, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
                Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (bf16) return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, st);
  return dispatch_dh<float>(Dh, q, k, v, o, B, H, Sq, Sk, sq, sk, sv, so, scale, causal, st);
}
