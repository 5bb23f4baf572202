// Flash-decode GQA attention: one query token against a KV cache.
//
// Replaces the TPU kernel `flash_decode_padded` / `_flash_decode_kernel` in
// src/repro/kernels/flash_decode.py.  For q (B, Hq, D) and k, v
// (B, T, Hkv, D), with G = Hq / Hkv query rows per KV head:
//
//   out[b, h*G + g, :] = softmax(q[b, h*G + g] . k[b, :, h]^T / sqrt(D))
//                        . v[b, :, h]
//
// accumulated in float32 and written as float32 (B, Hq, D).  q, k and v
// are bfloat16 or float32 (one type for all three) and are converted to
// float32 as they are read.  k and v may be views into a longer cache:
// rows are contiguous ((T, Hkv, D) with strides (Hkv*D, D, 1)), and the
// batch stride is an argument, so `cache[:, :pos+1]` is read in place.
//
// Bound on an H100: bytes.  The work is one read of K and V,
// 2*B*T*Hkv*D*sizeof(dtype) bytes, against 4*B*Hq*T*D operations, about
// two operations per byte in bf16, far below the ~295 at which the tensor
// cores would bound it.
//
// Design.  The TPU kernel walks the cache on a sequential grid axis and
// carries the online-softmax state (m, l, acc) in VMEM scratch across grid
// steps.  Blocks on the card run in no order, so here one thread block
// owns one (b, kv-head) pair and walks T itself: it stages a tile of TT
// keys and values in shared memory (as float32, rows padded by 4 floats so
// that 16-byte reads of eight neighbouring rows hit distinct banks), takes
// the G x TT scores (one thread per score), updates m and l per query row
// (one warp per row), and rescales and accumulates acc (each thread owns a
// fixed set of the G x D outputs, in registers).  The ragged last tile is
// cut in the kernel: no T % 512 rule, no padding.  The scale 1/sqrt(D)
// is folded into q when q is staged.
//
// What it does not do yet: B*Hkv blocks fill only 16 of the 132 SMs at the
// serving path's shape (B = 8, Hkv = 2), and each block waits for its tile
// before computing on it.  Splitting T across blocks, with a second pass
// that combines the partial (m, l, acc), is the redesign for a later
// change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                          // keys per tile (TT)
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxOwned = kMaxG * kMaxD / kThreads;  // acc entries a thread
constexpr int kPad = 4;                            // floats after each row

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in floats:
//   ks, vs  TT x (D + kPad) each   the staged key and value tile
//   qs      G x (D + kPad)         q, scaled by 1/sqrt(D)
//   ps      G x TT                 scores, then probabilities
//   ms, ls, cs  G each             running max, running sum, correction
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ out, int T_len,
                    int Hkv, int G, int D, long long k_bstride,
                    long long v_bstride) {
  extern __shared__ float smem[];
  const int row = D + kPad;
  float* ks = smem;
  float* vs = ks + kTile * row;
  float* qs = vs + kTile * row;
  float* ps = qs + G * row;
  float* ms = ps + G * kTile;
  float* ls = ms + G;
  float* cs = ls + G;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const long long kv_row = static_cast<long long>(Hkv) * D;  // between keys

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qb = q + (static_cast<long long>(b) * Hq + h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    qs[(e / D) * row + e % D] = to_float(qb[e]) * scale;
  }
  if (tid < G) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  float acc[kMaxOwned];
#pragma unroll
  for (int i = 0; i < kMaxOwned; ++i) acc[i] = 0.f;

  const T* kb = k + b * k_bstride + static_cast<long long>(h) * D;
  const T* vb = v + b * v_bstride + static_cast<long long>(h) * D;
  const int vecs = D / 8;  // 8-element vectors per row

  for (int t0 = 0; t0 < T_len; t0 += kTile) {
    const int n = min(kTile, T_len - t0);
    // Stage the tile's n keys and values as float32.
    for (int i = tid; i < n * vecs; i += kThreads) {
      const int j = i / vecs;
      const int c = (i % vecs) * 8;
      const long long off = (t0 + j) * kv_row + c;
      float kv8[8];
      load8(kb + off, kv8);
      float4* dk = reinterpret_cast<float4*>(ks + j * row + c);
      dk[0] = make_float4(kv8[0], kv8[1], kv8[2], kv8[3]);
      dk[1] = make_float4(kv8[4], kv8[5], kv8[6], kv8[7]);
      load8(vb + off, kv8);
      float4* dv = reinterpret_cast<float4*>(vs + j * row + c);
      dv[0] = make_float4(kv8[0], kv8[1], kv8[2], kv8[3]);
      dv[1] = make_float4(kv8[4], kv8[5], kv8[6], kv8[7]);
    }
    __syncthreads();

    // Scores: one thread per (g, j).
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int j = i % kTile;
      float s = -INFINITY;
      if (j < n) {
        const float4* qr = reinterpret_cast<const float4*>(qs + g * row);
        const float4* kr = reinterpret_cast<const float4*>(ks + j * row);
        s = 0.f;
        for (int d = 0; d < D / 4; ++d) {
          const float4 a = qr[d];
          const float4 c = kr[d];
          s = fmaf(a.x, c.x, s);
          s = fmaf(a.y, c.y, s);
          s = fmaf(a.z, c.z, s);
          s = fmaf(a.w, c.w, s);
        }
      }
      ps[g * kTile + j] = s;
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = ps + g * kTile;
      float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a key
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V, over the outputs this thread owns.
#pragma unroll
    for (int i = 0; i < kMaxOwned; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D;
        const int d = e % D;
        const float* pr = ps + g * kTile;
        float a = acc[i] * cs[g];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * row + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

  float* ob = out + (static_cast<long long>(b) * Hq + h * G) * D;
#pragma unroll
  for (int i = 0; i < kMaxOwned; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) ob[e] = acc[i] / ls[e / D];
  }
}

size_t smem_bytes(int G, int D) {
  const int row = D + kPad;
  return sizeof(float) *
         (static_cast<size_t>(2 * kTile + G) * row + G * kTile + 3 * G);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_len, int Hq, int Hkv, int D, long long k_bstride,
           long long v_bstride, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), T_len, Hkv, G, D,
      k_bstride, v_bstride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, D) contiguous; k, v (B, T, Hkv, D) with rows contiguous and
// batch strides k_bstride, v_bstride (in elements); out (B, Hq, D) float32.
// dtype: 0 = float32, 1 = bfloat16 (all of q, k, v).  The wrapper checks
// the shapes (D in {16, 64, 128, 256}, G = Hq / Hkv <= 16, T >= 1) and the
// 16-byte alignment.  Returns cudaGetLastError(), or -1 for an unknown
// dtype or an unsupported shape.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   void* out, int B, int T_len, int Hq,
                                   int Hkv, int D, long long k_bstride,
                                   long long v_bstride, int dtype, int device,
                                   void* stream) {
  if (B == 0) return 0;
  if (T_len < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > kMaxG ||
      D % 8 != 0 || D > kMaxD)
    return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, T_len, Hq, Hkv, D, k_bstride,
                         v_bstride, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, T_len, Hq, Hkv, D,
                                 k_bstride, v_bstride, s);
  return -1;
}
