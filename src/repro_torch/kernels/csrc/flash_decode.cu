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
// two operations per byte in bf16 (G = 8), far below the ~295 at which
// the tensor cores would bound it, and below the 20 at which the CUDA
// cores' 67 TFLOP/s of float32 would.  So the kernel has to keep enough
// loads in flight to stream the cache at the memory's rate, on every SM.
//
// This is the redesign that the first version's note left to a later
// change.  That version ran one block per (b, KV head), 16 blocks on 132
// SMs at the LM path's shape, each walking all of T; it staged each tile
// as float32 and only then computed on it; and it read each K and V value
// from shared memory once per query row (G times).  What this one does:
//
// 1. Split T across blocks (flash-decoding).  The grid is (B*Hkv, S).
//    Block (bh, s) owns keys [s*K, min(T, (s+1)*K)), K a multiple of the
//    tile, at least one key (the wrapper's plan_splits chooses S and K).
//    Given a workspace (always when S > 1) it writes an unnormalised
//    partial (acc[D], m, l) for each of its G query rows into it, float32
//    (B, Hq, S, D + 2), and flash_decode_combine_kernel rescales the S
//    partials by exp(m_s - M), sums them in the order s = 0, 1, ... and
//    divides by the total l: no atomics, so the same inputs give the same
//    bits on every call.  Without one (S = 1 in flash_decode_launch) the
//    split kernel normalises and writes `out` itself.
// 2. Keep loads in flight.  Tiles of kTile keys are staged in shared
//    memory in their stored type (rows padded by 16 bytes, so that the 32
//    rows one warp reads at one column fall in distinct banks), in a ring
//    of two tiles filled with 16-byte cp.async copies: the next tile's
//    copies start before the current tile's compute, and values are
//    converted to float32 as they are read from shared memory.  Small
//    blocks (128 threads, 44 KB at D = 128 in bf16) let five of them share
//    an SM, so other blocks' loads are in flight while one computes.
// 3. Read each K and V value from shared memory once per block.  Scores:
//    lane j of warp w takes key j of the tile and the w-th quarter of D,
//    forms its partial dot products with all G scaled q rows (q is held
//    as float32 in shared memory and read as broadcasts), and the four
//    quarters are summed in a fixed order in the softmax step (one warp
//    per query row, in float32).  P.V: each thread owns 4 columns for all
//    G rows, in registers, and reads each V value once for G fused
//    multiply-adds; the groups of threads that take every n-th key are
//    summed in a fixed order at the end.  No tensor cores: mma.sync or
//    wgmma would round P to bf16 or TF32 (an error of ~1e-3 |v|).  Q.K^T,
//    whose bf16 products are exact, stays on the CUDA cores as well: the
//    float32 inputs would need a second path, and the FMAs of both
//    products (16 cycles a key per SM at G = 8, D = 128) are about half
//    of the byte bound's time.
// 4. Host work per call.  The dynamic shared memory limit is raised once
//    per kernel instance and device, not on every launch, and the device
//    is set only when it is not the current one.
//
// 5. A cache sharded on its sequence (sharded decode: each rank holds a
//    contiguous slice of T).  flash_decode_partials_launch runs the split
//    kernel alone on one slice and always writes the partials, even with
//    one split; the caller gathers every slice's partials in sequence
//    order and flash_decode_combine_launch runs the combine kernel on them
//    (up to kMaxSplits in all).  A slice with no valid key yet (rows past
//    the current position are not attended) launches nothing: its caller
//    writes the neutral partial (acc = 0, m = -inf, l = 0), and the
//    combine gives it weight exp(-inf - M) = 0, adding exact zeros.  That
//    relies on M being finite, i.e. on one partial of each row holding a
//    key: the first slice always holds row 0, which every step attends.
//    A row whose partials are all neutral would come out NaN.
//
// The scale 1/sqrt(D) is folded into q when q is staged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // keys per tile: one per lane in the scores
constexpr int kMaxSplits = 256;  // as MAX_SPLITS in flash_decode.py
constexpr int kRowPad = 16;      // bytes after each staged row

// Sizes of one instance: element type T, head dim D, G rounded up to GM.
template <typename T, int D, int GM>
struct Cfg {
  static constexpr int kEl = sizeof(T);
  static constexpr int kPitch = D * kEl + kRowPad;   // bytes per staged row
  static constexpr int kChunks = D * kEl / 16;       // 16-byte copies a row
  static constexpr int kTileBytes = 2 * kTile * kPitch;     // K and V
  // Two stages: at (8, 16, 2, 128, 32768) bf16 on an H100 a third stage
  // cost more in blocks per SM (3 against 5) than it gave in loads in
  // flight (tools/tune_flash_decode.py times both; PERF.md section 6).
  static constexpr int kStages = 2;
  static constexpr int kQW = D / kWarps;             // score columns a warp
  static constexpr int kVec = (kQW * kEl < 16 ? kQW * kEl : 16) / kEl;
  static constexpr int kTPK = D / 4;                 // P.V threads per key
  static constexpr int kGroups = kThreads / kTPK;    // keys at once in P.V
  static constexpr int kRows = (GM + kWarps - 1) / kWarps;  // rows a warp
  static constexpr int kRingBytes = kStages * kTileBytes;
  static constexpr int kRedBytes = kGroups * GM * D * 4;
  static constexpr int kBigBytes =
      kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  // Floats after the ring: qs GM x D, sp kWarps x GM x kTile,
  // ps kTile x GM, cs / ms / ls GM each.
  static constexpr size_t kSmem =
      kBigBytes + 4 * (GM * D + kWarps * GM * kTile + kTile * GM + 3 * GM);
  static_assert(D % 16 == 0 && kQW % kVec == 0 && kVec % 4 == 0, "shape");
  static_assert(kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive elements of shared memory to float32 (N * sizeof(T) is 8
// or 16 bytes, and the address is aligned to it).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = a.x; out[4 * i + 1] = a.y;
    out[4 * i + 2] = a.z; out[4 * i + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  static_assert(N == 4 || N == 8, "bf16 vector");
  __nv_bfloat162 h[N / 2];
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
  } else {
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of n keys' K and V rows (starting at key t0 of the
// split) into one stage of the ring.
template <typename T, int D, int GM>
__device__ __forceinline__ void copy_tile(unsigned char* stage,
                                           const T* kb, const T* vb,
                                           long long row, int t0, int n,
                                           int tid) {
  using C = Cfg<T, D, GM>;
  for (int i = tid; i < n * C::kChunks; i += kThreads) {
    const int j = i / C::kChunks;
    const int c = i % C::kChunks;
    const long long off = (t0 + j) * row;
    cp_async16(stage + j * C::kPitch + c * 16,
               reinterpret_cast<const unsigned char*>(kb + off) + c * 16);
    cp_async16(stage + (kTile + j) * C::kPitch + c * 16,
               reinterpret_cast<const unsigned char*>(vb + off) + c * 16);
  }
}

template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ ws, int T_len, int Hkv, int G,
                          int keys_per_split, long long k_bstride,
                          long long v_bstride) {
  using C = Cfg<T, D, GM>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + C::kBigBytes);  // GM x D
  float* sp = qs + GM * D;               // partial scores kWarps x GM x kTile
  float* ps = sp + kWarps * GM * kTile;  // probabilities kTile x GM
  float* cs = ps + kTile * GM;           // corrections
  float* ms = cs + GM;
  float* ls = ms + GM;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const long long row = static_cast<long long>(Hkv) * D;  // between keys
  const int start = s * keys_per_split;
  const int nkeys = min(keys_per_split, T_len - start);   // >= 1
  const int ntiles = (nkeys + kTile - 1) / kTile;
  const T* kb = k + b * k_bstride + static_cast<long long>(h) * D +
                start * row;
  const T* vb = v + b * v_bstride + static_cast<long long>(h) * D +
                start * row;

  // The first tiles' copies go out before anything else.
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < ntiles)
      copy_tile<T, D, GM>(ring + i * C::kTileBytes, kb, vb, row, i * kTile,
                           min(kTile, nkeys - i * kTile), tid);
    cp_async_commit();
  }

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qb = q + (static_cast<long long>(b) * Hq + h * G) * D;
  for (int e = tid; e < GM * D; e += kThreads)
    qs[e] = e < G * D ? to_float(qb[e]) * scale : 0.f;
  for (int e = tid; e < kTile * GM; e += kThreads) ps[e] = 0.f;
  if (tid < GM) cs[tid] = 1.f;

  float m_run[C::kRows], l_run[C::kRows];
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const int grp = tid / C::kTPK;        // which keys this thread takes in P.V
  const int col = (tid % C::kTPK) * 4;  // its 4 columns

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<C::kStages - 2>();  // this thread's copies of tile `it`
    __syncthreads();  // everyone's copies; everyone done with tile it - 1
    const int nxt = it + C::kStages - 1;
    if (nxt < ntiles)
      copy_tile<T, D, GM>(ring + (nxt % C::kStages) * C::kTileBytes, kb, vb,
                           row, nxt * kTile, min(kTile, nkeys - nxt * kTile),
                           tid);
    cp_async_commit();

    const unsigned char* st = ring + (it % C::kStages) * C::kTileBytes;
    const int n = min(kTile, nkeys - it * kTile);

    // Scores: lane = key, warp = quarter of D, all G rows at once.
    {
      float sc[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) sc[g] = 0.f;
      const T* kr = reinterpret_cast<const T*>(st + lane * C::kPitch) +
                    warp * C::kQW;
      const float* qw = qs + warp * C::kQW;
#pragma unroll
      for (int c = 0; c < C::kQW; c += C::kVec) {
        float kv[C::kVec];
        load_vec<C::kVec>(kr + c, kv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float4* qv = reinterpret_cast<const float4*>(qw + g * D + c);
#pragma unroll
          for (int e = 0; e < C::kVec / 4; ++e) {
            const float4 a = qv[e];
            sc[g] = fmaf(a.x, kv[4 * e], sc[g]);
            sc[g] = fmaf(a.y, kv[4 * e + 1], sc[g]);
            sc[g] = fmaf(a.z, kv[4 * e + 2], sc[g]);
            sc[g] = fmaf(a.w, kv[4 * e + 3], sc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) sp[(warp * GM + g) * kTile + lane] = sc[g];
    }
    __syncthreads();

    // Online softmax: warp w takes rows w, w + 4, ...; m and l stay in its
    // registers.
#pragma unroll
    for (int r = 0; r < C::kRows; ++r) {
      const int g = warp + r * kWarps;
      if (g < G) {
        float x = -INFINITY;
        if (lane < n) {
          x = sp[g * kTile + lane];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) x += sp[(w * GM + g) * kTile + lane];
        }
        float mx = x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[r], mx);  // finite: lane 0 has a key
        const float p = expf(x - m_new);          // 0 past the last key
        ps[lane * GM + g] = p;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m_run[r] - m_new);  // 0 on the first tile
        l_run[r] = l_run[r] * corr + sum;
        m_run[r] = m_new;
        if (lane == 0) cs[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V over this thread's columns and all G rows.
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float c = cs[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= c;
    }
    const T* vs = reinterpret_cast<const T*>(st + kTile * C::kPitch);
    for (int j = grp; j < n; j += C::kGroups) {
      float vv[4];
      load_vec<4>(vs + j * (C::kPitch / C::kEl) + col, vv);
      if constexpr (GM % 4 == 0) {
        const float4* pr = reinterpret_cast<const float4*>(ps + j * GM);
#pragma unroll
        for (int g4 = 0; g4 < GM / 4; ++g4) {
          const float4 p = pr[g4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[4 * g4][e] = fmaf(p.x, vv[e], acc[4 * g4][e]);
            acc[4 * g4 + 1][e] = fmaf(p.y, vv[e], acc[4 * g4 + 1][e]);
            acc[4 * g4 + 2][e] = fmaf(p.z, vv[e], acc[4 * g4 + 2][e]);
            acc[4 * g4 + 3][e] = fmaf(p.w, vv[e], acc[4 * g4 + 3][e]);
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = ps[j * GM + g];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
    }
  }

  // Sum the key groups' accumulators in a fixed order, through the ring.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // kGroups x GM x D
#pragma unroll
  for (int g = 0; g < GM; ++g)
    *reinterpret_cast<float4*>(red + (grp * GM + g) * D + col) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
#pragma unroll
  for (int r = 0; r < C::kRows; ++r) {
    const int g = warp + r * kWarps;
    if (g < G && lane == 0) {
      ms[g] = m_run[r];
      ls[g] = l_run[r];
    }
  }
  __syncthreads();
  const long long orow = static_cast<long long>(b) * Hq + h * G;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    const int d = e % D;
    float a = red[g * D + d];
#pragma unroll
    for (int i = 1; i < C::kGroups; ++i) a += red[(i * GM + g) * D + d];
    if (ws == nullptr)
      out[(orow + g) * D + d] = a / ls[g];
    else
      ws[((orow + g) * S + s) * (D + 2) + d] = a;
  }
  if (ws != nullptr && tid < G) {
    float* w = ws + ((orow + tid) * S + s) * (D + 2) + D;
    w[0] = ms[tid];
    w[1] = ls[tid];
  }
}

// One block per (b, query head): out = sum_s exp(m_s - M) acc_s /
// sum_s exp(m_s - M) l_s, summed in the order s = 0 .. S-1.
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ ws,
                            float* __restrict__ out, int S, int D) {
  __shared__ float m_s[kMaxSplits];
  __shared__ float l_s[kMaxSplits];
  __shared__ float w_s[kMaxSplits];
  const long long r = blockIdx.x;
  const float* w = ws + r * S * (D + 2);
  for (int i = threadIdx.x; i < S; i += kThreads) {
    m_s[i] = w[i * (D + 2) + D];
    l_s[i] = w[i * (D + 2) + D + 1];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int i = 0; i < S; ++i) M = fmaxf(M, m_s[i]);
  for (int i = threadIdx.x; i < S; i += kThreads) w_s[i] = expf(m_s[i] - M);
  __syncthreads();
  float L = 0.f;
  for (int i = 0; i < S; ++i) L = fmaf(w_s[i], l_s[i], L);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int i = 0; i < S; ++i) a = fmaf(w_s[i], w[i * (D + 2) + d], a);
    out[r * D + d] = a / L;
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *ws;
  int B, T_len, Hq, Hkv, D, S, keys_per_split;
  long long k_bstride, v_bstride;
  int device;
  cudaStream_t stream;
};

template <typename T, int D, int GM>
int launch(const Args& a) {
  using C = Cfg<T, D, GM>;
  // Raised once per instance and device (a device's bit is set after its
  // first successful call).
  static std::atomic<unsigned> configured{0};
  const unsigned bit = 1u << (a.device & 31);
  if (!(configured.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, D, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured.fetch_or(bit, std::memory_order_release);
  }
  const int G = a.Hq / a.Hkv;
  flash_decode_split_kernel<T, D, GM>
      <<<dim3(a.B * a.Hkv, a.S), kThreads, C::kSmem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<float*>(a.out),
          static_cast<float*>(a.ws), a.T_len, a.Hkv, G, a.keys_per_split,
          a.k_bstride, a.v_bstride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.out == nullptr || a.S == 1)
    return static_cast<int>(err);
  flash_decode_combine_kernel<<<a.B * a.Hq, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.ws), static_cast<float*>(a.out), a.S, a.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const Args& a) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<T, D, 1>(a);
  if (G <= 2) return launch<T, D, 2>(a);
  if (G <= 4) return launch<T, D, 4>(a);
  if (G <= 8) return launch<T, D, 8>(a);
  return launch<T, D, 16>(a);
}

template <typename T>
int by_dim(const Args& a) {
  switch (a.D) {
    case 16: return by_group<T, 16>(a);
    case 64: return by_group<T, 64>(a);
    case 128: return by_group<T, 128>(a);
    case 256: return by_group<T, 256>(a);
    default: return -1;
  }
}

bool bad_plan(int T_len, int Hq, int Hkv, int splits, int keys_per_split) {
  return T_len < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > 16 ||
         splits < 1 || splits > kMaxSplits || keys_per_split < kTile ||
         keys_per_split % kTile != 0 ||
         static_cast<long long>(splits - 1) * keys_per_split >= T_len ||
         static_cast<long long>(splits) * keys_per_split < T_len;
}

int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

int by_dtype(const Args& a, int dtype) {
  if (dtype == 0) return by_dim<float>(a);
  if (dtype == 1) return by_dim<__nv_bfloat16>(a);
  return -1;
}

}  // namespace

// q (B, Hq, D) contiguous; k, v (B, T, Hkv, D) with rows contiguous and
// batch strides k_bstride, v_bstride (in elements); out (B, Hq, D) float32;
// ws a float32 workspace (B, Hq, splits, D + 2), used when splits > 1.
// Split s takes keys [s * keys_per_split, (s + 1) * keys_per_split) cut at
// T; keys_per_split is a multiple of the tile (32 keys) and every split
// has a key.  dtype: 0 = float32, 1 = bfloat16 (all of q, k, v).  The
// wrapper checks the shapes (D in {16, 64, 128, 256}, G = Hq / Hkv <= 16,
// T >= 1) and the 16-byte alignment.  Returns cudaGetLastError() of the
// launches, or -1 for an unknown dtype or an unsupported shape or plan.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   void* out, void* ws, int B, int T_len,
                                   int Hq, int Hkv, int D, long long k_bstride,
                                   long long v_bstride, int splits,
                                   int keys_per_split, int dtype, int device,
                                   void* stream) {
  if (B == 0) return 0;
  if (bad_plan(T_len, Hq, Hkv, splits, keys_per_split) || out == nullptr ||
      (splits > 1 && ws == nullptr))
    return -1;
  const int err = use_device(device);
  if (err != 0) return err;
  // One split: the split kernel writes `out`, so it gets no workspace.
  const Args a{q, k, v, out, splits > 1 ? ws : nullptr, B, T_len, Hq, Hkv,
               D, splits, keys_per_split, k_bstride, v_bstride, device,
               static_cast<cudaStream_t>(stream)};
  return by_dtype(a, dtype);
}

// The split kernel alone, on one slice of a cache: the same arguments as
// flash_decode_launch without `out`; the partials (acc[D], m, l) of every
// split go to ws (B, Hq, splits, D + 2) float32, also with one split.
extern "C" int flash_decode_partials_launch(
    const void* q, const void* k, const void* v, void* ws, int B, int T_len,
    int Hq, int Hkv, int D, long long k_bstride, long long v_bstride,
    int splits, int keys_per_split, int dtype, int device, void* stream) {
  if (B == 0) return 0;
  if (bad_plan(T_len, Hq, Hkv, splits, keys_per_split) || ws == nullptr)
    return -1;
  const int err = use_device(device);
  if (err != 0) return err;
  const Args a{q, k, v, nullptr, ws, B, T_len, Hq, Hkv, D, splits,
               keys_per_split, k_bstride, v_bstride, device,
               static_cast<cudaStream_t>(stream)};
  return by_dtype(a, dtype);
}

// The combine kernel alone: ws (rows, splits, D + 2) float32 partials, in
// the order they are summed, -> out (rows, D) float32; rows = B * Hq.
// Neutral partials (m = -inf, l = 0, acc = 0) add nothing, as long as one
// partial of each row is not neutral (note 5).
extern "C" int flash_decode_combine_launch(const void* ws, void* out,
                                           long long rows, int splits, int D,
                                           int device, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || splits < 1 || splits > kMaxSplits || D < 1 ||
      rows > 0x7fffffffLL || ws == nullptr || out == nullptr)
    return -1;
  const int err = use_device(device);
  if (err != 0) return err;
  flash_decode_combine_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), splits, D);
  return static_cast<int>(cudaGetLastError());
}
