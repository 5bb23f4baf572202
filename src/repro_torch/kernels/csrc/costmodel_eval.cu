// Batched evaluation of the hard cost model: two kernels on one device
// function.
//
// `cost_eval_kernel` replaces the TPU kernel `cost_eval_padded` /
// `_cost_kernel` in src/repro/kernels/costmodel_eval.py.  It computes the
// four outputs of the hard `core_cost` (latency, energy, area, power) for
// every (b, n) of a (B, N) batch of design points against an
// (NUM_FIELDS, N) layer table, exactly as repro_torch/costmodel/maestro.py
// does (`core_cost` -> `_gated_cost` -> `_dataflow_terms`), operation for
// operation and in the same order.
//
// `cost_eval_multi_kernel` replaces `cost_eval_multi_padded` /
// `_cost_kernel_multi` in the same file: every point carries its own layer
// descriptor, (M, NUM_FIELDS) beside (M,) pe, kt and df.  This is the
// search service's shape: one batcher dispatch fuses the fresh points of
// many searches, of different workloads, into one flat list.
// Both kernels call the one `core_cost` below, in one library built with
// one set of flags, so a point gets the same bits from either kernel; that
// is what keeps a search through the service byte-identical to the same
// search run serially.
//
// Bound on an H100: bytes.  Each point reads 3 x 4 B (pe, kt, df) and writes
// 4 x 4 B; the layer table adds 32 B per column (per point in the per-row
// kernel: 60 B a point).  The arithmetic is some two hundred float
// operations per point, far below the card's float32 rate for that
// traffic.  At the search's shapes ((20, 53), (100, 53), (E, 1); a GA
// generation of 5,300 points through the service) the bytes take tens to
// hundreds of nanoseconds, so a launch costs more than the work.  Design:
// one thread per point over a 1-D grid, no tiling and no padding (the TPU
// kernels' (8, 128) tiles are not carried over); each thread reads its
// layer fields through the read-only cache, and the whole model stays in
// registers, so no intermediate goes to device memory.  Rows with
// repeat = 0 come out exactly 0: every output is multiplied by repeat.
// Since a launch costs more than the work, the table kernel also takes the
// host work away from around it: it reads pe, kt and df where they lie,
// through their row and column strides (0 broadcasts an (E, 1) column, an
// (N,) row or one value), or takes one of them as a scalar by value (one
// dataflow for the whole batch), so the searches launch no copy kernel
// and upload no scalar before it; and it writes its four outputs into one
// (4, B, N) buffer from one base pointer.  How an operand is read does not
// touch `core_cost`, so strided, broadcast and contiguous inputs give the
// same bits.
// The per-row kernel is the service's, whose dispatch waits on each of its
// calls: it reads a point's eight layer fields and its pe, kt and df
// through one point stride each (the fields of a point side by side), so
// the batcher's (M, 11) upload of packed point rows is read in place (the
// fields are columns 0-7, pe / kt / df columns 8-10, all at point stride
// 11) and no copy kernel runs before it; and it writes each point's four
// costs as one 16-byte (M, 4) row, which is the row the service's cache
// stores, so no stacking kernel runs after it.  Offsets are 32-bit (the
// wrapper checks that they fit).
//
// Numbers: the library is built without --use_fast_math, so `/` and sqrtf
// round the IEEE way (a division that feeds ceilf/floorf must not come out
// one ulp above an integer, or a whole extra tile appears), and with
// -fmad=false, so products stay unfused as in the plain version.  That
// setting was kept: chip_smoke.py found the table kernel bit-equal to the
// plain version on an H100 (largest absolute and relative error 0 over
// 347,536 design points: every paper workload x 3 dataflows x the 12 x 12
// level grid, random points at (4096, 53) and ragged shapes).
#include <cuda_runtime.h>

namespace {

constexpr int kNumFields = 8;
constexpr float kDLA = 0.0f, kEYE = 1.0f, kSHI = 2.0f, kDWCONV = 1.0f;

// Hardware constants, as in repro_torch/costmodel/maestro.py.
constexpr float E_MAC = 1.0f, E_L1 = 1.0f, E_L2 = 6.0f, E_DRAM = 200.0f;
constexpr float L1_ACC_PER_MAC = 3.0f;
constexpr float P_MAC_MW = 1.0f, P_L1_MW_B = 0.005f, P_L2_MW_B = 0.002f;
constexpr float P_NOC_MW_PE = 0.1f;
constexpr float LEAK_PE_MW = 0.05f, LEAK_L1_MW_B = 0.001f;
constexpr float A_MAC_UM2 = 2000.0f, A_L1_UM2_B = 50.0f, A_L2_UM2_B = 25.0f;
constexpr float A_NOC_UM2_PE = 300.0f;
constexpr float DRAM_BW = 16.0f, L2_BW_BASE = 8.0f, L2_BW_SQRT = 8.0f;
constexpr float FILL_CYCLES = 20.0f;

// The hard plateau ops (repro_torch/costmodel/primitives.py).
__device__ __forceinline__ float cdiv(float a, float b) {
  return ceilf(a / fmaxf(b, 1.0f));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float blend(float g, float a, float b) {
  return g > 0.0f ? a : b;
}
__device__ __forceinline__ float gate(float x, float v) {
  return x == v ? 1.0f : 0.0f;
}

// p1 = clip(pe, 1, max(d1, 1)); p2 = clip(floor(pe / p1), 1, max(d2, 1)).
__device__ __forceinline__ void factorize(float pe, float d1, float d2,
                                          float& p1, float& p2) {
  p1 = clip(pe, 1.0f, fmaxf(d1, 1.0f));
  p2 = clip(floorf(pe / p1), 1.0f, fmaxf(d2, 1.0f));
}

__device__ void core_cost(float K, float C, float Y, float X, float R,
                          float S, float ltype, float repeat, float pe,
                          float kt, float df, float& lat_out, float& en_out,
                          float& area_out, float& pw_out) {
  pe = fmaxf(pe, 1.0f);
  kt = fmaxf(kt, 1.0f);
  const float is_dla = gate(df, kDLA), is_eye = gate(df, kEYE),
              is_shi = gate(df, kSHI);
  const float is_dw = gate(ltype, kDWCONV);
  // l1_bytes_formula: where(df == DLA, dla_b, where(df == EYE, eye_b, shi_b))
  const float rs = R * S;
  const float dla_b = kt * rs + rs + kt;
  const float eye_b = kt * S + S + kt;
  const float shi_b = rs + 2.0f * kt;
  const float l1_bytes = df == kDLA ? dla_b : (df == kEYE ? eye_b : shi_b);

  // _gated_cost
  const float Yp = fmaxf(Y - R + 1.0f, 1.0f);
  const float Xp = fmaxf(X - S + 1.0f, 1.0f);
  const float C_red = blend(is_dw, 1.0f, C);
  const float K_out = blend(is_dw, C, K);
  const float macs = K_out * C_red * Yp * Xp * R * S;
  const float W_u = K_out * C_red * R * S;
  const float A_u = C * Y * X;
  const float O_u = K_out * Yp * Xp;

  // _dataflow_terms
  const float Ku = cdiv(K_out, kt);
  // dla: parallel (Ku, C_red)
  float p1d, p2d;
  factorize(pe, Ku, C_red, p1d, p2d);
  const float t1d = cdiv(Ku, p1d);
  const float t2d = cdiv(C_red, p2d);
  const float kt_eff_d = fminf(kt, cdiv(K_out, p1d * t1d));
  const float comp_dla = t1d * t2d * kt_eff_d * R * S * Yp * Xp;
  const float a_passes_dla = blend(is_dw, 1.0f, t1d);
  const float l2_dla = W_u + A_u * a_passes_dla + O_u * p2d;
  // eye: parallel (Y', R)
  float p1e, p2e;
  factorize(pe, Yp, R, p1e, p2e);
  const float t1e = cdiv(Yp, p1e);
  const float t2e = cdiv(R, p2e);
  const float kt_eff_e = fminf(kt, K_out);
  const float comp_eye = t1e * t2e * C_red * Ku * kt_eff_e * S * Xp;
  const float halo_e = (p1e + R - 1.0f) / fmaxf(p1e, 1.0f);
  const float a_passes_eye = blend(is_dw, 1.0f, Ku);
  const float l2_eye = W_u * t1e + A_u * a_passes_eye * halo_e + O_u * p2e;
  // shi: parallel (Y', X')
  float p1s, p2s;
  factorize(pe, Yp, Xp, p1s, p2s);
  const float t1s = cdiv(Yp, p1s);
  const float t2s = cdiv(Xp, p2s);
  const float kt_eff_s = fminf(kt, K_out);
  const float comp_shi = t1s * t2s * C_red * Ku * kt_eff_s * R * S;
  const float halo_s =
      ((p1s + R - 1.0f) * (p2s + S - 1.0f)) / fmaxf(p1s * p2s, 1.0f);
  const float l2_shi = W_u * t1s * t2s + A_u * halo_s + O_u;

  const float comp = is_dla * comp_dla + is_eye * comp_eye + is_shi * comp_shi;
  const float l2_traffic = is_dla * l2_dla + is_eye * l2_eye + is_shi * l2_shi;
  const float passes_w = is_dla * 1.0f + is_eye * t1e + is_shi * (t1s * t2s);
  const float passes_a =
      is_dla * a_passes_dla + is_eye * a_passes_eye + is_shi * 1.0f;

  // back in _gated_cost
  const float l2_bytes = 2.0f * pe * l1_bytes;
  const float spill_w = clip(1.0f - l2_bytes / fmaxf(W_u, 1.0f), 0.0f, 1.0f);
  const float spill_a = clip(1.0f - l2_bytes / fmaxf(A_u, 1.0f), 0.0f, 1.0f);
  const float dram_traffic = W_u * (1.0f + (passes_w - 1.0f) * spill_w) +
                             A_u * (1.0f + (passes_a - 1.0f) * spill_a) + O_u;
  const float sqrt_pe = sqrtf(pe);
  const float l2_bw = L2_BW_BASE + L2_BW_SQRT * sqrt_pe;
  const float lat =
      fmaxf(fmaxf(comp, l2_traffic / l2_bw), dram_traffic / DRAM_BW) +
      sqrt_pe + FILL_CYCLES;

  const float leak_mw = LEAK_PE_MW * pe + LEAK_L1_MW_B * l1_bytes * pe;
  const float energy_pj = E_MAC * macs +
                          E_L1 * (L1_ACC_PER_MAC * macs + l2_traffic) +
                          E_L2 * l2_traffic + E_DRAM * dram_traffic +
                          leak_mw * lat;
  const float area = A_MAC_UM2 * pe + A_L1_UM2_B * l1_bytes * pe +
                     A_L2_UM2_B * l2_bytes + A_NOC_UM2_PE * pe;
  const float power = P_MAC_MW * pe + P_L1_MW_B * l1_bytes * pe +
                      P_L2_MW_B * l2_bytes + P_NOC_MW_PE * pe;

  lat_out = lat * repeat;
  en_out = (energy_pj * repeat) * 1e-3f;
  area_out = area * repeat;
  pw_out = power * repeat;
}

// One of pe, kt, df as the table kernel reads it: the value at (b, n) of
// a (B, N) view, p[b * rs + n * cs] (a stride of 0 broadcasts), or, where
// p is null, the scalar v.
struct Operand {
  const float* p;
  long long rs, cs;
  float v;
};

__device__ __forceinline__ float operand_at(const Operand& o, long long b,
                                            long long n) {
  return o.p != nullptr ? __ldg(o.p + b * o.rs + n * o.cs) : o.v;
}

__global__ void cost_eval_kernel(const float* __restrict__ layers_t,
                                 Operand pe, Operand kt, Operand df,
                                 float* __restrict__ out, long long total,
                                 int N) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / N;
  const int n = static_cast<int>(idx - b * N);
  float f[kNumFields];
#pragma unroll
  for (int i = 0; i < kNumFields; ++i) f[i] = __ldg(layers_t + i * N + n);
  core_cost(f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
            operand_at(pe, b, n), operand_at(kt, b, n), operand_at(df, b, n),
            out[idx], out[total + idx], out[2 * total + idx],
            out[3 * total + idx]);
}

// The per-row kernel: point p's layer fields at layers[p * ls + i], its pe,
// kt and df at pe[p * ps], kt[p * ks], df[p * ds] (a stride of 0 reads one
// value for every point), its four costs at out[4 p .. 4 p + 3] (out is
// 16-byte aligned).
__global__ void cost_eval_multi_kernel(const float* __restrict__ layers,
                                       const float* __restrict__ pe,
                                       const float* __restrict__ kt,
                                       const float* __restrict__ df,
                                       float4* __restrict__ out, int ls,
                                       int ps, int ks, int ds, int M) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  const float* row = layers + p * ls;
  float f[kNumFields];
#pragma unroll
  for (int i = 0; i < kNumFields; ++i) f[i] = __ldg(row + i);
  float4 o;
  core_cost(f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
            __ldg(pe + p * ps), __ldg(kt + p * ks), __ldg(df + p * ds), o.x,
            o.y, o.z, o.w);
  out[p] = o;
}

}  // namespace

// The launch arguments come packed in one array, `a`, which the caller
// fills in one step (a call with few arguments costs the host less):
//   a[0]          layers_t: (NUM_FIELDS, N), contiguous
//   a[1 + 3 i]    operand i of pe, kt, df: a data pointer, or 0 to take
//                 its value from `v[i]` instead
//   a[2 + 3 i],   its row and column strides in elements over the (B, N)
//   a[3 + 3 i]    batch (0 broadcasts)
//   a[10]         out: (4, B, N) contiguous, latency / energy / area / power
//   a[11], a[12]  B, N
// All float32, on card `device`, where `stream` lives.  This library
// carries its own CUDA runtime, so the launch selects the device itself.
// Returns cudaGetLastError().
extern "C" int cost_eval_launch(const long long* a, const float* v,
                                int device, void* stream) {
  const long long total = a[11] * a[12];
  if (total == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  Operand o[3];
  for (int i = 0; i < 3; ++i)
    o[i] = Operand{reinterpret_cast<const float*>(a[1 + 3 * i]), a[2 + 3 * i],
                   a[3 + 3 * i], v[i]};
  cost_eval_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(a[0]), o[0], o[1], o[2],
      reinterpret_cast<float*>(a[10]), total, static_cast<int>(a[12]));
  return static_cast<int>(cudaGetLastError());
}

// The per-row kernel's launch arguments, packed as the table kernel's:
//   a[0..3]       layers, pe, kt, df: data pointers
//   a[4..7]       their point strides in elements (layers: its fields
//                 side by side)
//   a[8]          out: (M, 4) contiguous, latency / energy / area / power
//   a[9]          M
//   a[10]         threads per block
// All float32, on card `device`, where `stream` lives; every offset below
// 2^31.  Returns cudaGetLastError().
extern "C" int cost_eval_multi_launch(const long long* a, int device,
                                      void* stream) {
  const int M = static_cast<int>(a[9]);
  if (M == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = static_cast<int>(a[10]);
  const unsigned blocks = static_cast<unsigned>((M + threads - 1) / threads);
  cost_eval_multi_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(a[0]),
      reinterpret_cast<const float*>(a[1]),
      reinterpret_cast<const float*>(a[2]),
      reinterpret_cast<const float*>(a[3]), reinterpret_cast<float4*>(a[8]),
      static_cast<int>(a[4]), static_cast<int>(a[5]), static_cast<int>(a[6]),
      static_cast<int>(a[7]), M);
  return static_cast<int>(cudaGetLastError());
}
