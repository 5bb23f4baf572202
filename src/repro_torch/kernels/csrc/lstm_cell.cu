// One fused LSTM step: the REINFORCE policy step.
//
// Replaces the TPU kernel `lstm_cell_padded` / `_lstm_kernel` in
// src/repro/kernels/lstm_cell.py.  For x (B, I), h and c (B, H),
// wx (I, 4H), wh (H, 4H) and b (4H,), all float32:
//
//   gates = x @ wx + h @ wh + b            gate order i, f, g, o
//   c' = sig(f) * c + sig(i) * tanh(g)     sig(z) = 1 / (1 + exp(-z))
//   h' = sig(o) * tanh(c')
//
// Both matrix products are computed here, in the kernel's own body, and
// the gates never leave registers.
//
// Bound on an H100: bytes.  The search steps one episode at a time (B = 1,
// I = 10, H = 128), so the work is about 141 thousand float operations
// against the 285 KB of weights it has to read; reading them takes about
// 85 ns at 3.35 TB/s.  Across the 53 steps of an episode the weights stay
// in the 50 MB L2.  Design: one block per batch row, one thread per hidden
// unit j (looping when H exceeds the block).  x and h go into shared
// memory; thread j accumulates its four gate pre-activations over I + H in
// float32 FMA, reading wx[k, g*H + j] and wh[k, g*H + j], which neighbouring
// threads read at neighbouring addresses, so every weight load is
// coalesced.  The nonlinearities use the precise expf and tanhf (the
// library is built without --use_fast_math).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sig(float z) { return 1.0f / (1.0f + expf(-z)); }

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out, int I, int H) {
  extern __shared__ float smem[];
  float* sx = smem;      // (I,)
  float* sh = smem + I;  // (H,)
  const int row = blockIdx.x;
  for (int k = threadIdx.x; k < I; k += blockDim.x) sx[k] = x[row * I + k];
  for (int k = threadIdx.x; k < H; k += blockDim.x) sh[k] = h[row * H + k];
  __syncthreads();

  const int H4 = 4 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
    for (int k = 0; k < I; ++k) {
      const float v = sx[k];
      const float* w = wx + k * H4 + j;
      xi = fmaf(v, __ldg(w), xi);
      xf = fmaf(v, __ldg(w + H), xf);
      xg = fmaf(v, __ldg(w + 2 * H), xg);
      xo = fmaf(v, __ldg(w + 3 * H), xo);
    }
    float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
    for (int k = 0; k < H; ++k) {
      const float v = sh[k];
      const float* w = wh + k * H4 + j;
      hi = fmaf(v, __ldg(w), hi);
      hf = fmaf(v, __ldg(w + H), hf);
      hg = fmaf(v, __ldg(w + 2 * H), hg);
      ho = fmaf(v, __ldg(w + 3 * H), ho);
    }
    const float gi = sig(xi + hi + __ldg(b + j));
    const float gf = sig(xf + hf + __ldg(b + H + j));
    const float gg = tanhf(xg + hg + __ldg(b + 2 * H + j));
    const float go = sig(xo + ho + __ldg(b + 3 * H + j));
    const float c_new = gf * c[row * H + j] + gi * gg;
    c_out[row * H + j] = c_new;
    h_out[row * H + j] = go * tanhf(c_new);
  }
}

}  // namespace

// All pointers float32, contiguous, on card `device`, where `stream` lives.
// This library carries its own CUDA runtime, so the launch selects the
// device itself.  Returns cudaGetLastError().
extern "C" int lstm_cell_launch(const void* x, const void* h, const void* c,
                                const void* wx, const void* wh, const void* b,
                                void* h_out, void* c_out, int B, int I, int H,
                                int device, void* stream) {
  if (B == 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = H < 256 ? ((H + 31) / 32) * 32 : 256;
  const size_t smem = static_cast<size_t>(I + H) * sizeof(float);
  lstm_cell_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), I, H);
  return static_cast<int>(cudaGetLastError());
}
