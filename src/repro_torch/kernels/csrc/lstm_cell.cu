// One fused LSTM step, the REINFORCE policy step, and its gradient.
//
// `lstm_cell_kernel` replaces the TPU kernel `lstm_cell_padded` /
// `_lstm_kernel` in src/repro/kernels/lstm_cell.py.  For x (B, I), h and c
// (B, H), wx (I, 4H), wh (H, 4H) and b (4H,), all float32:
//
//   gates = x @ wx + h @ wh + b            gate order i, f, g, o
//   c' = sig(f) * c + sig(i) * tanh(g)     sig(z) = 1 / (1 + exp(-z))
//   h' = sig(o) * tanh(c')
//
// Both matrix products are computed in the kernel's own body, and the
// gate pre-activations never leave the block.  It also writes the
// activated gates and tanh(c'), (5, B, H) = sig(i), sig(f), tanh(g),
// sig(o), tanh(c'), which the backward reads.
//
// `lstm_cell_bwd_kernel` is that backward, which the TPU package does not
// have (JAX cannot differentiate through its own LSTM kernel): from the
// saved gates and the upstream dh', dc' it computes
//
//   dc_tot = dc' + dh' * o * (1 - tanh(c')^2)
//   dG = [dc_tot g i (1-i) | dc_tot c f (1-f) | dc_tot i (1-g^2) |
//         dh' tanh(c') o (1-o)]                                  (B, 4H)
//   dx = dG wx^T   dh = dG wh^T   dc = dc_tot f
//   dwx = x^T dG   dwh = h^T dG   db = sum_B dG
//
// Bound on an H100: bytes, and in practice launch latency.  The search
// steps one episode at a time (B = 1, I = 10, H = 128): about 141 thousand
// float operations against 285 KB of weights, which take about 85 ns at
// 3.35 TB/s (and stay in the 50 MB L2 across an episode's 53 steps).  A
// single block (the first design) paced the whole read through one SM's
// load pipe.  Design now, forward: the 4H gate columns are split across
// blocks, each owning kUnits hidden units and all four of their gates, so
// the nonlinearity and c', h' stay in the block (32 blocks at H = 128);
// the I + H reduction is split across the block's 8 warps and the two
// halves of each warp, a half-warp lane being one of the block's 16
// columns, so a warp reads two weight rows per load as eight 16-byte runs;
// each lane issues its loads (10 at H = 128) before x and h are even
// staged, so one L2 round trip covers them; the partial sums meet through
// a shuffle and shared memory and are added in a fixed order.  A grid row
// of blocks takes kRows batch rows and reuses each weight it loads for all
// of them; past 48 KB of staged rows (I + H > 2928) the block opts in to
// the card's larger shared memory, up to I + H = kMaxK.
//
// Backward, bound on an H100: the same bytes (the weights read once, their
// gradients written once: 1.71e-4 ms at (1, 10, 128)), and in practice
// the launch and the dependent round trips to L2.  Stage 1 replays its
// epoch as a CUDA graph, so what the step pays is this device time, not
// the host's.  The first design staged a block's weight rows and only
// then loaded the gates to build dG, two round trips one after the other,
// and paid tile index arithmetic (a division and a remainder per element)
// even where one tile held every column: 6.3 µs a launch at (1, 10, 128).
// Design now, single pass (B <= kUntiledMaxB and 4H <= kUntiledMaxCols x
// kThreads, which holds the search's step): the rows k of [wx; wh] (and
// db as row I + H) are split across blocks, kUntiledRows a block (one:
// 139 blocks at (1, 10, 128), the fastest of 1, 2, 4 and 8 in
// tools/tune_lstm_bwd.py); a thread owns up to C gate columns and issues
// every load it needs -- its columns of the block's weight rows, the
// saved gates, c, dh' and dc' of its hidden units, the block's x / h
// values -- before the first use, so one round trip covers them; it forms
// dG in registers (no shared-memory staging, no per-element index
// arithmetic), writes its columns of the block's dwx / dwh / db rows
// (sums over the batch in row order), and its share of each dx / dh goes
// through the warp's shuffles and one pass over shared memory in warp
// order.  Otherwise the tiled kernel: every block builds dG for a chunk
// of batch rows and a tile of hidden units (all 4H columns when they fit)
// in shared memory, kKRows weight rows a block, writes its rows of
// dwx / dwh / db in that tile, each a sum over the batch, and adds the
// tile's share to its columns of dx / dh, each a dot product of a dG row
// with its staged weight row (one warp each, reduced by shuffles in a
// fixed order).  Batch chunks and hidden-unit tiles keep the block within
// 48 KB for any H.  In both, every output is written by one thread, with
// no atomics, so two calls give the same bits.
// Everything is float32 on CUDA cores: tensor cores would round the
// products, and the port holds the step to atol 1e-5.  The nonlinearities
// use the precise expf and tanhf (the library is built without
// --use_fast_math).
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kUnits = 4;              // hidden units per forward block
constexpr int kCols = 4 * kUnits;      // its gate columns: half a warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;               // batch rows per forward block
constexpr int kStep = 2 * kWarps;      // weight rows between a lane's loads
constexpr int kBatch = 10;             // a lane's loads in flight at once
constexpr int kKRows = 4;              // weight rows per tiled backward block
constexpr int kBwdRows = 4;            // batch rows with hidden-unit tiles
// The single-pass backward: weight rows per block (tools/tune_lstm_bwd.py
// times 1, 2, 4 and 8 at the search's shape), and the shapes it takes:
// at most kUntiledMaxB batch rows, and 4H gate columns at most
// kUntiledMaxCols per thread.
constexpr int kUntiledRows = 1;
constexpr int kUntiledMaxB = 32;
constexpr int kUntiledMaxCols = 10;
// Dynamic shared memory a block may take without opting in to more.
constexpr long long kSmemLimit = 48 * 1024;
// The largest I + H the forward takes (the port's first kernel's limit);
// its rows then need 194 KB, within the 227 KB an sm_90 block may opt in to.
constexpr int kMaxK = 12288;

constexpr long long fwd_smem(int K) {
  return 4LL * (kRows * K + kWarps * kRows * kCols + kRows * kCols);
}

__device__ __forceinline__ float sig(float z) { return 1.0f / (1.0f + expf(-z)); }

// dst[i] = value(i) for i < n across the block, with kStage loads in flight
// per thread before the first store: a plain loop would wait for each load
// before it stores and loads again.
constexpr int kStage = 8;
template <class F>
__device__ __forceinline__ void stage(float* dst, int n, F value) {
  for (int base = threadIdx.x; base < n; base += kThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int idx = base + i * kThreads;
      v[i] = idx < n ? value(idx) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int idx = base + i * kThreads;
      if (idx < n) dst[idx] = v[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ b,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ gates_out, int B, int I, int H) {
  extern __shared__ float smem[];
  const int K = I + H, H4 = 4 * H;
  float* sv = smem;                          // (kRows, K): [x | h] rows
  float* red = sv + kRows * K;               // (kWarps, kRows, kCols)
  float* pre = red + kWarps * kRows * kCols; // (kRows, kCols)
  const int j0 = blockIdx.y * kUnits;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Lane -> weight row parity (lane / kCols) and gate column: gate
  // q = l / kUnits, hidden unit j0 + l % kUnits, l = lane % kCols.  A warp
  // reads two weight rows per load, each as four 16-byte runs.
  const int l = lane % kCols;
  const int j = j0 + l % kUnits;
  const int col = (l / kUnits) * H + j;
  const bool live = j < H;
  int k0 = 2 * warp + lane / kCols;          // this lane's first row
  float w[kBatch];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = base + i * kStep;
      w[i] = !live || k >= K ? 0.0f
             : (k < I ? __ldg(wx + k * H4 + col)
                      : __ldg(wh + (k - I) * H4 + col));
    }
  };
  load(k0);   // the first loads fly while x and h are staged

  stage(sv, nr * K, [&](int idx) {
    const int r = idx / K, k = idx % K;
    return k < I ? x[(r0 + r) * I + k] : h[(r0 + r) * H + k - I];
  });
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  while (true) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = k0 + i * kStep;
      if (k < K) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nr) acc[r] = fmaf(sv[r * K + k], w[i], acc[r]);
      }
    }
    k0 += kBatch * kStep;
    if (k0 >= K) break;
    load(k0);
  }
  // The two row parities of a warp, then the warps in a fixed order.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], kCols);
    if (lane < kCols) red[(warp * kRows + r) * kCols + lane] = acc[r];
  }
  __syncthreads();

  // The warps' partial sums, in warp order, plus the bias.
  if (tid < kRows * kCols) {
    const int r = tid / kCols, q = tid % kCols;
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[(v * kRows + r) * kCols + q];
    const int jj = j0 + q % kUnits;
    pre[r * kCols + q] = jj < H ? s + __ldg(b + (q / kUnits) * H + jj) : 0.0f;
  }
  __syncthreads();

  if (tid < kRows * kUnits) {
    const int r = tid / kUnits, u = tid % kUnits, jj = j0 + u;
    if (r < nr && jj < H) {
      const int row = r0 + r;
      const float* p = pre + r * kCols + u;
      const float gi = sig(p[0]);
      const float gf = sig(p[kUnits]);
      const float gg = tanhf(p[2 * kUnits]);
      const float go = sig(p[3 * kUnits]);
      const float c_new = gf * c[row * H + jj] + gi * gg;
      const float tc = tanhf(c_new);
      c_out[row * H + jj] = c_new;
      h_out[row * H + jj] = go * tc;
      const int BH = B * H;
      float* s = gates_out + row * H + jj;
      s[0] = gi;
      s[BH] = gf;
      s[2 * BH] = gg;
      s[3 * BH] = go;
      s[4 * BH] = tc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c,
                     const float* __restrict__ wx,
                     const float* __restrict__ wh,
                     const float* __restrict__ gates,
                     const float* __restrict__ dh_new,
                     const float* __restrict__ dc_new,
                     float* __restrict__ dx, float* __restrict__ dh,
                     float* __restrict__ dc, float* __restrict__ dwx,
                     float* __restrict__ dwh, float* __restrict__ db, int B,
                     int I, int H, int chunk, int U) {
  extern __shared__ float smem[];
  const int K = I + H, H4 = 4 * H, U4 = 4 * U;
  const int k0 = blockIdx.x * kKRows;
  const int nk = min(kKRows, K + 1 - k0);   // row K is db's
  float* sw = smem;                          // (kKRows, 4 nu) weight rows
  float* sg = sw + kKRows * U4;              // (chunk, 4U) dG
  float* sv = sg + chunk * U4;               // (kKRows, chunk) x / h / 1
  float* sd = sv + kKRows * chunk;           // (kKRows, chunk) dx / dh sums
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int BH = B * H;

  // A tile holds hidden units u0 .. u0 + nu - 1 and their four gate
  // columns, tile column t = q * nu + u for gate q; with one tile (U = H)
  // that is the gate column itself.
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int nb = min(chunk, B - b0);
    for (int u0 = 0; u0 < H; u0 += U) {
      const int nu = min(U, H - u0), T = 4 * nu;
      const bool last = u0 + nu == H;
      // The previous tile's dG and weight rows are read by now.  (Before
      // the first no barrier is needed, so its loads fly together.)
      if (b0 > 0 || u0 > 0) __syncthreads();
      if (b0 == 0 || U < H)
        stage(sw, nk * T, [&](int idx) {
          const int kk = idx / T, t = idx % T, k = k0 + kk;
          const int col = (t / nu) * H + u0 + t % nu;
          return k < I ? __ldg(wx + k * H4 + col)
                       : (k < K ? __ldg(wh + (k - I) * H4 + col) : 0.0f);
        });
      for (int idx = tid; idx < nb * nu; idx += kThreads) {
        const int r = idx / nu, u = idx % nu, jj = u0 + u, row = b0 + r;
        const float* g = gates + row * H + jj;
        const float gi = g[0], gf = g[BH], gg = g[2 * BH], go = g[3 * BH],
                    tc = g[4 * BH];
        const float dhn = dh_new[row * H + jj];
        const float dct = dc_new[row * H + jj] + dhn * go * (1.0f - tc * tc);
        float* d = sg + r * U4 + u;
        d[0] = dct * gg * gi * (1.0f - gi);
        d[nu] = dct * c[row * H + jj] * gf * (1.0f - gf);
        d[2 * nu] = dct * gi * (1.0f - gg * gg);
        d[3 * nu] = dhn * tc * go * (1.0f - go);
        // dc[:, jj] belongs to the block that owns wh's row jj.
        if (I + jj >= k0 && I + jj < k0 + nk) dc[row * H + jj] = dct * gf;
      }
      if (u0 == 0)
        for (int idx = tid; idx < nk * nb; idx += kThreads) {
          const int kk = idx / nb, r = idx % nb, k = k0 + kk, row = b0 + r;
          sv[kk * chunk + r] = k < I ? x[row * I + k]
                                     : (k < K ? h[row * H + k - I] : 1.0f);
        }
      __syncthreads();

      // Rows of dwx / dwh / db in the tile: a sum over the batch, carried
      // across chunks in the output itself (one thread owns each element).
      for (int idx = tid; idx < nk * T; idx += kThreads) {
        const int kk = idx / T, t = idx % T, k = k0 + kk;
        const int col = (t / nu) * H + u0 + t % nu;
        float* dst = k < I ? dwx + k * H4 + col
                           : (k < K ? dwh + (k - I) * H4 + col : db + col);
        float acc = b0 == 0 ? 0.0f : *dst;
        for (int r = 0; r < nb; ++r)
          acc = fmaf(sv[kk * chunk + r], sg[r * U4 + t], acc);
        *dst = acc;
      }
      // Columns of dx / dh: one warp per (weight row, batch row) pair, the
      // tiles' shares added in tile order.
      for (int p = warp; p < nk * nb; p += kWarps) {
        const int kk = p / nb, r = p % nb, k = k0 + kk;
        if (k >= K) continue;
        const float* gr = sg + r * U4;
        const float* wr = sw + kk * T;
        float s = 0.0f;
        for (int t = lane; t < T; t += 32) s = fmaf(gr[t], wr[t], s);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) {
          float* sum = sd + kk * chunk + r;
          if (u0 > 0) s += *sum;
          if (!last) {
            *sum = s;
          } else {
            const int row = b0 + r;
            if (k < I)
              dx[row * I + k] = s;
            else
              dh[row * H + k - I] = s;
          }
        }
      }
    }
  }
}


// The backward in one pass, for 4H <= kUntiledMaxCols * kThreads gate
// columns and B <= kUntiledMaxB: a block owns R rows of [wx; wh] (row K is
// db's), a thread up to C gate columns, col = tid + i * kThreads.  All its
// loads -- its columns of the block's weight rows, of the saved gates, c,
// dh' and dc', and the block's x / h values -- are issued before the first
// use, so one round trip covers them; dG stays in registers.
template <int R, int C>
__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_untiled_kernel(
    const float* __restrict__ x, const float* __restrict__ h,
    const float* __restrict__ c, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ gates,
    const float* __restrict__ dh_new, const float* __restrict__ dc_new,
    float* __restrict__ dx, float* __restrict__ dh, float* __restrict__ dc,
    float* __restrict__ dwx, float* __restrict__ dwh, float* __restrict__ db,
    int B, int I, int H) {
  __shared__ float red[kWarps][R][kUntiledMaxB];   // dx / dh per warp
  const int K = I + H, H4 = 4 * H, BH = B * H;
  const int k0 = blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Column i: gate q[i], hidden unit j[i]; the gate's own activation and
  // the other factor of its dG (tanh(g) for i, c for f, sig(i) for g).
  int q[C], j[C];
  float w[R][C], acc[R][C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int col = tid + i * kThreads;
    q[i] = col < H4 ? col / H : -1;
    j[i] = col - max(q[i], 0) * H;
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      const int k = k0 + kk;
      w[kk][i] = q[i] < 0 || k >= K ? 0.0f
                 : (k < I ? __ldg(wx + k * H4 + col)
                          : __ldg(wh + (k - I) * H4 + col));
      acc[kk][i] = 0.0f;
    }
  }

  for (int r = 0; r < B; ++r) {
    const int rh = r * H;
    float own[C], oth[C], dhn[C], dcn[C], go[C], tc[C], v[R];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (q[i] < 0) continue;
      const int u = rh + j[i];
      own[i] = gates[q[i] * BH + u];
      oth[i] = q[i] == 1 ? c[u] : gates[(q[i] == 0 ? 2 : 0) * BH + u];
      dhn[i] = dh_new[u];
      dcn[i] = dc_new[u];
      go[i] = gates[3 * BH + u];
      tc[i] = gates[4 * BH + u];
    }
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      const int k = k0 + kk;
      v[kk] = k < I ? x[r * I + k] : (k < K ? h[rh + k - I] : 1.0f);
    }
    float g[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      g[i] = 0.0f;
      if (q[i] < 0) continue;
      const float a = own[i];
      const float dct = dcn[i] + dhn[i] * go[i] * (1.0f - tc[i] * tc[i]);
      if (q[i] < 2)
        g[i] = dct * oth[i] * a * (1.0f - a);
      else if (q[i] == 2)
        g[i] = dct * oth[i] * (1.0f - a * a);
      else
        g[i] = dhn[i] * tc[i] * a * (1.0f - a);
      // dc[:, j] belongs to the block that owns wh's row j.
      if (q[i] == 1 && I + j[i] >= k0 && I + j[i] < k0 + R)
        dc[rh + j[i]] = dct * a;
    }
    // Rows of dwx / dwh / db: a sum over the batch, in row order.
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
#pragma unroll
      for (int i = 0; i < C; ++i) acc[kk][i] = fmaf(v[kk], g[i], acc[kk][i]);
    }
    // This row's dx / dh: the thread's columns, then the warp's lanes.
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < C; ++i) s = fmaf(g[i], w[kk][i], s);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp][kk][r] = s;
    }
  }

#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    const int k = k0 + kk;
    if (k > K) break;
    float* dst = k < I ? dwx + k * H4 : (k < K ? dwh + (k - I) * H4 : db);
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (q[i] >= 0) dst[tid + i * kThreads] = acc[kk][i];
  }
  __syncthreads();
  // The warps' shares of dx / dh, in warp order.
  for (int p = tid; p < R * B; p += kThreads) {
    const int kk = p / B, r = p % B, k = k0 + kk;
    if (k >= K) continue;
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[v][kk][r];
    if (k < I)
      dx[r * I + k] = s;
    else
      dh[r * H + k - I] = s;
  }
}

}  // namespace

// The launch arguments come packed in one array, `a`, which the caller
// fills in one step (a call with few arguments costs the host less): the
// data pointers of x, h, c, wx, wh, b as above and of `out`, then B, I, H,
// with I + H <= kMaxK.  `out` holds h' (B, H), then c' (B, H), then the
// gates (5, B, H).  All float32, contiguous, on card `device`, where
// `stream` lives.  This library carries its own CUDA runtime, so the
// launch selects the device itself.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue past kMaxK.
extern "C" int lstm_cell_launch(const long long* a, int device,
                                void* stream) {
  const int B = static_cast<int>(a[7]), I = static_cast<int>(a[8]),
            H = static_cast<int>(a[9]);
  if (B == 0) return 0;
  if (I + H > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = fwd_smem(I + H);
  if (smem > kSmemLimit) {
    // Raised once per device to what kMaxK needs (a device's bit is set
    // after its first successful call).
    static std::atomic<unsigned> configured{0};
    const unsigned bit = 1u << (device & 31);
    if (!(configured.load(std::memory_order_acquire) & bit)) {
      err = cudaFuncSetAttribute(lstm_cell_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(fwd_smem(kMaxK)));
      if (err != cudaSuccess) return static_cast<int>(err);
      configured.fetch_or(bit, std::memory_order_release);
    }
  }
  const auto in = [&](int i) { return reinterpret_cast<const float*>(a[i]); };
  float* o = reinterpret_cast<float*>(a[6]);
  const long long BH = static_cast<long long>(B) * H;
  const dim3 grid((B + kRows - 1) / kRows, (H + kUnits - 1) / kUnits);
  lstm_cell_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), o, o + BH, o + 2 * BH, B, I,
      H);
  return static_cast<int>(cudaGetLastError());
}

// Packed as for the forward, `a` holds the data pointers of x, h, c, wx,
// wh as above, `gates` (5, B, H) from the forward, dh_new and dc_new
// (B, H), then of the outputs dx, dhc and dw, then B, I, H and the path:
// 0 for the single pass (4H <= kUntiledMaxCols * kThreads and B <=
// kUntiledMaxB, else cudaErrorInvalidValue), 1 for the tiled kernel.
// Outputs: dx (B, I); `dhc` holds dh (B, H) then dc (B, H); `dw` holds dwx
// (I, 4H), dwh (H, 4H) and db (4H,), in that order.
// The tiled kernel holds dG for as many batch rows and hidden units at a
// time as fit in 48 KB of shared memory: all H with as many rows as fit
// where a row fits, else tiles of hidden units for up to kBwdRows rows.
// All float32, contiguous, on card `device`, where `stream` lives.
// Returns cudaGetLastError().
extern "C" int lstm_cell_bwd_launch(const long long* a, int device,
                                    void* stream) {
  const int B = static_cast<int>(a[11]), I = static_cast<int>(a[12]),
            H = static_cast<int>(a[13]);
  const bool tiled = a[14] != 0;
  if (B == 0) return 0;
  const int cols = (4 * H + kThreads - 1) / kThreads;
  if (!tiled && (B > kUntiledMaxB || cols > kUntiledMaxCols))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long H4 = 4LL * H;
  const auto in = [&](int i) { return reinterpret_cast<const float*>(a[i]); };
  float* dx = reinterpret_cast<float*>(a[8]);
  float* dh = reinterpret_cast<float*>(a[9]);
  float* dc = dh + static_cast<long long>(B) * H;
  float* dwx = reinterpret_cast<float*>(a[10]);
  float* dwh = dwx + I * H4;
  float* db = dwh + H * H4;
  const auto st = static_cast<cudaStream_t>(stream);
  if (!tiled) {
    const int blocks = (I + H + 1 + kUntiledRows - 1) / kUntiledRows;
#define LSTM_BWD_UNTILED(C)                                                  \
  lstm_cell_bwd_untiled_kernel<kUntiledRows, C><<<blocks, kThreads, 0, st>>>( \
      in(0), in(1), in(2), in(3), in(4), in(5), in(6), in(7), dx, dh, dc,    \
      dwx, dwh, db, B, I, H)
    if (cols <= 2)
      LSTM_BWD_UNTILED(2);
    else if (cols <= 4)
      LSTM_BWD_UNTILED(4);
    else
      LSTM_BWD_UNTILED(kUntiledMaxCols);
#undef LSTM_BWD_UNTILED
    return static_cast<int>(cudaGetLastError());
  }
  // (kKRows + chunk) rows of 4U floats and two kKRows x chunk tables.
  const long long floats = kSmemLimit / 4;
  long long U = H;
  long long chunk = std::min<long long>(
      B, (floats - kKRows * H4) / (H4 + 2 * kKRows));
  if (chunk < 1) {
    chunk = std::min(B, kBwdRows);
    U = std::min<long long>(
        H, (floats - 2 * kKRows * chunk) / (4 * (kKRows + chunk)));
  }
  const long long smem =
      4 * (4 * U * (kKRows + chunk) + 2 * kKRows * chunk);
  const int blocks = (I + H + 1 + kKRows - 1) / kKRows;
  lstm_cell_bwd_kernel<<<blocks, kThreads, smem, st>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), in(6), in(7), dx, dh, dc, dwx,
      dwh, db, B, I, H, static_cast<int>(chunk), static_cast<int>(U));
  return static_cast<int>(cudaGetLastError());
}
