// Selective-SSM (Mamba) scan from a given start state: the SSM half of every hymba block.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/mamba_scan.py
//           (mamba_scan / _kernel, pallas_call at line 76). It computes what the
//           reference's oracle src/repro/kernels/ref.py::mamba_scan computes:
//
//   s_t = e^{log_a_t} o s_{t-1} + b_t  (s_0 = state0),   y_t = sum_n s_t[:, n] c_t[n]
//
// with log_a, b [B, S, D, N] fp32 (log_a = dt * A <= 0), c [B, S, N] and the
// start state [B, D, N] (zero when none is given); returns y [B, S, D] and the
// final state [B, D, N].
//
// What bounds it on the H100: bytes. Each (b, t, d, n) reads log_a and b once
// (8 bytes) for about four flops (exp, fma, the product with c, one add of the
// sum over n): half a flop per byte, far below the fp32 CUDA cores' 20. At
// hymba-1.5b's prefill, [4, 640, 1600, 16], the 541 MB moved take 0.16 ms at
// 3.35 TB/s; the 0.3 GFLOP take 0.004 ms.
//
// What the design does about it: the Pallas kernel's chunked form (cumulative
// log decays and an [L, L] pairwise-decay matrix per chunk) is shaped for the
// TPU's vector unit; on the GPU the recurrence is stepped serially, as Mamba's
// own CUDA selective_scan does. One thread per (b, d, n), 128 threads a block:
// the N lanes of a channel sit side by side in one warp and the state stays in
// a register for the whole sequence. Each step is s = fma(exp(la), s, b); the
// products s * c[n] are summed over the N lanes with __shfl_xor_sync and lane
// 0 writes y. Consecutive threads read consecutive addresses (n, then d), so
// every load is coalesced. The loads of the next P = 8 steps are issued before
// the current P steps are computed, so a device-memory round trip is spread
// over P steps instead of paid on each. N is a power of two up to 32 (a
// template parameter); any S, B and D. The start state is read once (none:
// zero) and the final state written once.
// Reading log_a and b as dt and B x (4N times fewer bytes) is later work.
//
// Training: the forward may also write the state before every chunk of CK =
// 16 steps (ckpt [B, ceil(S / CK), D, N], chunk 0's the start state), a
// twentieth of the states at hymba-1.5b's training shape; the backward kernel
// (mamba_scan_bwd_kernel) walks the chunks from the last, recomputes a
// chunk's 16 states from its checkpoint in registers with the forward's own
// fmaf(expf(la), s, b), and then steps back through them:
//
//   g_t = dy_t c_t + e^{log_a_{t+1}} g_{t+1}   (g_{S-1} = dy_{S-1} c_{S-1})
//   db_t = g_t,  dlog_a_t = g_t e^{log_a_t} s_{t-1},  dc_t = sum_D s_t dy_t,
//   dstate0 = e^{log_a_0} g_0.
//
// Training never differentiates the final state, so its cotangent is zero.
// The state is never found by dividing by e^{log_a}, which underflows to 0.
// One thread per (b, d, n) as in the forward; the chunk's log_a and b are
// loaded in one burst (16 independent loads in flight), then dy and c. dc
// sums over all D channels, which lie in other blocks: each block adds its
// channels' s_t dy_t over the lanes of a warp (shuffles) and its warps in
// shared memory, in a fixed order, and writes one partial sum per (block,
// t, n) (mamba_scan_bwd_blocks gives the caller the block count that sizes
// them); mamba_scan_dc_kernel adds a row's partials in block order. No
// atomics, so the gradients are the same bit for bit call after call (the
// training step's CUDA graph is held to the eager step with torch.equal).
// What bounds it: bytes. log_a and b read once, dlog_a and db written once
// (16 B a (b, t, d, n)), dy, c, the checkpoints and the partials besides:
// about 1.1 GB at hymba-1.5b's [4, 640, 1600, 16], 0.32 ms at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int P = 8;     // steps whose loads are in flight ahead of the computed ones
constexpr int CK = 16;   // steps a training checkpoint covers (a multiple of P)

template <int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, float* __restrict__ ckpt,
                  int S, int D, long long total) {
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  // Threads past the end compute on element 0 and store nothing, so every lane
  // of a warp takes part in the shuffles.
  const bool valid = g < total;
  const long long gg = valid ? g : 0;
  const int n = static_cast<int>(gg % N);
  const long long bd = gg / N;                       // b * D + d
  const long long bi = bd / D;
  const long long d = bd - bi * D;
  const long long DN = static_cast<long long>(D) * N;
  const float* la_p = log_a + bi * S * DN + d * N + n;
  const float* b_p = b + bi * S * DN + d * N + n;
  const float* c_p = c + bi * S * N + n;
  float* y_p = y + bi * S * D + d;

  float la_n[P], b_n[P], c_n[P];                     // the next P steps
  auto load = [&](int t0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long t = t0 + p;
      const bool in = t < S;
      la_n[p] = in ? la_p[t * DN] : 0.0f;
      b_n[p] = in ? b_p[t * DN] : 0.0f;
      c_n[p] = in ? c_p[t * N] : 0.0f;
    }
  };

  float s = s0 != nullptr && valid ? s0[g] : 0.0f;    // [B, D, N]: element g
  // ckpt [B, n_chunks, D, N]: the state before chunk t0 / CK
  const long long n_chunks = (S + CK - 1) / CK;
  float* ck_p = ckpt == nullptr ? nullptr : ckpt + bi * n_chunks * DN + d * N + n;
  load(0);
  for (int t0 = 0; t0 < S; t0 += P) {
    if (ck_p != nullptr && t0 % CK == 0 && valid) ck_p[(t0 / CK) * DN] = s;
    float la_c[P], b_c[P], c_c[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      la_c[p] = la_n[p];
      b_c[p] = b_n[p];
      c_c[p] = c_n[p];
    }
    if (t0 + P < S) load(t0 + P);                    // in flight while these P step
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (t0 + p < S) {                              // the same for every thread
        s = fmaf(expf(la_c[p]), s, b_c[p]);
        float v = s * c_c[p];
#pragma unroll
        for (int x = N / 2; x > 0; x >>= 1) v += __shfl_xor_sync(0xffffffffu, v, x, N);
        if (n == 0 && valid) y_p[static_cast<long long>(t0 + p) * D] = v;
      }
    }
  }
  if (valid) s_out[g] = s;                           // [B, D, N]: element g
}

// Four blocks an SM (at most 128 registers a thread): left free, ptxas takes
// 145 for the chunk's 64 staged values, three blocks fit, and the loads in
// flight that bound the kernel drop by a quarter.
template <int N>
__global__ void __launch_bounds__(THREADS, 4)
mamba_scan_bwd_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                      const float* __restrict__ c, const float* __restrict__ ckpt,
                      const float* __restrict__ dy, float* __restrict__ dla, float* __restrict__ db,
                      float* __restrict__ ds0, float* __restrict__ dc_part, int S, int D) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[WARPS][CK][N];          // a chunk's per-warp sums of s_t dy_t
  const int bi = blockIdx.y;                   // batch row
  const long long DN = static_cast<long long>(D) * N;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  // threads past the row's end compute on element 0 with dy = 0 and store nothing
  const bool valid = e < DN;
  const long long ee = valid ? e : 0;
  const int n = static_cast<int>(ee % N);
  const long long d = ee / N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_chunks = (S + CK - 1) / CK;
  const long long row = static_cast<long long>(bi) * S;   // (b, t = 0)
  const float* la_p = log_a + row * DN + ee;
  const float* b_p = b + row * DN + ee;
  const float* c_p = c + row * N + n;
  const float* dy_p = dy + row * D + d;
  float* dla_p = dla + row * DN + ee;
  float* db_p = db + row * DN + ee;
  const float* ck_p = ckpt + static_cast<long long>(bi) * n_chunks * DN + ee;
  // dc_part [B, blocks, S, N]
  float* part = dc_part + (static_cast<long long>(bi) * gridDim.x + blockIdx.x) * S * N;

  float carry = 0.0f;                          // e^{la_{t+1}} g_{t+1}
  for (long long ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = static_cast<int>(ch * CK);
    const int steps = min(CK, S - t0);
    float a[CK], st[CK], dyv[CK], cv[CK];
#pragma unroll
    for (int i = 0; i < CK; ++i) {             // the chunk's inputs, in one burst
      const bool in = i < steps;
      a[i] = in ? la_p[(t0 + i) * DN] : 0.0f;
      st[i] = in ? b_p[(t0 + i) * DN] : 0.0f;
      dyv[i] = in && valid ? dy_p[static_cast<long long>(t0 + i) * D] : 0.0f;
      cv[i] = in ? c_p[(t0 + i) * N] : 0.0f;
    }
    const float s_in = ck_p[ch * DN];          // the state before the chunk
    float s = s_in;
#pragma unroll
    for (int i = 0; i < CK; ++i) {             // the forward's states, recomputed
      if (i < steps) {
        const float ai = expf(a[i]);
        s = fmaf(ai, s, st[i]);
        a[i] = ai;
        st[i] = s;
      }
    }
#pragma unroll
    for (int i = CK - 1; i >= 0; --i) {
      float v = 0.0f;
      if (i < steps) {
        const float g = fmaf(dyv[i], cv[i], carry);
        const float prev = i > 0 ? st[i - 1] : s_in;
        if (valid) {
          db_p[(t0 + i) * DN] = g;
          dla_p[(t0 + i) * DN] = g * a[i] * prev;
        }
        carry = a[i] * g;
        v = st[i] * dyv[i];
      }
      // the warp's channels: lanes n, n + N, ... share n
#pragma unroll
      for (int x = N; x < 32; x <<= 1) v += __shfl_xor_sync(0xffffffffu, v, x);
      if (lane < N) red[warp][i][lane] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * N; i += THREADS) {
      const int tt = i / N, nn = i - tt * N;
      float sum = red[0][tt][nn];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum += red[w][tt][nn];
      part[static_cast<long long>(t0 + tt) * N + nn] = sum;
    }
    __syncthreads();                           // red is free for the next chunk
  }
  if (valid) ds0[bi * DN + e] = carry;
}

// the blocks of a batch row in the backward, which the dc partials are sized by
long long bwd_blocks(int D, int N) {
  return (static_cast<long long>(D) * N + THREADS - 1) / THREADS;
}

// dc[b, t, n] = the sum of the blocks' partials of row b, in block order
__global__ void __launch_bounds__(256)
mamba_scan_dc_kernel(const float* __restrict__ dc_part, float* __restrict__ dc, int S, int N,
                     int blocks, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const long long SN = static_cast<long long>(S) * N;
  const long long bi = i / SN;
  const float* p = dc_part + bi * blocks * SN + (i - bi * SN);
  float sum = p[0];
  for (int k = 1; k < blocks; ++k) sum += p[k * SN];
  dc[i] = sum;
}

template <int N>
int launch_bwd(const void* log_a, const void* b, const void* c, const void* ckpt,
               const void* dy, void* dla, void* db, void* dc, void* ds0, void* dc_part, int B,
               int S, int D, cudaStream_t stream) {
  const long long blocks = bwd_blocks(D, N);
  if (blocks > 0x7fffffffLL || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  mamba_scan_bwd_kernel<N><<<dim3(static_cast<unsigned>(blocks), B), THREADS, 0, stream>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(ckpt),
      static_cast<const float*>(dy), static_cast<float*>(dla), static_cast<float*>(db),
      static_cast<float*>(ds0), static_cast<float*>(dc_part), S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * S * N;
  mamba_scan_dc_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dc_part), static_cast<float*>(dc), S, N,
      static_cast<int>(blocks), total);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(const void* log_a, const void* b, const void* c, const void* state0, void* y,
           void* state, void* ckpt, int B, int S, int D, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * D * N;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mamba_scan_kernel<N><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(state0), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<float*>(ckpt), S, D, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// log_a, b [B, S, D, N]; c [B, S, N]; state0, state [B, D, N]; y [B, S, D]. All
// fp32, contiguous, on one device; N is 1, 2, 4, 8, 16 or 32; S >= 1. The scan
// starts from state0, or from a zero state where state0 is null. ckpt: null
// (serving), or [B, ceil(S / 16), D, N] for the state before every chunk of 16
// steps (training). Returns the cudaError_t of the launch (0 = launched).
int mamba_scan_launch(const void* log_a, const void* b, const void* c, const void* state0,
                      void* y, void* state, void* ckpt, int B, int S, int D, int N,
                      void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(log_a, b, c, state0, y, state, ckpt, B, S, D, s);
    case 2: return launch<2>(log_a, b, c, state0, y, state, ckpt, B, S, D, s);
    case 4: return launch<4>(log_a, b, c, state0, y, state, ckpt, B, S, D, s);
    case 8: return launch<8>(log_a, b, c, state0, y, state, ckpt, B, S, D, s);
    case 16: return launch<16>(log_a, b, c, state0, y, state, ckpt, B, S, D, s);
    case 32: return launch<32>(log_a, b, c, state0, y, state, ckpt, B, S, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: log_a, b [B, S, D, N], c [B, S, N] and ckpt (the forward's
// checkpoints) as above; dy [B, S, D] (the final state's cotangent is zero).
// Writes dlog_a, db [B, S, D, N], dc [B, S, N], dstate0 [B, D, N]; dc_part is
// fp32 scratch [B, mamba_scan_bwd_blocks(D, N), S, N]. Returns the
// cudaError_t of the launches.
int mamba_scan_bwd_launch(const void* log_a, const void* b, const void* c, const void* ckpt,
                          const void* dy, void* dlog_a, void* db, void* dc, void* dstate0,
                          void* dc_part, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using Bwd = int (*)(const void*, const void*, const void*, const void*, const void*, void*,
                      void*, void*, void*, void*, int, int, int, cudaStream_t);
  const Bwd fn = N == 1 ? &launch_bwd<1> : N == 2 ? &launch_bwd<2> : N == 4 ? &launch_bwd<4>
                 : N == 8 ? &launch_bwd<8> : N == 16 ? &launch_bwd<16>
                 : N == 32 ? &launch_bwd<32> : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(log_a, b, c, ckpt, dy, dlog_a, db, dc, dstate0, dc_part, B, S, D,
            static_cast<cudaStream_t>(stream));
}

// the training checkpoints' spacing, which the caller sizes ckpt by
int mamba_scan_chunk() { return CK; }

// the backward's blocks per batch row, which the caller sizes dc_part by
long long mamba_scan_bwd_blocks(int D, int N) { return bwd_blocks(D, N); }

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
