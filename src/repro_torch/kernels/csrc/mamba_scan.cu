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
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int P = 8;     // steps whose loads are in flight ahead of the computed ones

template <int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int S, int D,
                  long long total) {
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
  load(0);
  for (int t0 = 0; t0 < S; t0 += P) {
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

template <int N>
int launch(const void* log_a, const void* b, const void* c, const void* state0, void* y,
           void* state, int B, int S, int D, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * D * N;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mamba_scan_kernel<N><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(state0), static_cast<float*>(y),
      static_cast<float*>(state), S, D, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// log_a, b [B, S, D, N]; c [B, S, N]; state0, state [B, D, N]; y [B, S, D]. All
// fp32, contiguous, on one device; N is 1, 2, 4, 8, 16 or 32; S >= 1. The scan
// starts from state0, or from a zero state where state0 is null. Returns the
// cudaError_t of the launch (0 = launched).
int mamba_scan_launch(const void* log_a, const void* b, const void* c, const void* state0,
                      void* y, void* state, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(log_a, b, c, state0, y, state, B, S, D, s);
    case 2: return launch<2>(log_a, b, c, state0, y, state, B, S, D, s);
    case 4: return launch<4>(log_a, b, c, state0, y, state, B, S, D, s);
    case 8: return launch<8>(log_a, b, c, state0, y, state, B, S, D, s);
    case 16: return launch<16>(log_a, b, c, state0, y, state, B, S, D, s);
    case 32: return launch<32>(log_a, b, c, state0, y, state, B, S, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
