// RWKV-6 wkv recurrence with state carry (the time-mix core of every rwkv block).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/rwkv_scan.py
//           (rwkv_scan / _kernel, pallas_call at line 86). It computes what the
//           reference's oracle src/repro/kernels/ref.py::rwkv_scan computes:
//
//   out_t = r_t (S_{t-1} + u o k_t v_t^T),   S_t = e^{lw_t} o S_{t-1} + k_t v_t^T
//
// with r, k, v, lw [N, S, hd] fp32 (lw = log decay <= 0), u [N, 1, hd] and the
// state [N, hd, hd] indexed [k, v]; returns out [N, S, hd] and the final state.
//
// What bounds it on the H100: bytes. Each step of each sequence n reads four hd
// vectors and writes one (20 hd bytes) and does about 5 hd^2 flops of state
// work (r.S and the decayed rank-one update): hd / 4 = 16 flops per byte at
// hd = 64, below the fp32 CUDA cores' 67e12 / 3.35e12 = 20. At N = 256,
// S = 512 the 176 MB moved take 0.053 ms, the 2.7 GFLOP 0.040 ms.
//
// What the design does about it: the Pallas kernel's chunked form (an
// [L, L, hd] pairwise-decay matrix per chunk) is shaped for the TPU's matrix
// unit; on the GPU the recurrence is stepped serially, as the official CUDA
// wkv6 kernels do. One block per sequence n, hd threads; thread j keeps column
// S[:, j] of the state in registers for the whole sequence, so the state is
// read from device memory once (state0) and written once (the final state).
// Inputs move in blocks of P = 8 steps: thread j loads r, k, lw, v of the
// next P steps at column j into registers (4P loads in flight, coalesced
// across j) while the block steps through the current P, then stages them in
// shared memory as r, k, e^{lw}, u o k and v (double-buffered, one barrier per
// P steps); every thread reads the staged rows as broadcasts. A step's load
// latency from device memory is so spread over P steps of arithmetic, and
// each input element is read exactly once. The r.S sum runs as four partial
// sums, so its dependent chain is hd / 4 long. Any S; hd is a template
// parameter (8, 16, 32, 64) so the state column stays in registers. Tensor
// cores (the chunked form as mma) and more than one block per sequence are
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int P = 8;     // steps staged per barrier

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ s_out, int S) {
  __shared__ __align__(16) float sr[2][P][HD];
  __shared__ __align__(16) float sk[2][P][HD];
  __shared__ __align__(16) float sw[2][P][HD];    // e^{lw}
  __shared__ __align__(16) float suk[2][P][HD];   // u o k
  __shared__ __align__(16) float sv[2][P][HD];
  const int j = threadIdx.x;
  const long n = blockIdx.x;
  const long base = n * static_cast<long>(S) * HD + j;
  const int n_blocks = (S + P - 1) / P;

  float st[HD];                                // column j of the state: st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = s0[(n * HD + i) * HD + j];
  const float uj = u[n * HD + j];

  float rn[P], kn[P], lwn[P], vn[P];           // the next P steps at column j
  auto load = [&](int c) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int t = c * P + p;
      const long o = base + static_cast<long>(t) * HD;
      rn[p] = t < S ? r[o] : 0.0f;
      kn[p] = t < S ? k[o] : 0.0f;
      lwn[p] = t < S ? lw[o] : 0.0f;
      vn[p] = t < S ? v[o] : 0.0f;
    }
  };
  auto stage = [&](int b) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sr[b][p][j] = rn[p];
      sk[b][p][j] = kn[p];
      sw[b][p][j] = expf(lwn[p]);
      suk[b][p][j] = uj * kn[p];
      sv[b][p][j] = vn[p];
    }
  };

  load(0);
  stage(0);
  __syncthreads();
  for (int c = 0; c < n_blocks; ++c) {
    const int b = c & 1;
    if (c + 1 < n_blocks) load(c + 1);         // in flight while this block steps
    const int steps = min(P, S - c * P);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < steps) {
        const float vj = sv[b][p][j];
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < HD; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&sr[b][p][i]);
          const float4 k4 = *reinterpret_cast<const float4*>(&sk[b][p][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&sw[b][p][i]);
          const float4 uk4 = *reinterpret_cast<const float4*>(&suk[b][p][i]);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
          const float uk[4] = {uk4.x, uk4.y, uk4.z, uk4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // r_i (S[i][j] + u_i k_i v_j), then S[i][j] <- w_i S[i][j] + k_i v_j
            acc[q] = fmaf(rr[q], fmaf(uk[q], vj, st[i + q]), acc[q]);
            st[i + q] = fmaf(ww[q], st[i + q], kk[q] * vj);
          }
        }
        out[base + static_cast<long>(c * P + p) * HD] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    if (c + 1 < n_blocks) stage(b ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[(n * HD + i) * HD + j] = st[i];
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* out, void* s_out, int N, int S, cudaStream_t stream) {
  rwkv_scan_kernel<HD><<<N, HD, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_out), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, lw [N, S, hd]; u [N, 1, hd]; state0 and state_out [N, hd, hd]
// ([k, v] index order); out [N, S, hd]. All fp32, contiguous, on one device;
// hd is 8, 16, 32 or 64; S >= 1. Returns the cudaError_t of the launch (0 = launched).
int rwkv_scan_launch(const void* r, const void* k, const void* v, const void* lw,
                     const void* u, const void* state0, void* out, void* state_out,
                     int N, int S, int hd, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(r, k, v, lw, u, state0, out, state_out, N, S, s);
    case 16: return launch<16>(r, k, v, lw, u, state0, out, state_out, N, S, s);
    case 32: return launch<32>(r, k, v, lw, u, state0, out, state_out, N, S, s);
    case 64: return launch<64>(r, k, v, lw, u, state0, out, state_out, N, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
