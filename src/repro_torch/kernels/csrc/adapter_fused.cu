// Fused serial adapter, eq. (1) of RingAda:  out = h + act(h @ W_down) @ W_up
//
// Replaces: the Pallas TPU kernel src/repro/kernels/adapter_fused.py
//           (adapter_fused / _kernel, pallas_call at line 55).
//
// What bounds it on the H100: bytes. The bottleneck m is tiny (64 for
// qwen2.5-3b), so the work is 4*T*D*m flops against 2*T*D*2 bytes of h in and
// out (bf16): about m flops per byte, far below the ~295 the tensor cores need
// before they are the limit. Unfused, h would cross device memory three times
// and the [T, m] intermediate once more. Both products here run on the fp32
// CUDA cores (67 TFLOP/s), because the reference keeps fp32 internals and the
// up-projection has an fp32 left operand; at large T that rate, not the
// memory, is what this simple version meets first.
//
// What the design does about it: one block per tile of BT = 16 rows keeps the
// whole [BT, D] h tile in shared memory (64 KB in bf16 at D = 2048), so h is
// read from device memory once and written once; the [BT, m] intermediate
// never leaves the SM. Where the tile does not fit in the 227 KB a block may
// use (f32 above D = 3312, bf16 above D = 6624: f32 rwkv6-7b at 4096), the
// block reads its rows from device memory instead, once for the
// down-projection and once, mostly from L2, for the residual; the wrapper
// chooses (STAGE) and every width takes the kernel. The down-projection splits the D reduction over the
// warps and sums their parts in shared memory. With bf16 h and W_down it runs
// on the tensor cores (wmma 16x16x16, fp32 accumulation: bf16 products are
// exact in fp32, so only the order of the sum changes); otherwise each thread
// sums a strided part of D on the CUDA cores. The up-projection keeps fp32
// operands on the CUDA cores: each thread owns NC output columns at once, so a
// broadcast of the intermediate from shared memory feeds NC FMAs, and W_up is
// read coalesced. When there are too few row tiles to fill the card (decode,
// T = batch), blockIdx.y splits the output columns; each split recomputes the
// tiny intermediate. Rows past T are masked, never padded. wgmma and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int BT = 16;         // rows of h per block (one wmma tile; ROWS in the wrapper)
constexpr int THREADS = 256;   // THREADS in the wrapper
constexpr int WARPS = THREADS / 32;
constexpr int NC = 4;          // output columns per thread in the up-projection

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 0 = gelu (tanh form, as jax.nn.gelu), 1 = relu, 2 = silu
__device__ __forceinline__ float activate(int act, float x) {
  if (act == 0) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
  }
  if (act == 1) return fmaxf(x, 0.0f);
  return x / (1.0f + expf(-x));
}

// STAGE: the [BT, D] h tile is staged in shared memory; otherwise rows are
// read from device memory (row indices past T clamp to the last row, whose
// results are never stored). TC: down-projection on the tensor cores (needs
// STAGE; bf16 h and W_down, D and m multiples of 16, m <= 128, W_down
// 32-byte aligned).
template <typename TE, bool TC, bool STAGE>
__global__ void __launch_bounds__(THREADS)
adapter_fused_kernel(const TE* __restrict__ h, const TE* __restrict__ wd,
                     const TE* __restrict__ wu, TE* __restrict__ out, int T, int D,
                     int m, int act, int cols_per_split) {
  static_assert(STAGE || !TC, "the tensor-core path reads the staged tile");
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [G][BT][m] partial sums
  float* mid = red + THREADS * BT;              // [BT][m] act(h @ W_down)
  TE* hs = reinterpret_cast<TE*>(mid + BT * m); // [BT][D] the h tile (STAGE)
  const int tid = threadIdx.x;
  const int rows = min(BT, T - static_cast<int>(blockIdx.x) * BT);
  const long row0 = static_cast<long>(blockIdx.x) * BT;
  const TE* hrow = h + row0 * D;
  // h[row0 + t][d] as float, from the staged tile or from device memory
  auto hv = [&](int t, int d) -> float {
    if constexpr (STAGE) return to_f(hs[t * D + d]);
    else return to_f(hrow[static_cast<long>(min(t, rows - 1)) * D + d]);
  };

  if constexpr (STAGE) {
    for (int i = tid; i < BT * D; i += THREADS) {
      const int t = i / D;
      hs[i] = t < rows ? hrow[i] : from_f<TE>(0.0f);
    }
    __syncthreads();
  }

  // down-projection into G partial sums red[g][BT][m]
  int G;
  if constexpr (TC) {
    // warp w: 16-column tile w % n_tiles of the output, k-steps w / n_tiles + G*i
    namespace wmma = nvcuda::wmma;
    const int n_tiles = m / 16;
    G = WARPS / n_tiles;
    const int warp = tid / 32;
    const int nt = warp % n_tiles;
    const int ks = warp / n_tiles;
    if (ks < G) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll 4
      for (int kk = ks; kk < D / 16; kk += G) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, hs + kk * 16, D);
        wmma::load_matrix_sync(b, wd + static_cast<long>(kk) * 16 * m + nt * 16, m);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(red + ks * BT * m + nt * 16, c, m, wmma::mem_row_major);
    }
  } else {
    // thread (g, j) sums d = g, g + G, ... for column j
    G = THREADS / m;
    const int j = tid % m;
    const int g = tid / m;
    if (g < G) {
      float acc[BT];
#pragma unroll
      for (int t = 0; t < BT; ++t) acc[t] = 0.0f;
      for (int d = g; d < D; d += G) {
        const float w = to_f(wd[static_cast<long>(d) * m + j]);
#pragma unroll
        for (int t = 0; t < BT; ++t) acc[t] = fmaf(hv(t, d), w, acc[t]);
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) red[(g * BT + t) * m + j] = acc[t];
    }
  }
  __syncthreads();
  for (int i = tid; i < BT * m; i += THREADS) {
    const int t = i / m;
    const int jj = i - t * m;
    float s = 0.0f;
    for (int gg = 0; gg < G; ++gg) s += red[(gg * BT + t) * m + jj];
    mid[i] = activate(act, s);
  }
  __syncthreads();

  // up-projection and residual over this split's columns
  const int c0 = blockIdx.y * cols_per_split;
  const int c1 = min(D, c0 + cols_per_split);
  for (int base = c0 + tid; base < c1; base += THREADS * NC) {
    float acc[NC][BT];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int t = 0; t < BT; ++t) acc[c][t] = 0.0f;
    // unrolled so that several W_up loads are in flight: at decode W_up comes
    // from device memory and one load per iteration would expose its latency
#pragma unroll 8
    for (int jj = 0; jj < m; ++jj) {
      float w[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = base + c * THREADS;
        w[c] = d < c1 ? to_f(wu[static_cast<long>(jj) * D + d]) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        const float mv = mid[t * m + jj];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c][t] = fmaf(mv, w[c], acc[c][t]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = base + c * THREADS;
      if (d >= c1) continue;
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        if (t < rows) {
          // the up-projection is rounded to h's type before the residual add
          const float up = to_f(from_f<TE>(acc[c][t]));
          out[(row0 + t) * D + d] = from_f<TE>(hv(t, d) + up);
        }
      }
    }
  }
}

template <typename TE, bool TC, bool STAGE>
int launch(const void* h, const void* wd, const void* wu, void* out, int T, int D,
           int m, int act, int n_split, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (THREADS * BT + BT * m) + (STAGE ? sizeof(TE) * BT * D : 0);
  auto kernel = adapter_fused_kernel<TE, TC, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BT - 1) / BT, n_split);
  const int cols = (D + n_split - 1) / n_split;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TE*>(h), static_cast<const TE*>(wd), static_cast<const TE*>(wu),
      static_cast<TE*>(out), T, D, m, act, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// h [T, D], w_down [D, m], w_up [m, D], out [T, D]; all contiguous on one device,
// of one dtype. bf16: 1 = bfloat16, 0 = float32. act: 0 gelu, 1 relu, 2 silu.
// stage: 1 = keep the [16, D] h tile in shared memory (the caller checks that
// 4 * (256 * 16 + 16 * m) + sizeof(dtype) * 16 * D bytes fit), 0 = read h rows
// from device memory (4 * (256 * 16 + 16 * m) bytes). Returns the cudaError_t
// of the launch (0 = launched).
int adapter_fused_launch(const void* h, const void* w_down, const void* w_up, void* out,
                         int T, int D, int m, int bf16, int act, int stage, int n_split,
                         void* stream) {
  if (T <= 0) return 0;
  if (m < 1 || m > THREADS || n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = stage && D % 16 == 0 && m % 16 == 0 && m <= 16 * WARPS &&
                  reinterpret_cast<uintptr_t>(w_down) % 32 == 0;
  if (bf16 && tc)
    return launch<__nv_bfloat16, true, true>(h, w_down, w_up, out, T, D, m, act, n_split, s);
  if (bf16 && stage)
    return launch<__nv_bfloat16, false, true>(h, w_down, w_up, out, T, D, m, act, n_split, s);
  if (bf16)
    return launch<__nv_bfloat16, false, false>(h, w_down, w_up, out, T, D, m, act, n_split, s);
  if (stage)
    return launch<float, false, true>(h, w_down, w_up, out, T, D, m, act, n_split, s);
  return launch<float, false, false>(h, w_down, w_up, out, T, D, m, act, n_split, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
