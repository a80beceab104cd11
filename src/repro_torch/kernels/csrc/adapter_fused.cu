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
//
// Decode (T <= 16, adapter_cluster_kernel): one row tile, and the tile path
// above leaves the card idle (each of its few blocks reads all of W_down as a
// chain of dependent loads). Here one thread block cluster of C = 16 blocks (a
// non-portable size) splits D: block r stages its D/C rows of W_down, its
// D/C columns of W_up and of h into shared memory with 16-byte cp.async
// copies, all issued at once, W_up in a second group that lands while the
// down-projection runs. It forms its partial [T, m] sums of h @ W_down, the
// cluster syncs, and every block adds the C partials in rank order through
// distributed shared memory, applies the activation and so holds the whole
// intermediate; then it writes its D/C output columns. Each weight byte is
// read once, spread over C SMs, in one launch, with no device-memory scratch
// and no atomics. At this T the arithmetic is a few MFLOP, so both products
// run in fp32 on the CUDA cores and keep the reference's fp32 internals. Where
// W_down and W_up do not both fit (wide f32 with a large m), W_up is staged
// into W_down's buffer after the down-projection instead. The wrapper plans
// the shared-memory layout and passes it in (ClusterLayout): it alone decides
// whether a shape fits this path.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 16;         // rows of h per block (one wmma tile; ROWS in the wrapper)
constexpr int THREADS = 256;   // THREADS in the wrapper
constexpr int WARPS = THREADS / 32;
constexpr int NC = 4;          // output columns per thread in the up-projection
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (SMEM_LIMIT in the wrapper)
constexpr int CLUSTER = 16;    // blocks per cluster of the decode path (CLUSTER in the wrapper)

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

// Raises a kernel's dynamic shared-memory limit to the most a block may use,
// once per device (and, for a cluster size above 8, allows it); `done` is the
// calling instantiation's bit set of devices already set up.
template <typename K>
cudaError_t set_up_once(std::atomic<unsigned long long>& done, K kernel, bool big_cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && big_cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename TE, bool TC, bool STAGE>
int launch(const void* h, const void* wd, const void* wu, void* out, int T, int D,
           int m, int act, int n_split, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (THREADS * BT + BT * m) + (STAGE ? sizeof(TE) * BT * D : 0);
  auto kernel = adapter_fused_kernel<TE, TC, STAGE>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = set_up_once(done, kernel, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BT - 1) / BT, n_split);
  const int cols = (D + n_split - 1) / n_split;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TE*>(h), static_cast<const TE*>(wd), static_cast<const TE*>(wu),
      static_cast<TE*>(out), T, D, m, act, cols);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- decode: one cluster

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols elements (source row stride ld) into dst [rows][ldd]: 16-byte
// cp.async copies where `vec` (16-byte aligned rows, cols a multiple of 16
// bytes), else element by element
template <typename TE>
__device__ __forceinline__ void stage_rows(TE* dst, int ldd, const TE* src, long ld, int rows,
                                           int cols, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(TE);
    const int per_row = cols / V;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * V;
      cp_async16(dst + r * ldd + c, src + r * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int r = i / cols;
      const int c = i - r * cols;
      dst[r * ldd + c] = src[r * ld + c];
    }
  }
}

// Byte offsets into the decode path's dynamic shared memory. The layout is
// planned by the wrapper alone (kernels/adapter_fused.py, cluster_plan), which
// sizes each region for the use below; red (the thread groups' partial sums)
// starts at 0. wu == wd means W_up takes W_down's buffer after the
// down-projection.
struct ClusterLayout {
  int part;  // [NT][m] fp32: this block's h @ W_down
  int mid;   // [m][NT] fp32: act(h @ W_down) over all of D
  int hs;    // [dc][NT] fp32: the block's columns of h
  int wd;    // [dc][m] TE: the block's rows of W_down (16-byte aligned)
  int wu;    // [m][dc] TE: the block's columns of W_up (16-byte aligned)
};

// T <= NT rows (NT a power of two up to BT); the grid is one cluster of
// CLUSTER blocks. dc: columns of D per block (a multiple of 16 bytes of TE).
// vec: see stage_rows. h and the intermediate are kept as fp32 with the rows
// innermost, so one vector load gives a column's NT rows.
template <typename TE, int NT>
__global__ void __launch_bounds__(THREADS)
adapter_cluster_kernel(const TE* __restrict__ h, const TE* __restrict__ wd,
                       const TE* __restrict__ wu, TE* __restrict__ out, int T, int D, int m,
                       int act, int dc, ClusterLayout L, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);    // [G][NT][m] partial sums, G * m <= THREADS
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* mid = reinterpret_cast<float*>(smem + L.mid);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  TE* wd_s = reinterpret_cast<TE*>(smem + L.wd);
  TE* wu_s = reinterpret_cast<TE*>(smem + L.wu);
  const bool overlap = L.wu != L.wd;              // W_up has a buffer of its own
  const int tid = threadIdx.x;
  const int d0 = static_cast<int>(cluster.block_rank()) * dc;
  const int nd = max(0, min(D - d0, dc));         // columns this block owns

  if (nd > 0) stage_rows(wd_s, 0, wd + static_cast<long>(d0) * m, 0, 1, nd * m, vec);
  cp_async_commit();
  if (overlap && nd > 0) stage_rows(wu_s, dc, wu + d0, D, m, nd, vec);
  cp_async_commit();
  for (int i = tid; i < NT * nd; i += THREADS) {  // rows past T are zero
    const int t = i / nd;
    const int c = i - t * nd;
    hs[c * NT + t] = t < T ? to_f(h[static_cast<long>(t) * D + d0 + c]) : 0.0f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // thread (g, j) sums rows d = g, g + G, ... of the block's W_down for column j
  const int G = THREADS / m;
  const int j = tid % m;
  const int g = tid / m;
  if (g < G) {
    float acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = 0.0f;
#pragma unroll 4
    for (int d = g; d < nd; d += G) {
      const float w = to_f(wd_s[d * m + j]);
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t] = fmaf(hs[d * NT + t], w, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) red[(g * NT + t) * m + j] = acc[t];
  }
  __syncthreads();
  for (int i = tid; i < NT * m; i += THREADS) {
    float s = 0.0f;
    for (int gg = 0; gg < G; ++gg) s += red[gg * NT * m + i];
    part[i] = s;
  }
  // W_down was read before the barrier above: W_up may take its buffer
  if (!overlap && nd > 0) stage_rows(wu_s, dc, wu + d0, D, m, nd, vec);
  cp_async_commit();
  cluster.sync();  // every block's partial sums are written

  // the whole intermediate: the CLUSTER partials in rank order, in every block
  for (int i = tid; i < NT * m; i += THREADS) {
    float x[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) x[r] = cluster.map_shared_rank(part, r)[i];
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) s += x[r];
    const int t = i / m;
    mid[(i - t * m) * NT + t] = activate(act, s);
  }
  // this block reads no other block's shared memory from here on
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  cp_async_wait<0>();
  __syncthreads();

  // up-projection and residual over the block's columns
  for (int c = tid; c < nd; c += THREADS) {
    float acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = 0.0f;
#pragma unroll 8
    for (int jj = 0; jj < m; ++jj) {
      const float w = to_f(wu_s[jj * dc + c]);
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t] = fmaf(mid[jj * NT + t], w, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < T) {
        // the up-projection is rounded to h's type before the residual add
        const float up = to_f(from_f<TE>(acc[t]));
        out[static_cast<long>(t) * D + d0 + c] = from_f<TE>(hs[c * NT + t] + up);
      }
    }
  }
  // no block leaves while another may still read its partial sums
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The decode path's launch (occupancy == nullptr) or its occupancy query, for
// the instantiation of nt rows
template <typename TE>
cudaError_t launch_cluster(int nt, const void* h, const void* wd, const void* wu, void* out,
                           int T, int D, int m, int act, int dc, ClusterLayout L, size_t smem,
                           cudaStream_t stream, int* occupancy) {
  auto go = [&](auto nt_c) {
    auto kernel = adapter_cluster_kernel<TE, decltype(nt_c)::value>;
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = set_up_once(done, kernel, CLUSTER > 8);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (occupancy != nullptr) return cudaOccupancyMaxActiveClusters(occupancy, kernel, &cfg);
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const int vec = aligned(wd) && aligned(wu) && D % (16 / sizeof(TE)) == 0;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TE*>(h),
                             static_cast<const TE*>(wd), static_cast<const TE*>(wu),
                             static_cast<TE*>(out), T, D, m, act, dc, L, vec);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  };
  switch (nt) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 4: return go(std::integral_constant<int, 4>{});
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
  }
  return cudaErrorInvalidValue;
}

// What the decode path's kernel takes of the wrapper's plan; the plan's
// region sizes are the wrapper's (cluster_plan)
bool cluster_plan_ok(int T, int D, int m, int elem, int nt, int dc, ClusterLayout L,
                     int smem) {
  const auto in = [&](int off) { return 0 <= off && off < smem; };
  return 1 <= T && T <= nt && nt <= BT && 1 <= m && m <= THREADS && dc >= 1 &&
         dc % (16 / elem) == 0 && static_cast<long>(dc) * CLUSTER >= D && smem <= SMEM_LIMIT &&
         in(L.part) && in(L.mid) && in(L.hs) && in(L.wd) && in(L.wu) && L.wd % 16 == 0 &&
         L.wu % 16 == 0;
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

// The decode path: T <= nt <= 16 rows, one cluster of 16 blocks, each owning
// dc columns of D, with the wrapper's shared-memory plan (smem bytes; part,
// mid, hs, wd, wu: byte offsets of ClusterLayout). Returns the cudaError_t of
// the launch.
int adapter_fused_cluster_launch(const void* h, const void* w_down, const void* w_up,
                                 void* out, int T, int D, int m, int bf16, int act, int nt,
                                 int dc, int part, int mid, int hs, int wd, int wu, int smem,
                                 void* stream) {
  if (T <= 0) return 0;
  const ClusterLayout L{part, mid, hs, wd, wu};
  if (!cluster_plan_ok(T, D, m, bf16 ? 2 : 4, nt, dc, L, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_cluster<__nv_bfloat16>(nt, h, w_down, w_up, out, T, D, m, act, dc, L, smem,
                                           s, nullptr)
           : launch_cluster<float>(nt, h, w_down, w_up, out, T, D, m, act, dc, L, smem, s,
                                   nullptr);
  return static_cast<int>(err);
}

// cudaOccupancyMaxActiveClusters of the decode path's kernel for nt rows with
// smem bytes of shared memory per block: how many such clusters the card
// holds at once (0: none can launch), or minus the cudaError_t of the query.
int adapter_fused_cluster_occupancy(int nt, int bf16, int smem) {
  if (smem < 0 || smem > SMEM_LIMIT) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const ClusterLayout L{};
  const cudaError_t err =
      bf16 ? launch_cluster<__nv_bfloat16>(nt, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                                           0, L, smem, nullptr, &n)
           : launch_cluster<float>(nt, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, L,
                                   smem, nullptr, &n);
  return err ? -static_cast<int>(err) : n;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
