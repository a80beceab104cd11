// Fused serial adapter, eq. (1) of RingAda:  out = h + act(h @ W_down) @ W_up
//
// Replaces: the Pallas TPU kernel src/repro/kernels/adapter_fused.py
//           (adapter_fused / _kernel, pallas_call at line 55).
//
// What bounds it on the H100: bytes. The bottleneck m is tiny (64 for every
// served model), so the work is 4*T*D*m flops against 2*T*D*2 bytes of h in
// and out (bf16): about m flops per byte, far below the ~295 the bf16 tensor
// cores need before they are the limit. Unfused, h would cross device memory
// three times and the [T, m] intermediate once more. Three forward kernels and
// two backward kernels (training, at the end: adapter_bwd_tile_kernel for
// bf16 in the tile path's shape, adapter_bwd_kernel for the rest):
//
// bf16 prefill (T > 16, adapter_tile_kernel): one thread block cluster of C
// blocks (8 or 16, planned by the wrapper: kernels/adapter_fused.py,
// tile_plan) per tile of 64 rows splits D, so the cluster reads the [64, D] h
// tile once and each block keeps its [64, D/C] slice in shared memory from
// the down-projection to the residual add. The Tensor Memory Accelerator
// moves it: 2-D tile copies of 64 columns in the 128-byte swizzle, one
// mbarrier per chunk of 64 columns of h with the matching 64 rows of W_down,
// all issued at once, so the down-projection of one chunk runs while the next
// lands; rows past T and columns past D arrive as zeros (masked, not padded).
// Each weight byte is read once per tile of 64 rows, not once per 16. Both
// products run on the tensor cores with the reference's fp32 internals: the
// down-projection on mma.sync m16n8k16 (bf16 products are exact in fp32);
// the fp32 intermediate mid = act(.) is split into hi = bf16(mid) and lo =
// bf16(mid - hi), and the up-projection sums hi @ W_up + lo @ W_up (W_up is
// exact in bf16) in fp32 on wgmma, with hi and lo in registers and W_up read
// from its swizzled tile, which leaves about 2^-17 of the up term, far below
// the bf16 output's rounding. Once a first cluster barrier (arrived at when
// the copies are issued, waited on after the first products) shows that every
// block of the cluster has started, each block stores its partial [64, m]
// sums of the rows block r owns (t = r mod C) into block r's shared memory;
// after a second barrier block r adds the C partials in rank order, applies
// the activation and writes hi and lo into every block; after a third every
// block forms its D/C output columns. No atomics, and the result does not
// depend on timing. Each warp rounds its 16 x 64 piece of the up term to
// bf16, adds h in place in the staged slice and hands it to a TMA store.
// The TMA takes 16-byte aligned rows only: the launcher refuses others (D or
// m not a multiple of 8, data not 16-byte aligned), which the wrapper sends
// to the 16-row kernel. Two
// blocks share an SM where their shared memory allows (128 registers a
// thread). What is left on the table (PERF.md): a block is a chain of load,
// products, cluster barriers and stores that the card runs in rounds.
//
// Decode (T <= 16, adapter_cluster_kernel): one row tile, and a tile path
// leaves the card idle. Here one cluster of C = 16 blocks (a non-portable
// size) splits D: block r stages its D/C rows of W_down, its D/C columns of
// W_up and of h into shared memory with 16-byte cp.async copies, all issued at
// once, W_up in a second group that lands while the down-projection runs. It
// forms its partial [T, m] sums of h @ W_down, the cluster syncs, and every
// block adds the C partials in rank order through distributed shared memory,
// applies the activation and so holds the whole intermediate; then it writes
// its D/C output columns. Each weight byte is read once, spread over C SMs, in
// one launch, with no device-memory scratch and no atomics. At this T the
// arithmetic is a few MFLOP, so both products run in fp32 on the CUDA cores
// and keep the reference's fp32 internals. Where W_down and W_up do not both
// fit (wide f32 with a large m), W_up is staged into W_down's buffer after the
// down-projection instead. The wrapper plans the shared-memory layout and
// passes it in (ClusterLayout): it alone decides whether a shape fits.
//
// f32 prefill, and bf16 shapes the tile path does not take (m above 128 at
// wide D, m 256 above D 2048, D or m not a multiple of 8, rows not 16-byte
// aligned; no model of the configs): adapter_fused_kernel, one block
// per 16 rows on the CUDA cores with fp32 operands. The [16, D] h tile is
// staged in shared memory where it fits (f32 up to D = 3312), else rows are
// read from device memory; the down-projection splits D over thread groups,
// the up-projection gives each thread NC output columns so one broadcast of
// the intermediate feeds NC FMAs. With too few row tiles to fill the card,
// blockIdx.y splits the output columns.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 16;         // rows of h per block of the f32 tile path (ROWS in the wrapper)
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
// results are never stored).
template <typename TE, bool STAGE>
__global__ void __launch_bounds__(THREADS)
adapter_fused_kernel(const TE* __restrict__ h, const TE* __restrict__ wd,
                     const TE* __restrict__ wu, TE* __restrict__ out, int T, int D,
                     int m, int act, int cols_per_split) {
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

  // down-projection: thread (g, j) sums d = g, g + G, ... for column j into
  // the partial sums red[g][BT][m]
  const int G = THREADS / m;
  {
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

template <typename TE, bool STAGE>
int launch(const void* h, const void* wd, const void* wu, void* out, int T, int D, int m,
           int act, int n_split, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (THREADS * BT + BT * m) + (STAGE ? sizeof(TE) * BT * D : 0);
  auto kernel = adapter_fused_kernel<TE, STAGE>;
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

// ------------------------------------------------ bf16 prefill: tiles on the tensor cores

using bf16_t = __nv_bfloat16;
constexpr int TILE_CLUSTER_MAX = 16;  // the largest (non-portable) cluster of the tile path
constexpr int TILE_ROWS = 64;         // rows of h per tile: one wgmma's M (TILE_ROWS, wrapper)
constexpr int TILE_CHUNKS = 8;        // the most 64-column chunks of D a block owns

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(bf16_t lo, bf16_t hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// Warpgroup matrix multiply (wgmma): d[64 x 64] += a[64 x 16] b[16 x 64] for
// the 4 warps of a warpgroup, a in registers (warp i: rows 16i.., the mma.sync
// A fragment), b in shared memory given by a descriptor, d in the mma.sync
// accumulator layout (warp i: rows 16i.., d[4n .. 4n + 3] its 8-column tile n)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulator d
// across a wgmma fence or wait
__device__ __forceinline__ void wgmma_pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// b: 16 rows (k) of 64 bf16 columns (n) from p, in the TMA's 128-byte swizzle
// with 128-byte rows (n contiguous: the MN-major layout; 8-row groups 1024
// bytes apart; the next 64 columns `lbo` bytes on)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 | static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// mbarriers, and the Tensor Memory Accelerator's 2-D tile copies
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// the one arrival of the barrier's phase, announcing `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {  // phase 0 has completed
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}
// the box at (column x, row y) of `map` into dst, completed on `bar`; rows
// and columns outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// the box of `map` at (x, y) from src; rows and columns outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int x, int y, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(map),
      "r"(x), "r"(y), "r"(smem_u32(src))
      : "memory");
}

// Element offset of (r, c) in a tile stored as 64-column chunks of R rows of
// 128 bytes, the 16-byte pieces of each row XORed with its low 3 bits (the
// TMA's 128-byte swizzle; each chunk 1024-byte aligned): the 8 rows one
// ldmatrix phase reads lie in 8 different bank groups.
__device__ __forceinline__ int swz(int R, int r, int c) {
  return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// mma.sync operands of this lane from a swizzled tile t of R rows (swz): the A
// fragment of rows r0.. and columns c0.. (16 x 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16_t* t, int R, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, t + swz(R, r0 + lane % 16, c0 + (lane / 16) * 8));
}
// the B fragments of the 8-column n-tiles n0.. (b[0], b[1]) and n0 + 8.. (b[2],
// b[3]) over k0 .. k0 + 15, from a tile whose rows are k (n contiguous)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16_t* t, int R, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, t + swz(R, k0 + lane % 8 + ((lane / 8) % 2) * 8, n0 + (lane / 16) * 8));
}
// the same from a tile whose rows are n (k contiguous)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16_t* t, int R, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, t + swz(R, n0 + (lane / 16) * 8 + lane % 8, k0 + ((lane / 8) % 2) * 8));
}
// the A fragment of rows r0.. and columns c0.. of a row-major tile with row
// stride ld (16-byte aligned rows)
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4], const bf16_t* t, int ld, int r0,
                                            int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, t + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8);
}

// The first phase of the cluster barrier of a tile path: a block arrives once
// its copies are issued and waits before its first store into another block's
// shared memory, which the wait guarantees has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A warp's mma.sync partial sums acc of a [64, m] product (rows r0 + g and
// r0 + g + 8, the 8-column n-tiles from column nb; columns from mp on are
// padding) into the shared memory of the blocks that own the rows: row t is
// summed by block t % C, which keeps the C blocks' partial sums of its rows
// part [C][64 / C][lw], this block's at its rank.
template <int N>
__device__ __forceinline__ void scatter_partial(cg::cluster_group& cluster, float* part,
                                                const float (&acc)[N][4], int r0, int nb, int mp,
                                                int lw) {
  const int C = static_cast<int>(cluster.num_blocks());
  const int RB = TILE_ROWS / C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + g + 8 * r;
    float* dst = cluster.map_shared_rank(part, t % C) + (rank * RB + t / C) * lw;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (nb + 8 * n < mp)
        *reinterpret_cast<float2*>(dst + nb + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}
// columns j, j + 1 of the block's row i of the intermediate: the C blocks'
// partial sums (scatter_partial) added in rank order
__device__ __forceinline__ float2 sum_partials(const float* part, int C, int lw, int i, int j) {
  const int RB = TILE_ROWS / C;
  float s0 = 0.0f, s1 = 0.0f;
  for (int s = 0; s < C; ++s) {
    const float2 x = *reinterpret_cast<const float2*>(part + (s * RB + i) * lw + j);
    s0 += x.x;
    s1 += x.y;
  }
  return make_float2(s0, s1);
}
// v0, v1 split into hi = bf16(v) and lo = bf16(v - hi), stored as bf16 pairs at
// element off of hi and of lo in every block of the cluster
__device__ __forceinline__ void broadcast_hi_lo(cg::cluster_group& cluster, bf16_t* hi, bf16_t* lo,
                                                int off, float v0, float v1) {
  const bf16_t h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  const uint32_t vh = pack_bf16(h0, h1);
  const uint32_t vl = pack_bf16(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
                                __float2bfloat16_rn(v1 - __bfloat162float(h1)));
  for (int r = 0; r < static_cast<int>(cluster.num_blocks()); ++r) {
    *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(hi, r) + off) = vh;
    *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(lo, r) + off) = vl;
  }
}

// Byte offsets into the tile path's dynamic shared memory, from its first
// 1024-byte aligned address, planned by the wrapper alone
// (kernels/adapter_fused.py, tile_layout) for the use below. W_down is read
// only before the first cluster barrier, so W_up may take its buffer after
// it (wu == wd).
struct TileLayout {
  int dc;    // columns of D per block (a multiple of 64, at most 64 TILE_CHUNKS)
  int mp;    // m rounded up to 16; columns past m are zero
  int hs;    // [dc / 64][BT][64] bf16, swizzled: the block's slice of h, then of the output
  int wd;    // [mp64 / 64][dc][64] bf16, swizzled: the block's rows of W_down
  int wu;    // [dc / 64][mp][64] bf16, swizzled: the block's columns of W_up
  int part;  // [C][BT / C][mp + 8] fp32: each block's h @ W_down for this block's rows
  int hi;    // [BT][mp + 8] bf16: bf16(act(h @ W_down))
  int lo;    // [BT][mp + 8] bf16: bf16(act(h @ W_down) - hi)
  int bar;   // TILE_CHUNKS + 1 mbarriers: one per chunk of h and W_down, one for W_up
};

// The tensor maps of one launch (TMA 2-D tiles, 128-byte swizzle): h [T, D]
// in boxes of [BT, 64], W_down [D, m] in [64, 64], W_up [m, D] in [mp, 64],
// out [T, D] in [16, 64] (one warp's piece)
struct TileMaps {
  CUtensorMap h, wd, wu, out;
};

// One cluster of C blocks (C = the launch's cluster size, 1 to 16) per tile
// of BT = 64 rows; block r of a cluster owns columns [r dc, (r + 1) dc) of D
// and sums the intermediate's rows t = r mod C. 8 warps, two warpgroups:
// warp w takes m-tile (16 rows) w % 4 and column group w / 4: in the
// down-projection (mma.sync) the group's 32 columns of each 64 of m, over the
// whole of the block's D/C; in the up-projection (wgmma, one warpgroup per
// group) its 64-column chunks. The TMA moves h, the weights and the output
// (the launcher takes only 16-byte aligned rows).
__global__ void __launch_bounds__(THREADS, 2)
adapter_tile_kernel(const __grid_constant__ TileMaps maps, int D, int act, TileLayout L) {
  constexpr int BT = TILE_ROWS;
  constexpr int MTILES = BT / 16;
  constexpr int NG = WARPS / MTILES;
  constexpr int NPW = 8 / NG;  // 8-column n-tiles per warp in each 64 columns of m
  static_assert(MTILES == 4 && NG == 2, "one warpgroup of m-tiles per column group");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16_t* hs = reinterpret_cast<bf16_t*>(smem + L.hs);
  bf16_t* wd_s = reinterpret_cast<bf16_t*>(smem + L.wd);
  bf16_t* wu_s = reinterpret_cast<bf16_t*>(smem + L.wu);
  float* part = reinterpret_cast<float*>(smem + L.part);
  bf16_t* mid_hi = reinterpret_cast<bf16_t*>(smem + L.hi);
  bf16_t* mid_lo = reinterpret_cast<bf16_t*>(smem + L.lo);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const bool share = L.wu == L.wd;
  const int dc = L.dc, mp = L.mp, mp64 = (mp + 63) / 64 * 64;
  const int lw = mp + 8;  // row stride of part, hi and lo
  const int nch = dc / 64;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int RB = BT / C;  // rows of the intermediate each block sums
  const int row0 = static_cast<int>(blockIdx.x / C) * BT;
  const int d0 = rank * dc;
  const int nd = max(0, min(dc, D - d0));  // columns of D this block owns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8 of an m-tile
  const int t4 = lane % 4;  // accumulator columns 2 t4, 2 t4 + 1 of each 8
  const int mt = warp % MTILES;
  const int ng = warp / MTILES;

  // chunk k of h (columns 64k..) with rows 64k.. of W_down on barrier k;
  // W_up on barrier TILE_CHUNKS, after the down-projection where it takes
  // W_down's buffer
  auto load_wu = [&]() {
    mbar_expect(bar + TILE_CHUNKS, 2u * dc * mp);
    for (int k = 0; k < nch; ++k)
      tma_load(wu_s + k * mp * 64, &maps.wu, d0 + 64 * k, 0, bar + TILE_CHUNKS);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= TILE_CHUNKS; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < nch; ++k) {
      mbar_expect(bar + k, 2u * 64 * (BT + mp64));
      tma_load(hs + k * BT * 64, &maps.h, d0 + 64 * k, row0, bar + k);
      for (int c = 0; c < mp64; c += 64)
        tma_load(wd_s + c * dc + 64 * k * 64, &maps.wd, c, d0 + 64 * k, bar + k);
    }
    if (!share) load_wu();
  }
  __syncthreads();  // the barriers are set up
  // waited on after this block's first products, so the wait overlaps them
  cluster_arrive_relaxed();

  // down-projection, in chunks of 64 columns of m: warp (mt, ng) sums its
  // n-tiles over all of the block's D/C for the m-tile's 16 rows, then stores
  // each row's sums into the shared memory of the block that owns the row
  for (int n0 = 0; n0 < mp; n0 += 64) {
    const int nb = n0 + 8 * NPW * ng;  // the warp's first column of m
    float acc[NPW][4];
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    for (int k = 0; k < nch; ++k) {
      if (n0 == 0) mbar_wait(bar + k);  // this chunk has landed
      if (nb >= mp) continue;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = 4 * k + k4;  // k-step of 16
        uint32_t a[4];
        load_a(a, hs, BT, mt * 16, kk * 16);
#pragma unroll
        for (int np = 0; np < NPW / 2; ++np) {
          if (nb + 16 * np < mp) {
            uint32_t b[4];
            load_b_kn(b, wd_s, dc, kk * 16, nb + 16 * np);
            mma_bf16(acc[2 * np], a, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
    if (n0 == 0) cluster_wait();
    scatter_partial(cluster, part, acc, mt * 16, nb, mp, lw);
  }
  cluster.sync();  // every block's sums are in place; W_down is no longer read
  if (share) {
    // W_up into W_down's buffer, after the ldmatrix reads of W_down
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) load_wu();
  }

  // this block's rows t = rank + C i: the C blocks' sums in rank order, the
  // activation, and hi and lo into every block of the cluster
  const int half = mp / 2;
  for (int p = threadIdx.x; p < RB * half; p += THREADS) {
    const int i = p / half;
    const int j = 2 * (p % half);
    const float2 s = sum_partials(part, C, lw, i, j);
    broadcast_hi_lo(cluster, mid_hi, mid_lo, (rank + C * i) * lw + j, activate(act, s.x),
                    activate(act, s.y));
  }
  mbar_wait(bar + TILE_CHUNKS);  // W_up
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  cluster.sync();  // every row of hi and lo is in place; W_up too

  // up-projection, hi @ W_up + lo @ W_up in fp32 on wgmma, and the
  // residual: warpgroup w / 4 (the m-tiles' warps of column group ng) takes
  // the 64-column chunks ng, ng + NG, ... of the block's columns for its 64
  // rows. The A fragments of hi and lo are loaded once where m <= 64, else
  // per group of 4 k-steps.
  const int MK = mp / 16;
  const int KG = (MK + 3) / 4;
  uint32_t ahi[4][4], alo[4][4];
  auto load_a = [&](int kg) {
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int kk = 4 * kg + k4;
      if (kk < MK) {
        load_a_rows(ahi[k4], mid_hi, lw, mt * 16, kk * 16);
        load_a_rows(alo[k4], mid_lo, lw, mt * 16, kk * 16);
      }
    }
  };
  if (KG == 1) load_a(0);
  for (int c0 = 64 * ng; c0 < nd; c0 += 64 * NG) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.0f;
    for (int kg = 0; kg < KG; ++kg) {
      if (KG > 1) load_a(kg);
      wgmma_pin(d);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = 4 * kg + k4;
        if (kk < MK) {
          const uint64_t b = wgmma_desc(wu_s + swz(mp, kk * 16, c0), mp * 128);
          wgmma_64x64(d, ahi[k4], b);
          wgmma_64x64(d, alo[k4], b);
        }
      }
      wgmma_wait();
      wgmma_pin(d);
    }
    // the up term rounded to bf16 (as the reference casts it to h's type),
    // plus h, into the staged slice in place
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            hs + swz(BT, mt * 16 + g + 8 * r, c0 + 8 * n + 2 * t4));
        const float2 hv = __bfloat1622float2(*p);
        const float u0 = __bfloat162float(__float2bfloat16_rn(d[4 * n + 2 * r]));
        const float u1 = __bfloat162float(__float2bfloat16_rn(d[4 * n + 2 * r + 1]));
        *p = __floats2bfloat162_rn(hv.x + u0, hv.y + u1);
      }
    }
    // the warp's 16 x 64 piece to device memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the writes above
    __syncwarp();
    if (lane == 0) {
      tma_store(&maps.out, d0 + c0, row0 + mt * 16, hs + swz(BT, mt * 16, c0));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the shared memory stays until the stores have read it
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A TMA map of the bf16 [rows, cols] row-major tensor at base, in boxes of
// box_rows x 64 columns in the 128-byte swizzle, or false where the driver
// refuses it
bool tile_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The launch configuration of a tile path for T rows: one cluster of
// `cluster` blocks per tile of TILE_ROWS rows (cfg points at attr)
void tile_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int T,
                 size_t smem, cudaStream_t stream) {
  attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(cluster * ((T + TILE_ROWS - 1) / TILE_ROWS));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// The tile path's launch (occupancy == nullptr) or its occupancy query
cudaError_t launch_tile(int cluster_size, const void* h, const void* wd, const void* wu, void* out,
                        int T, int D, int m, int act, TileLayout L, size_t smem,
                        cudaStream_t stream, int* occupancy) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = set_up_once(done, adapter_tile_kernel, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  tile_config(cfg, attr, cluster_size, T, smem, stream);
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveClusters(occupancy, adapter_tile_kernel, &cfg);
  TileMaps maps = {};
  if (!tile_map(&maps.h, h, T, D, TILE_ROWS) || !tile_map(&maps.wd, wd, D, m, 64) ||
      !tile_map(&maps.wu, wu, m, D, L.mp) || !tile_map(&maps.out, out, T, D, 16))
    return cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, adapter_tile_kernel, maps, D, act, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the tile path's kernel takes of the wrapper's plan: each region, at
// the size the kernel uses, inside the smem bytes and 16-byte aligned
bool tile_plan_ok(int T, int D, int m, int cluster_size, TileLayout L, int smem) {
  const int mp64 = (L.mp + 63) / 64 * 64;
  const long hs = 2L * TILE_ROWS * L.dc, wdb = 2L * mp64 * L.dc, wub = 2L * L.mp * L.dc;
  const long part = 4L * TILE_ROWS * (L.mp + 8), mid = 2L * TILE_ROWS * (L.mp + 8);
  // regions from the first 1024-byte aligned address, up to 1024 bytes in
  const auto fits = [&](int off, long size, int align) {
    return 0 <= off && off % align == 0 && off + size <= smem - 1024;
  };
  return T >= 1 && 1 <= m && m <= THREADS && D % 8 == 0 && m % 8 == 0 &&
         L.mp == (m + 15) / 16 * 16 && L.dc >= 64 &&
         L.dc % 64 == 0 && L.dc <= 64 * TILE_CHUNKS && 1 <= cluster_size &&
         cluster_size <= TILE_CLUSTER_MAX && TILE_ROWS % cluster_size == 0 &&
         static_cast<long>(L.dc) * cluster_size >= D && smem <= SMEM_LIMIT &&
         fits(L.hs, hs, 1024) && fits(L.wd, wdb, 1024) && fits(L.wu, wub, 1024) &&
         fits(L.part, part, 16) && fits(L.hi, mid, 16) && fits(L.lo, mid, 16) &&
         fits(L.bar, 8 * (TILE_CHUNKS + 1), 16);
}


// ---------------------------------------------------------------- backward

// Columns of D (rows of W_down, columns of W_up) staged per chunk.
constexpr int BWD_CHUNK = 64;

// d act / dx, exact for each activation: tanh-GELU's derivative through its
// tanh, relu's 0 at x <= 0 (as jax.nn.relu's and torch's), silu's
// s (1 + x (1 - s)) with s = sigmoid(x).
__device__ __forceinline__ float activate_grad(int act, float x) {
  if (act == 0) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    const float x2 = x * x;
    const float t = tanhf(k * (x + 0.044715f * (x2 * x)));
    return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * k * (1.0f + 3.0f * 0.044715f * x2);
  }
  if (act == 1) return x > 0.0f ? 1.0f : 0.0f;
  const float sg = 1.0f / (1.0f + expf(-x));
  return sg * (1.0f + x * (1.0f - sg));
}

// The adapter's backward for one tile of BT rows (adapter_bwd_kernel):
//
//   z = h @ W_down, mid = act(z)                       (recomputed, fp32)
//   g_mid = (g @ W_up^T) * act'(z)                     (fp32; g is up's cotangent)
//   dh = g + T(g_mid @ W_down^T)                       (T = h's type)
//
// and mid, g_mid [T, m] in fp32 for the weight gradients. The rounding is the
// reference's gradient of its casts (src/repro/core/adapter.py): the up term is
// cast to h's type before the residual add, so its cotangent is g in fp32, and
// the input term comes back through h.astype(f32) as one rounding to h's type
// before it is added to g. The weight gradients dW_up = mid^T g and
// dW_down = h^T g_mid are two plain products that the wrapper leaves to
// torch.matmul: the reference's autodiff forms them outside its Pallas kernel,
// whose body never computes them.
//
// It runs f32, and the bf16 shapes no plan of adapter_bwd_tile_kernel (below)
// takes. Simple and right, on the CUDA cores: phase 1 streams D in chunks of
// BWD_CHUNK columns (the [BT, chunk] slices of h and g, the chunk's rows of
// W_down and columns of W_up, all staged by coalesced loads) and thread (grp,
// j) sums both thin products for column j of the intermediate over the
// chunk's columns grp, grp + G, ...; the G partial sums are added in order.
// Phase 2 streams W_down again: thread (column, row group) forms 4 rows of one
// output column. Bytes: h, g and dh once each, the weights once per tile.
// What bounds it on the H100: bytes in bf16 (h, g and dh cross device memory
// once each against 6 T D m flops of three thin products); in f32 the flops
// at the CUDA-core rate. Not fast: the products are fp32 FMAs from shared
// memory (PERF.md section 6).
template <typename TE>
__global__ void __launch_bounds__(THREADS)
adapter_bwd_kernel(const TE* __restrict__ g, const TE* __restrict__ h,
                   const TE* __restrict__ wd, const TE* __restrict__ wu, TE* __restrict__ dh,
                   float* __restrict__ mid_out, float* __restrict__ gmid_out, int T, int D,
                   int m, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red_z = reinterpret_cast<float*>(smem);  // [G][BT][m] partial sums of h W_down
  float* red_u = red_z + THREADS * BT;            // [G][BT][m] partial sums of g W_up^T
  float* gms = red_u + THREADS * BT;              // [BT][m] g_mid
  float* hs = gms + BT * m;                       // [BT][BWD_CHUNK] h's chunk
  float* gs = hs + BT * BWD_CHUNK;                // [BT][BWD_CHUNK] g's chunk
  float* wds = gs + BT * BWD_CHUNK;               // [BWD_CHUNK][m] W_down's rows
  float* wus = wds + BWD_CHUNK * m;               // [m][BWD_CHUNK + 1] W_up's columns
  float* wdp = wds;                               // phase 2: [BWD_CHUNK][m + 1] W_down's rows
  constexpr int WLD = BWD_CHUNK + 1;
  const int tid = threadIdx.x;
  const long row0 = static_cast<long>(blockIdx.x) * BT;
  const int rows = min(BT, T - static_cast<int>(blockIdx.x) * BT);
  const int G = THREADS / m;
  const int j = tid % m;
  const int grp = tid / m;

  float az[BT], au[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) az[t] = au[t] = 0.0f;
  for (int c0 = 0; c0 < D; c0 += BWD_CHUNK) {
    const int nc = min(BWD_CHUNK, D - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < BT * BWD_CHUNK; i += THREADS) {
      const int t = i / BWD_CHUNK;
      const int c = i - t * BWD_CHUNK;
      const bool ok = t < rows && c < nc;
      const long at = (row0 + t) * D + c0 + c;
      hs[i] = ok ? to_f(h[at]) : 0.0f;
      gs[i] = ok ? to_f(g[at]) : 0.0f;
    }
    for (int i = tid; i < BWD_CHUNK * m; i += THREADS)
      wds[i] = i < nc * m ? to_f(wd[static_cast<long>(c0) * m + i]) : 0.0f;
    for (int i = tid; i < m * BWD_CHUNK; i += THREADS) {
      const int jj = i / BWD_CHUNK;
      const int c = i - jj * BWD_CHUNK;
      wus[jj * WLD + c] = c < nc ? to_f(wu[static_cast<long>(jj) * D + c0 + c]) : 0.0f;
    }
    __syncthreads();
    if (grp < G) {
      for (int c = grp; c < nc; c += G) {
        const float wdv = wds[c * m + j];
        const float wuv = wus[j * WLD + c];
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          az[t] = fmaf(hs[t * BWD_CHUNK + c], wdv, az[t]);
          au[t] = fmaf(gs[t * BWD_CHUNK + c], wuv, au[t]);
        }
      }
    }
  }
  if (grp < G) {
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      red_z[(grp * BT + t) * m + j] = az[t];
      red_u[(grp * BT + t) * m + j] = au[t];
    }
  }
  __syncthreads();
  for (int i = tid; i < BT * m; i += THREADS) {
    const int t = i / m;
    const int jj = i - t * m;
    float z = 0.0f, u = 0.0f;
    for (int gg = 0; gg < G; ++gg) {
      z += red_z[(gg * BT + t) * m + jj];
      u += red_u[(gg * BT + t) * m + jj];
    }
    const float gm = u * activate_grad(act, z);
    gms[i] = gm;
    if (t < rows) {
      mid_out[(row0 + t) * m + jj] = activate(act, z);
      gmid_out[(row0 + t) * m + jj] = gm;
    }
  }

  // phase 2: thread (dl, rq) forms rows 4 rq .. 4 rq + 3 of column c0 + dl
  const int dl = tid % BWD_CHUNK;
  const int rq = tid / BWD_CHUNK;
  static_assert(THREADS == BWD_CHUNK * BT / 4, "4 rows of one column per thread");
  for (int c0 = 0; c0 < D; c0 += BWD_CHUNK) {
    const int nc = min(BWD_CHUNK, D - c0);
    __syncthreads();  // g_mid is written; the previous chunk is no longer read
    for (int i = tid; i < BWD_CHUNK * m; i += THREADS) {
      const int r = i / m;
      wdp[r * (m + 1) + (i - r * m)] = i < nc * m ? to_f(wd[static_cast<long>(c0) * m + i]) : 0.0f;
    }
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int jj = 0; jj < m; ++jj) {
      const float w = wdp[dl * (m + 1) + jj];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(gms[(4 * rq + r) * m + jj], w, acc[r]);
    }
    if (dl < nc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * rq + r;
        if (t < rows) {
          const long at = (row0 + t) * D + c0 + dl;
          dh[at] = from_f<TE>(to_f(g[at]) + to_f(from_f<TE>(acc[r])));
        }
      }
    }
  }
}

// shared memory of adapter_bwd_kernel for bottleneck m, in bytes
constexpr size_t bwd_smem(int m) {
  return sizeof(float) * (2 * THREADS * BT + BT * m + 2 * BT * BWD_CHUNK + BWD_CHUNK * m +
                          m * (BWD_CHUNK + 1));
}

template <typename TE>
int launch_bwd(const void* g, const void* h, const void* wd, const void* wu, void* dh,
               float* mid, float* gmid, int T, int D, int m, int act, cudaStream_t stream) {
  auto kernel = adapter_bwd_kernel<TE>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = set_up_once(done, kernel, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(T + BT - 1) / BT, THREADS, bwd_smem(m), stream>>>(
      static_cast<const TE*>(g), static_cast<const TE*>(h), static_cast<const TE*>(wd),
      static_cast<const TE*>(wu), static_cast<TE*>(dh), mid, gmid, T, D, m, act);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------- bf16 backward: tiles on the tensor cores

// Byte offsets into the bf16 backward's dynamic shared memory, from its first
// 1024-byte aligned address, planned by the wrapper alone
// (kernels/adapter_fused.py, bwd_tile_layout) for the use below. Every
// region has room of its own: W_down is read by the first and the last
// product, g from the first product to the store of dh.
struct BwdTileLayout {
  int dc;    // columns of D per block (a multiple of 64, at most 64 TILE_CHUNKS)
  int mp;    // m rounded up to 16; columns past m are zero
  int hs;    // [dc / 64][BT][64] bf16, swizzled: the block's slice of h
  int gs;    // [dc / 64][BT][64] bf16, swizzled: the block's slice of g, then of dh
  int wd;    // [mp64 / 64][dc][64] bf16, swizzled: the block's rows of W_down
  int wu;    // [dc / 64][mp][64] bf16, swizzled: the block's columns of W_up
  int pz;    // [C][BT / C][mp + 8] fp32: each block's h @ W_down for this block's rows
  int pu;    // [C][BT / C][mp + 8] fp32: each block's g @ W_up^T for this block's rows
  int hi;    // [BT][mp + 8] bf16: bf16(g_mid)
  int lo;    // [BT][mp + 8] bf16: bf16(g_mid - hi)
  int bar;   // TILE_CHUNKS mbarriers: one per chunk of h, g, W_down and W_up
};

// The tensor maps of one launch: h and g [T, D] in boxes of [BT, 64], W_down
// [D, m] in [64, 64], W_up [m, D] in [mp, 64], dh [T, D] in [16, 64]
struct BwdTileMaps {
  CUtensorMap h, g, wd, wu, dh;
};

// The adapter's backward in bf16 (adapter_bwd_tile_kernel): the same function
// as adapter_bwd_kernel (above), in the forward tile path's shape. What bounds
// it on the H100: bytes (h and g read once, dh written once; the three thin
// products are 6 T D m flops, about 2m flops a byte, far below the ~295 the
// bf16 tensor cores need). One cluster of C blocks (8 or 16, bwd_tile_plan)
// per tile of BT = 64 rows; block r owns columns [r dc, (r + 1) dc) of D and
// sums the intermediate's rows t = r mod C. The TMA brings the block's slices
// of h and g, its rows of W_down and its columns of W_up, one mbarrier per
// 64-column chunk, all issued at once (rows past T and columns past D arrive
// as zeros), so each weight byte is read once per tile of 64 rows and h and g
// once. 8 warps; warp w takes m-tile w % 4 and column group w / 4.
//  1. As each chunk lands, z += h W_down and u += g W_up^T for the warp's 16
//     rows and 32 columns of each 64 of m, on mma.sync m16n8k16 with fp32
//     accumulators (bf16 products are exact in fp32): W_down by ldmatrix.trans
//     (its rows are k), W_up by ldmatrix (already k-contiguous).
//  2. The forward's cluster protocol: arrived at once the copies are issued,
//     waited on before the first store into another block. Each block stores
//     its partial z and u of the rows block r owns into block r's shared
//     memory; after a cluster barrier block r adds the C partials in rank
//     order, forms mid = act(z) and g_mid = u act'(z), writes its rows of both
//     (fp32) and writes hi = bf16(g_mid) and lo = bf16(g_mid - hi) into every
//     block. No atomics: the result does not depend on timing.
//  3. After a second barrier, warpgroup w / 4 forms term = hi W_down^T + lo
//     W_down^T (fp32 accumulators, mma.sync, W_down's tile of step 1 read by
//     ldmatrix: its rows are n) for its 64-column chunks, rounds it to bf16,
//     adds g from the staged slice and rounds again (the reference's bf16(g +
//     bf16(term))), in place, and hands each warp's 16 x 64 piece of dh to a
//     TMA store. The hi/lo split leaves about 2^-17 of the term, far below
//     dh's rounding. One block an SM (its shared memory); rows of the
//     intermediate stay in fp32 until the split.
// The tensor cores add into an fp32 accumulator by aligning to the largest
// exponent and truncating, which biases a long sum toward zero; a biased
// term moves which elements of dh round the other way, and a deep backward
// chain grows that (launch/grad_gap.py, PERF.md). So no sum runs long in one
// accumulator: z and u are summed per 64-column chunk and the chunks added
// in fp32, and hi W_down^T and lo W_down^T are kept apart (lo's products,
// 2^-8 of hi's, would lose the bits the split keeps) and added at the end.
__global__ void __launch_bounds__(THREADS, 1)
adapter_bwd_tile_kernel(const __grid_constant__ BwdTileMaps maps, float* __restrict__ mid_out,
                        float* __restrict__ gmid_out, int T, int D, int m, int act,
                        BwdTileLayout L) {
  constexpr int BT = TILE_ROWS;
  constexpr int MTILES = BT / 16;
  constexpr int NG = WARPS / MTILES;
  constexpr int NPW = 8 / NG;  // 8-column n-tiles per warp in each 64 columns of m
  static_assert(MTILES == 4 && NG == 2, "one warpgroup of m-tiles per column group");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16_t* hs = reinterpret_cast<bf16_t*>(smem + L.hs);
  bf16_t* gs = reinterpret_cast<bf16_t*>(smem + L.gs);
  bf16_t* wd_s = reinterpret_cast<bf16_t*>(smem + L.wd);
  bf16_t* wu_s = reinterpret_cast<bf16_t*>(smem + L.wu);
  float* pz = reinterpret_cast<float*>(smem + L.pz);
  float* pu = reinterpret_cast<float*>(smem + L.pu);
  bf16_t* gm_hi = reinterpret_cast<bf16_t*>(smem + L.hi);
  bf16_t* gm_lo = reinterpret_cast<bf16_t*>(smem + L.lo);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int dc = L.dc, mp = L.mp, mp64 = (mp + 63) / 64 * 64;
  const int lw = mp + 8;  // row stride of the partials, hi and lo
  const int nch = dc / 64;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int RB = BT / C;  // rows of the intermediate each block sums
  const int row0 = static_cast<int>(blockIdx.x / C) * BT;
  const int d0 = rank * dc;
  const int nd = max(0, min(dc, D - d0));  // columns of D this block owns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8 of an m-tile
  const int t4 = lane % 4;  // accumulator columns 2 t4, 2 t4 + 1 of each 8
  const int mt = warp % MTILES;
  const int ng = warp / MTILES;

  // chunk k (columns 64k.. of the block's slice) of h and g, with rows 64k.. of
  // W_down and columns 64k.. of W_up, on barrier k
  if (threadIdx.x == 0) {
    for (int i = 0; i < TILE_CHUNKS; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < nch; ++k) {
      mbar_expect(bar + k, 2u * 64 * (2 * BT + mp64 + mp));
      tma_load(hs + k * BT * 64, &maps.h, d0 + 64 * k, row0, bar + k);
      tma_load(gs + k * BT * 64, &maps.g, d0 + 64 * k, row0, bar + k);
      for (int c = 0; c < mp64; c += 64)
        tma_load(wd_s + c * dc + 64 * k * 64, &maps.wd, c, d0 + 64 * k, bar + k);
      tma_load(wu_s + k * mp * 64, &maps.wu, d0 + 64 * k, 0, bar + k);
    }
  }
  __syncthreads();  // the barriers are set up
  cluster_arrive_relaxed();

  // 1. z = h W_down and u = g W_up^T, in chunks of 64 columns of m: warp (mt,
  // ng) sums its n-tiles over all of the block's D/C for the m-tile's 16 rows,
  // then stores each row's sums into the block that owns the row
  for (int n0 = 0; n0 < mp; n0 += 64) {
    const int nb = n0 + 8 * NPW * ng;  // the warp's first column of m
    float az[NPW][4], au[NPW][4];
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) az[n][e] = au[n][e] = 0.0f;
    for (int k = 0; k < nch; ++k) {
      if (n0 == 0) mbar_wait(bar + k);  // this chunk has landed
      if (nb >= mp) continue;
      // this chunk's sums on their own, then added in fp32 (see below)
      float cz[NPW][4], cu[NPW][4];
#pragma unroll
      for (int n = 0; n < NPW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cz[n][e] = cu[n][e] = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = 4 * k + k4;  // k-step of 16
        uint32_t ah[4], ag[4];
        load_a(ah, hs, BT, mt * 16, kk * 16);
        load_a(ag, gs, BT, mt * 16, kk * 16);
#pragma unroll
        for (int np = 0; np < NPW / 2; ++np) {
          if (nb + 16 * np < mp) {
            uint32_t b[4];
            load_b_kn(b, wd_s, dc, kk * 16, nb + 16 * np);
            mma_bf16(cz[2 * np], ah, b[0], b[1]);
            mma_bf16(cz[2 * np + 1], ah, b[2], b[3]);
            load_b_nk(b, wu_s, mp, nb + 16 * np, kk * 16);
            mma_bf16(cu[2 * np], ag, b[0], b[1]);
            mma_bf16(cu[2 * np + 1], ag, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NPW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) { az[n][e] += cz[n][e]; au[n][e] += cu[n][e]; }
    }
    if (n0 == 0) cluster_wait();
    scatter_partial(cluster, pz, az, mt * 16, nb, mp, lw);
    scatter_partial(cluster, pu, au, mt * 16, nb, mp, lw);
  }
  cluster.sync();  // every block's partial sums are in place

  // 2. this block's rows t = rank + C i: the C blocks' sums in rank order,
  // mid and g_mid to device memory, and g_mid's hi and lo into every block
  const int half = mp / 2;
  for (int p = threadIdx.x; p < RB * half; p += THREADS) {
    const int i = p / half;
    const int j = 2 * (p % half);
    const float2 z = sum_partials(pz, C, lw, i, j);
    const float2 u = sum_partials(pu, C, lw, i, j);
    const float gm0 = u.x * activate_grad(act, z.x), gm1 = u.y * activate_grad(act, z.y);
    const int t = row0 + rank + C * i;
    if (t < T && j < m) {  // m is even: j + 1 < m too
      const long at = static_cast<long>(t) * m + j;
      *reinterpret_cast<float2*>(mid_out + at) = make_float2(activate(act, z.x),
                                                             activate(act, z.y));
      *reinterpret_cast<float2*>(gmid_out + at) = make_float2(gm0, gm1);
    }
    broadcast_hi_lo(cluster, gm_hi, gm_lo, (rank + C * i) * lw + j, gm0, gm1);
  }
  cluster.sync();  // every row of hi and lo is in place

  // 3. term = hi W_down^T + lo W_down^T and dh = bf16(g + bf16(term)):
  // warpgroup ng takes the 64-column chunks ng, ng + NG, ... of the block's
  // columns for its 64 rows. The A fragments of hi and lo are loaded once
  // where m <= 64, else per group of 4 k-steps.
  const int MK = mp / 16;
  const int KG = (MK + 3) / 4;
  uint32_t ahi[4][4], alo[4][4];
  auto load_gm = [&](int kg) {
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int kk = 4 * kg + k4;
      if (kk < MK) {
        load_a_rows(ahi[k4], gm_hi, lw, mt * 16, kk * 16);
        load_a_rows(alo[k4], gm_lo, lw, mt * 16, kk * 16);
      }
    }
  };
  if (KG == 1) load_gm(0);
  for (int c0 = 64 * ng; c0 < nd; c0 += 64 * NG) {
    float acc[8][4], acl[8][4];  // hi W_down^T and lo W_down^T, apart (see below)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acl[n][e] = 0.0f;
    for (int kg = 0; kg < KG; ++kg) {
      if (KG > 1) load_gm(kg);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = 4 * kg + k4;
        if (kk < MK) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            load_b_nk(b, wd_s, dc, c0 + 16 * np, kk * 16);
            mma_bf16(acc[2 * np], ahi[k4], b[0], b[1]);
            mma_bf16(acl[2 * np], alo[k4], b[0], b[1]);
            mma_bf16(acc[2 * np + 1], ahi[k4], b[2], b[3]);
            mma_bf16(acl[2 * np + 1], alo[k4], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += acl[n][e];
    // the term rounded to bf16 (the reference casts it to h's type), plus g,
    // into the staged slice of g in place
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            gs + swz(BT, mt * 16 + g + 8 * r, c0 + 8 * n + 2 * t4));
        const float2 gv = __bfloat1622float2(*p);
        const float t0 = __bfloat162float(__float2bfloat16_rn(acc[n][2 * r]));
        const float t1 = __bfloat162float(__float2bfloat16_rn(acc[n][2 * r + 1]));
        *p = __floats2bfloat162_rn(gv.x + t0, gv.y + t1);
      }
    }
    // the warp's 16 x 64 piece of dh to device memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the writes above
    __syncwarp();
    if (lane == 0) {
      tma_store(&maps.dh, d0 + c0, row0 + mt * 16, gs + swz(BT, mt * 16, c0));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the shared memory stays until the stores have read it
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The bf16 backward's launch (occupancy == nullptr) or its occupancy query
cudaError_t launch_bwd_tile(int cluster_size, const void* g, const void* h, const void* wd,
                            const void* wu, void* dh, float* mid, float* gmid, int T, int D, int m,
                            int act, BwdTileLayout L, size_t smem, cudaStream_t stream,
                            int* occupancy) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = set_up_once(done, adapter_bwd_tile_kernel, true);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  tile_config(cfg, attr, cluster_size, T, smem, stream);
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveClusters(occupancy, adapter_bwd_tile_kernel, &cfg);
  BwdTileMaps maps = {};
  if (!tile_map(&maps.h, h, T, D, TILE_ROWS) || !tile_map(&maps.g, g, T, D, TILE_ROWS) ||
      !tile_map(&maps.wd, wd, D, m, 64) || !tile_map(&maps.wu, wu, m, D, L.mp) ||
      !tile_map(&maps.dh, dh, T, D, 16) || reinterpret_cast<uintptr_t>(mid) % 8 ||
      reinterpret_cast<uintptr_t>(gmid) % 8)
    return cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, adapter_bwd_tile_kernel, maps, mid, gmid, T, D, m, act, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the bf16 backward's kernel takes of the wrapper's plan: each region, at
// the size the kernel uses, inside the smem bytes and aligned as it is read
bool bwd_tile_plan_ok(int T, int D, int m, int cluster_size, BwdTileLayout L, int smem) {
  const int mp64 = (L.mp + 63) / 64 * 64;
  const long slice = 2L * TILE_ROWS * L.dc, wdb = 2L * mp64 * L.dc, wub = 2L * L.mp * L.dc;
  const long part = 4L * TILE_ROWS * (L.mp + 8), mid = 2L * TILE_ROWS * (L.mp + 8);
  const auto fits = [&](int off, long size, int align) {
    return 0 <= off && off % align == 0 && off + size <= smem - 1024;
  };
  return T >= 1 && 1 <= m && m <= THREADS && D % 8 == 0 && m % 8 == 0 &&
         L.mp == (m + 15) / 16 * 16 && L.dc >= 64 && L.dc % 64 == 0 &&
         L.dc <= 64 * TILE_CHUNKS && 1 <= cluster_size && cluster_size <= TILE_CLUSTER_MAX &&
         TILE_ROWS % cluster_size == 0 && static_cast<long>(L.dc) * cluster_size >= D &&
         smem <= SMEM_LIMIT && fits(L.hs, slice, 1024) && fits(L.gs, slice, 1024) &&
         fits(L.wd, wdb, 1024) && fits(L.wu, wub, 1024) && fits(L.pz, part, 16) &&
         fits(L.pu, part, 16) && fits(L.hi, mid, 16) && fits(L.lo, mid, 16) &&
         fits(L.bar, 8 * TILE_CHUNKS, 16);
}

}  // namespace

extern "C" {

// h [T, D], w_down [D, m], w_up [m, D], out [T, D]; all contiguous on one device,
// of one dtype. bf16: 1 = bfloat16, 0 = float32. act: 0 gelu, 1 relu, 2 silu.
// The 16-row tile kernel on the CUDA cores: f32, and bf16 shapes no tile plan
// fits. stage: 1 = keep the [16, D] h tile in shared memory (f32 only; the
// caller checks that 4 * (256 * 16 + 16 * m) + 4 * 16 * D bytes fit), 0 = read
// h rows from device memory (4 * (256 * 16 + 16 * m) bytes). Returns the
// cudaError_t of the launch (0 = launched).
int adapter_fused_launch(const void* h, const void* w_down, const void* w_up, void* out,
                         int T, int D, int m, int bf16, int act, int stage, int n_split,
                         void* stream) {
  if (T <= 0) return 0;
  if (m < 1 || m > THREADS || n_split < 1 || (bf16 && stage))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16, false>(h, w_down, w_up, out, T, D, m, act, n_split, s);
  if (stage) return launch<float, true>(h, w_down, w_up, out, T, D, m, act, n_split, s);
  return launch<float, false>(h, w_down, w_up, out, T, D, m, act, n_split, s);
}

// The bf16 prefill path: tiles of 64 rows, each one cluster of `cluster`
// blocks (1-16, dividing 64) owning dc columns of D each, with the
// wrapper's shared-memory plan (smem bytes; mp = m rounded up to 16; hs, wd,
// wu, part, hi, lo, bar: byte offsets of TileLayout). The TMA moves h, the
// weights and out (tensor maps made here, per launch), so all four must be
// 16-byte aligned and D and m multiples of 8. Returns the cudaError_t of the
// launch.
int adapter_fused_tile_launch(const void* h, const void* w_down, const void* w_up, void* out,
                              int T, int D, int m, int act, int cluster, int dc, int mp,
                              int hs, int wd, int wu, int part, int hi, int lo, int bar,
                              int smem, void* stream) {
  if (T <= 0) return 0;
  const TileLayout L{dc, mp, hs, wd, wu, part, hi, lo, bar};
  if (!tile_plan_ok(T, D, m, cluster, L, smem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tile(cluster, h, w_down, w_up, out, T, D, m, act, L, smem,
                                      static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the bf16 prefill kernel for clusters of
// `cluster` blocks with smem bytes of shared memory per block (0: none can
// launch), or minus the cudaError_t of the query.
int adapter_fused_tile_occupancy(int cluster, int smem) {
  if (smem < 0 || smem > SMEM_LIMIT || cluster < 1 || cluster > TILE_CLUSTER_MAX)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = launch_tile(cluster, nullptr, nullptr, nullptr, nullptr, TILE_ROWS, 0,
                                      0, 0, TileLayout{}, smem, nullptr, &n);
  return err ? -static_cast<int>(err) : n;
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

// The adapter's backward (adapter_bwd_kernel): g (out's cotangent), h [T, D],
// w_down [D, m], w_up [m, D] in, dh [T, D] (h's dtype) and mid, g_mid [T, m]
// (fp32) out; all contiguous on one device. bf16: 1 = bfloat16, 0 = float32;
// act: 0 gelu, 1 relu, 2 silu. Returns the cudaError_t of the launch.
int adapter_fused_bwd_launch(const void* g, const void* h, const void* w_down,
                             const void* w_up, void* dh, void* mid, void* g_mid, int T, int D,
                             int m, int bf16, int act, void* stream) {
  if (T <= 0) return 0;
  if (m < 1 || m > THREADS || D < 1 || act < 0 || act > 2 || bwd_smem(m) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(mid);
  float* go = static_cast<float*>(g_mid);
  if (bf16) return launch_bwd<__nv_bfloat16>(g, h, w_down, w_up, dh, mo, go, T, D, m, act, s);
  return launch_bwd<float>(g, h, w_down, w_up, dh, mo, go, T, D, m, act, s);
}

// The bf16 backward on the tensor cores (adapter_bwd_tile_kernel): g, h
// [T, D], w_down [D, m], w_up [m, D] in, dh [T, D] and mid, g_mid [T, m] (fp32)
// out; tiles of 64 rows, each one cluster of `cluster` blocks (1-16, dividing
// 64) owning dc columns of D each, with the wrapper's shared-memory plan (smem
// bytes; mp = m rounded up to 16; hs, gs, wd, wu, pz, pu, hi, lo, bar: byte
// offsets of BwdTileLayout). The TMA moves g, h, the weights and dh (tensor
// maps made here, per launch), so all five must be 16-byte aligned and D and m
// multiples of 8. act: 0 gelu, 1 relu, 2 silu. Returns the cudaError_t of the
// launch.
int adapter_fused_bwd_tile_launch(const void* g, const void* h, const void* w_down,
                                  const void* w_up, void* dh, void* mid, void* g_mid, int T, int D,
                                  int m, int act, int cluster, int dc, int mp, int hs, int gs,
                                  int wd, int wu, int pz, int pu, int hi, int lo, int bar,
                                  int smem, void* stream) {
  if (T <= 0) return 0;
  const BwdTileLayout L{dc, mp, hs, gs, wd, wu, pz, pu, hi, lo, bar};
  if (act < 0 || act > 2 || !bwd_tile_plan_ok(T, D, m, cluster, L, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bwd_tile(cluster, g, h, w_down, w_up, dh,
                                          static_cast<float*>(mid), static_cast<float*>(g_mid),
                                          T, D, m, act, L, smem,
                                          static_cast<cudaStream_t>(stream), nullptr));
}

// cudaOccupancyMaxActiveClusters of the bf16 backward's kernel for clusters of
// `cluster` blocks with smem bytes of shared memory per block (0: none can
// launch), or minus the cudaError_t of the query.
int adapter_fused_bwd_tile_occupancy(int cluster, int smem) {
  if (smem < 0 || smem > SMEM_LIMIT || cluster < 1 || cluster > TILE_CLUSTER_MAX)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err =
      launch_bwd_tile(cluster, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      TILE_ROWS, 0, 0, 0, BwdTileLayout{}, smem, nullptr, &n);
  return err ? -static_cast<int>(err) : n;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
