// Flash attention forward: causal (end-aligned), optional sliding window with
// attention sinks, GQA.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py
//           (flash_attention / _kernel, pallas_call at line 86). In the port it
//           computes the prefill attention of every dense and hymba block, the
//           function the reference's blocks._attend computes there; with a
//           window, the first n_sink keys (hymba's 128 meta tokens) stay
//           visible to every later query, as _attend's `k_slot < n_sink` test.
//
// What bounds it on the H100: operations. Prefill attention does about
// 2 * 2 * Sq * Sk * hd flops per head (halved by the causal mask) against
// (q + k + v + o) bytes read or written once; at S = 512, hd = 128 that is
// far above the ~295 flops per byte where the bf16 tensor cores become the
// limit. This first version runs its products on the fp32 CUDA cores
// (67 TFLOP/s peak), so it meets that rate long before the memory's.
//
// What the design does about it: one block per (query tile of 64 rows, query
// head, batch row). The block keeps its Q tile, one K tile, one V tile and the
// probability tile in shared memory as fp32 and the running max m, sum l and
// output accumulator acc in registers (fp32, as the Pallas kernel keeps them in
// VMEM), so scores never reach device memory and K/V are read once per query
// tile. Unlike the Pallas kernel, the k-loop is bounded at the causal diagonal
// and at the window's far edge, so fully masked tiles are never visited; with
// sinks it first visits the tiles that hold keys [0, n_sink) and then jumps to
// the window's first tile, never visiting a tile twice. Sinks are a template
// parameter, so a call without them pays nothing for them. Any S
// works: ragged tiles are zero-filled and masked. GQA reads KV head h / group
// through strides; q, k, v and o are read in the model's [B, S, H, hd] layout
// (any strides with a unit last stride), so no repeated K/V is built.
// Tensor-core products (mma / wgmma) and TMA pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 128;   // 16 row groups of 4 rows x 8 column lanes
constexpr float NEG_INF = -1e30f;

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

struct Strides {
  long long b, s, h;  // in elements; the head dim has stride 1
};

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st, int row0,
                                          int rows, int n_valid) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < rows * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    dst[r * LD + d] = row0 + r < n_valid ? to_f(src[(row0 + r) * st.s + d]) : 0.0f;
  }
}

template <typename T, int HD, bool SINKS>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       int group, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, int window, int n_sink) {
  constexpr int LD = HD + 1;       // padded rows: no bank conflicts on columns
  constexpr int PLD = BK + 1;
  constexpr int NE = HD / 8;       // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [BQ][LD]
  float* ks = qs + BQ * LD;        // [BK][LD]
  float* vs = ks + BK * LD;        // [BK][LD]
  float* ps = vs + BK * LD;        // [BQ][PLD]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + kvh * sk.h;
  const T* vp = v + b * sv.b + kvh * sv.h;
  T* op = o + b * so.b + h * so.h;

  const int rg = threadIdx.x / 8;  // rows rg*4 .. rg*4+3 of the tile
  const int cl = threadIdx.x % 8;  // key columns cl + 8c, output dims cl + 8e
  const int off = Sk - Sq;         // align the last query with the last key

  load_tile<T, HD>(qs, qp, sq, q0, BQ, Sq);

  float m_i[4], l_i[4], acc[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.0f;
  }

  // keys that any row of this tile may see
  const int last_q = min(q0 + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, last_q + off + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  k_begin = (k_begin / BK) * BK;
  // with sinks (and a window): the tiles below sink_end first, then from k_begin on
  const int sink_end = SINKS ? ((n_sink + BK - 1) / BK) * BK : 0;

  for (int k0 = SINKS ? 0 : k_begin; k0 < k_end;
       k0 = SINKS && k0 + BK >= sink_end && k0 + BK < k_begin ? k_begin : k0 + BK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, HD>(ks, kp, sk, k0, BK, Sk);
    load_tile<T, HD>(vs, vp, sv, k0, BK, Sk);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(rg * 4 + r) * LD + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = ks[(cl + 8 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + rg * 4 + r + off;
      bool ok[8];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kj = k0 + cl + 8 * c;
        ok[c] = kj < Sk && (!causal || kj <= qpos) &&
                (window <= 0 || qpos - kj < window || (SINKS && kj < n_sink));
        s[r][c] = ok[c] ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 8 lanes of a row group are adjacent lanes of one warp
#pragma unroll
      for (int x = 1; x < 8; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m_i[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.0f;
        sum += p;
        ps[(rg * 4 + r) * PLD + cl + 8 * c] = p;
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
      const float alpha = expf(m_i[r] - m_new);
      l_i[r] = alpha * l_i[r] + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();  // a row group's probabilities were written by its own warp

#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(rg * 4 + r) * PLD + jj];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float vv = vs[jj * LD + cl + 8 * e];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][e] = fmaf(pv[r], vv, acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + rg * 4 + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_i[r], 1e-20f);  // fully masked rows give 0
#pragma unroll
    for (int e = 0; e < NE; ++e) op[qi * so.s + cl + 8 * e] = from_f<T>(acc[r][e] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
           int Sk, int group, Strides sq, Strides sk, Strides sv, Strides so, int causal,
           int window, int n_sink, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * LD + BQ * (BK + 1));
  auto kernel = window > 0 && n_sink > 0 ? flash_attention_kernel<T, HD, true>
                                         : flash_attention_kernel<T, HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  // the reference's scale: 1 / sqrt(hd) in double, rounded once to fp32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, group, sq, sk, sv, so, scale, causal, window, n_sink);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
              int Sq, int Sk, int group, Strides sq, Strides sk, Strides sv, Strides so,
              int causal, int window, int n_sink, cudaStream_t s) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, group, sq, sk, sv, so, causal, window,
                         n_sink, s);
  if (hd == 128)
    return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, group, sq, sk, sv, so, causal, window,
                          n_sink, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k and v [B, Sk, K, hd], o [B, Sq, H, hd] with H = K * group,
// given by pointers and (batch, seq, head) strides in elements; hd is 64 or 128
// with unit stride. is_bf16: 1 = bfloat16, 0 = float32 (all four alike).
// window <= 0 means no window; with a window, keys below n_sink (>= 0) are seen
// by every query the causal mask lets see them. Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                           int H, int K, int Sq, int Sk, int hd, int is_bf16,
                           long long qb, long long qs, long long qh, long long kb,
                           long long ks, long long kh, long long vb, long long vs,
                           long long vh, long long ob, long long os, long long oh,
                           int causal, int window, int n_sink, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh}, so{ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Sq, Sk, H / K, sq, sk, sv, so,
                                     causal, window, n_sink, s);
  return launch_hd<float>(hd, q, k, v, o, B, H, Sq, Sk, H / K, sq, sk, sv, so, causal,
                          window, n_sink, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
