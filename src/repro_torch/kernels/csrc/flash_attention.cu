// Flash attention: causal (end-aligned), optional sliding window with
// attention sinks, GQA. Two forward kernels, bf16 on the tensor cores and f32
// on the CUDA cores, each of which can also write the row logsumexp for
// training; and the backward for training, at the end, again bf16 on the
// tensor cores and f32 on the CUDA cores, sinks included. Head dims 64, 80
// and 128.
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
// limit.
//
// Shared by both kernels: one block per (query tile, query head, batch row).
// The running max m, sum l and the output accumulator stay fp32 in
// registers (as the Pallas kernel keeps them in VMEM), so scores never reach
// device memory and K/V are read once per query tile. Unlike the Pallas
// kernel, the k-loop is bounded at the causal diagonal and at the window's far
// edge, so fully masked tiles are never visited; with sinks it first visits the
// tiles that hold keys [0, n_sink) and then jumps to the window's first tile,
// never visiting a tile twice. Sinks are a template parameter, so a call
// without them pays nothing for them. Any S works: ragged tiles are
// zero-filled and masked. GQA reads KV head h / group through strides; q, k, v
// and o are read in the model's [B, S, H, hd] layout (any strides with a unit
// last stride), so no repeated K/V is built.
//
// bf16 (flash_attention_tc_kernel), FlashAttention-2 style on mma.sync
// m16n8k16: four warps own MT 16-row m-tiles of queries each (MT = 2 at hd
// 128 and 80, so each K/V fragment feeds two products; 1 at hd 64). Q is
// loaded once (into registers as A fragments where they fit, else read by ldmatrix at
// each k-step). K/V tiles of 64 keys stream into shared memory with cp.async,
// double-buffered: the next tile (after the same sink jump) is in flight while
// the current one is used, and the wait for V comes after S = QK^T, in an
// XOR-swizzled layout so that ldmatrix has no bank conflicts. S accumulates in
// fp32 registers; the masks run only on m-tiles that the tile cuts (the
// diagonal, the window edge, the sinks, the ragged end). The softmax reduces
// across the 4 lanes that share a row and exponentiates on the SFU (ex2). The
// m16n8 accumulator layout is the m16n8k16 A layout, so P goes to bf16
// straight from the S registers (the unnormalised exp(s - m), where the plain
// version rounds the normalised probabilities) and never touches shared
// memory; V is the B operand through ldmatrix.trans. The output goes through
// the warp's own rows of the Q tile to 16-byte stores. Blocks start longest
// first: the grid's slowest index is the query tile, last rows first, so the
// causal tail is a short tile. hd 64, 80 (rows padded in shared memory,
// tile_ld) and 128; q, k, v need 16-byte aligned rows (the launcher checks).
// wgmma and TMA (the rest of the way to SDPA's time at hd 128) are later work.
//
// f32 (flash_attention_kernel): the first port's scalar kernel, unchanged: it
// keeps its tiles in shared memory as fp32 and forms both products with fp32
// FMAs, exactly (TF32 would not hold the f32 tolerance of 1e-5).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 128;   // scalar: 16 row groups of 4 rows x 8 column lanes;
                               // tensor cores: 4 warps of 16 rows
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;  // in elements; the head dim has stride 1
};

template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, Strides st, int row0,
                                          int rows, int n_valid) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < rows * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    dst[r * LD + d] = row0 + r < n_valid ? src[(row0 + r) * st.s + d] : 0.0f;
  }
}

// LSE: also write each row's logsumexp of the scaled scores (fp32, [B, H, Sq]
// contiguous; -inf for a row that sees no key) for the backward.
template <int HD, bool SINKS, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse,
                       int Sq, int Sk, int group, Strides sq, Strides sk, Strides sv,
                       Strides so, float scale, int causal, int window, int n_sink) {
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
  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + kvh * sk.h;
  const float* vp = v + b * sv.b + kvh * sv.h;
  float* op = o + b * so.b + h * so.h;

  const int rg = threadIdx.x / 8;  // rows rg*4 .. rg*4+3 of the tile
  const int cl = threadIdx.x % 8;  // key columns cl + 8c, output dims cl + 8e
  const int off = Sk - Sq;         // align the last query with the last key

  load_tile<HD>(qs, qp, sq, q0, BQ, Sq);

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
    load_tile<HD>(ks, kp, sk, k0, BK, Sk);
    load_tile<HD>(vs, vp, sv, k0, BK, Sk);
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
    for (int e = 0; e < NE; ++e) op[qi * so.s + cl + 8 * e] = acc[r][e] / l;
    if constexpr (LSE) {
      if (cl == 0)
        lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qi] =
            l_i[r] > 0.0f ? m_i[r] + logf(l_i[r]) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- bf16, tensor cores

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 fills zeros (ragged rows)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
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

// 2^x on the SFU (flushes subnormal results to 0: they add nothing to a sum
// that contains the row's largest term, 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Row stride, in elements, of a [rows][HD] bf16 tile in shared memory: HD at
// 64 and 128; at 80 (10 chunks of 16 bytes, where the XOR below would reach
// chunk 15, past the row) rows padded to 88 elements, 176 bytes: 11 chunks, so
// 8 consecutive rows start in 8 different bank groups (11 r mod 8).
template <int HD> __host__ __device__ constexpr int tile_ld() { return HD == 80 ? 88 : HD; }

// element offset of 16-byte chunk `c` of row `r` in a [rows][tile_ld] bf16
// tile: at 64 and 128 the chunk index is XORed with the row's low 3 bits, so
// the 8 rows one ldmatrix phase reads lie in 8 different bank groups; at 80
// the padded stride does that
template <int HD> __device__ __forceinline__ int swz(int r, int c) {
  if constexpr (HD == 80) return r * tile_ld<HD>() + (c << 3);
  else return r * HD + ((c ^ (r & 7)) << 3);
}

// rows [row0, row0 + 64) of a [S, hd] slice (row stride `ld`) into a swizzled
// tile; rows at or past n_valid are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long ld, int row0, int n_valid) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = row0 + r < n_valid;
    const __nv_bfloat16* g = src + (ok ? row0 + r : 0) * ld + c * 8;
    cp_async16(smem_u32(dst + swz<HD>(r, c)), g, ok ? 16 : 0);
  }
}

// MT: 16-row m-tiles per warp. The block holds 64 * MT query rows; warp w
// owns rows 16w + 64i (i < MT), so every K/V fragment read from shared memory
// feeds MT products, and each warp has an early and a late m-tile on the
// causal diagonal. With MT * HD <= 128 the Q fragments stay in registers,
// else they are read from the Q tile at every k-step.
// LSE as in the scalar kernel: a template parameter, so the serving
// instantiations (LSE = false) compile as they did without it.
template <int HD, int MT, bool SINKS, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Sk, int group, Strides sq,
                          Strides sk, Strides sv, Strides so, float scale, int causal,
                          int window, int n_sink) {
  static_assert(BK == 64 && THREADS == 128, "4 warps of 16-row m-tiles, 64-key tiles");
  constexpr int BQT = 64 * MT;       // query rows per block
  constexpr int KS = HD / 16;        // k-steps of QK^T
  constexpr int ND = HD / 8;         // 8-wide column blocks of O
  constexpr int TILE = BK * tile_ld<HD>();
  constexpr bool QREG = MT * HD <= 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MT][BK][tile_ld]
  __nv_bfloat16* ks = qs + MT * TILE;                               // [2][BK][tile_ld]
  __nv_bfloat16* vs = ks + 2 * TILE;                                // [2][BK][tile_ld]

  // blocks start in the order of their linear index: every head's and row's
  // tile of the last (longest causal) query rows first, then the next
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQT;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / group;
  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kp = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + kvh * sv.h;
  __nv_bfloat16* op = o + b * so.b + h * so.h;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // accumulator rows g and g + 8 of an m-tile
  const int t = lane % 4;        // accumulator columns 2t, 2t + 1 of each 8
  const int off = Sk - Sq;       // align the last query with the last key

  // keys that any row of this tile may see (as the scalar kernel)
  const int last_q = min(q0 + BQT, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, last_q + off + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int sink_end = SINKS ? ((n_sink + BK - 1) / BK) * BK : 0;
  auto next = [&](int k0) {
    return SINKS && k0 + BK >= sink_end && k0 + BK < k_begin ? k_begin : k0 + BK;
  };
  const int first = SINKS ? 0 : k_begin;

  // cp.async groups in order: Q, K0, V0, then K and V of each next tile
#pragma unroll
  for (int i = 0; i < MT; ++i) load_tile_async<HD>(qs + i * TILE, qp, sq.s, q0 + 64 * i, Sq);
  cp_async_commit();
  if (first < k_end) load_tile_async<HD>(ks, kp, sk.s, first, Sk);
  cp_async_commit();
  if (first < k_end) load_tile_async<HD>(vs, vp, sv.s, first, Sk);
  cp_async_commit();
  cp_async_wait<2>();  // the Q tile
  __syncthreads();

  // the warp's m-tile i holds tile rows rowt[i] .. rowt[i] + 15
  int rowt[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) rowt[i] = 64 * i + 16 * warp;
  uint32_t qf[QREG ? MT : 1][QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[i][kk], smem_u32(qs + swz<HD>(rowt[i] + lane % 16, 2 * kk + lane / 16)));
  }

  float acc[MT][ND][4];
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    m_r[i][0] = m_r[i][1] = -INFINITY;
    l_r[i][0] = l_r[i][1] = 0.0f;
  }

  int buf = 0;
  for (int k0 = first; k0 < k_end;) {
    cp_async_wait<1>();  // this tile's K
    __syncthreads();     // ... for every thread; and the other buffer is no longer read
    const int kn = next(k0);
    if (kn < k_end) load_tile_async<HD>(ks + (buf ^ 1) * TILE, kp, sk.s, kn, Sk);
    cp_async_commit();
    if (kn < k_end) load_tile_async<HD>(vs + (buf ^ 1) * TILE, vp, sv.s, kn, Sk);
    cp_async_commit();
    const __nv_bfloat16* kb = ks + buf * TILE;
    const __nv_bfloat16* vb = vs + buf * TILE;

    // the m-tiles that this tile cuts (an m-tile that sees none of its keys
    // is all masked: its max, sum and accumulator stay as they were)
    bool masked[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int lo = q0 + rowt[i] + off;  // positions of the m-tile's rows
      masked[i] = k0 + BK > Sk || (causal && k0 + BK - 1 > lo) ||
                  (window > 0 && lo + 15 - k0 >= window);
    }

    // S = Q K^T: per m-tile 16 x 64, 8 column blocks of 8 keys
    float s[MT][8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qk[MT][4];
      if constexpr (!QREG) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(qk[i], smem_u32(qs + swz<HD>(rowt[i] + lane % 16, 2 * kk + lane / 16)));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(kb + swz<HD>(np * 16 + lane % 8 + (lane / 16) * 8,
                                              2 * kk + (lane / 8) % 2)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t(&a)[4] = QREG ? qf[QREG ? i : 0][QREG ? kk : 0] : qk[i];
          mma_bf16(s[i][2 * np], a, kf[0], kf[1]);
          mma_bf16(s[i][2 * np + 1], a, kf[2], kf[3]);
        }
      }
    }

    // online softmax, per m-tile
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] *= scale;
      if (masked[i]) {
        const int qrow = q0 + rowt[i] + g + off;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * n + 2 * t + (e & 1);
            const int qpos = qrow + 8 * (e >> 1);
            const bool ok = kj < Sk && (!causal || kj <= qpos) &&
                            (window <= 0 || qpos - kj < window || (SINKS && kj < n_sink));
            if (!ok) s[i][n][e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i][n][0], s[i][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i][n][2], s[i][n][3]));
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes of a row are adjacent lanes of the warp
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[i][r], mx[r]);
        // a row that has seen no key yet keeps p = 0 and never forms inf - inf
        base[r] = m_new == -INFINITY ? 0.0f : m_new * LOG2E;
        alpha[r] = fast_exp2(fmaf(m_r[i][r], LOG2E, -base[r]));
        m_r[i][r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[i][n][e], LOG2E, -base[e >> 1]));
          s[i][n][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_r[i][r] = alpha[r] * l_r[i][r] + sum[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[i][n][0] *= alpha[0];
        acc[i][n][1] *= alpha[0];
        acc[i][n][2] *= alpha[1];
        acc[i][n][3] *= alpha[1];
      }
    }

    cp_async_wait<2>();  // this tile's V
    __syncthreads();

    // O += P V: P (bf16) from the S registers, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        pf[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
        pf[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
        pf[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
        pf[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vb + swz<HD>(16 * kk + lane % 8 + ((lane / 8) % 2) * 8,
                                                    2 * dp + lane / 16)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * dp], pf[i], vf[0], vf[1]);
          mma_bf16(acc[i][2 * dp + 1], pf[i], vf[2], vf[3]);
        }
      }
    }
    buf ^= 1;
    k0 = kn;
  }

  // normalise (rows that saw no key give 0) and store through the warp's own
  // rows of the Q tile, which no other warp reads
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = l_r[i][r] > 0.0f ? 1.0f / l_r[i][r] : 0.0f;
    const int r0 = rowt[i] + g;
    if constexpr (LSE) {
      // the row's 4 lanes hold the same m and l; lane t = 0 writes
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + r0 + 8 * r;
        if (t == 0 && qi < Sq)
          lse[(static_cast<long long>(b) * gridDim.x + h) * Sq + qi] =
              l_r[i][r] > 0.0f ? m_r[i][r] + logf(l_r[i][r]) : -INFINITY;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(qs + swz<HD>(r0, n) + 2 * t) =
          pack_bf16(acc[i][n][0] * inv[0], acc[i][n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(qs + swz<HD>(r0 + 8, n) + 2 * t) =
          pack_bf16(acc[i][n][2] * inv[1], acc[i][n][3] * inv[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = lane; j < 16 * ND; j += 32) {
      const int r = j / ND;
      const int c = j - r * ND;
      const int qi = q0 + rowt[i] + r;
      if (qi < Sq)
        *reinterpret_cast<uint4*>(op + qi * so.s + c * 8) =
            *reinterpret_cast<const uint4*>(qs + swz<HD>(rowt[i] + r, c));
    }
  }
}

// ---------------------------------------------------------------- launchers

// Raises a kernel's dynamic shared-memory limit once per device; `done` is the
// calling instantiation's bit set of devices already raised.
template <typename K>
cudaError_t smem_limit_once(std::atomic<unsigned long long>& done, K kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// the reference's scale: 1 / sqrt(hd) in double, rounded once to fp32
template <int HD> float softmax_scale() {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
}

template <int HD, bool SINKS, bool LSE>
int launch_scalar(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int H, int Sq, int Sk, int group, Strides sq, Strides sk, Strides sv,
                  Strides so, int causal, int window, int n_sink, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  constexpr int smem = sizeof(float) * ((BQ + 2 * BK) * LD + BQ * (BK + 1));
  auto kernel = flash_attention_kernel<HD, SINKS, LSE>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = smem_limit_once(done, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, group, sq, sk, sv,
      so, softmax_scale<HD>(), causal, window, n_sink);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int MT, bool SINKS, bool LSE>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
              int Sq, int Sk, int group, Strides sq, Strides sk, Strides sv, Strides so,
              int causal, int window, int n_sink, cudaStream_t stream) {
  constexpr int smem = sizeof(__nv_bfloat16) * (64 * MT + 4 * BK) * tile_ld<HD>();
  auto kernel = flash_attention_tc_kernel<HD, MT, SINKS, LSE>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = smem_limit_once(done, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + 64 * MT - 1) / (64 * MT));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, group,
      sq, sk, sv, so, softmax_scale<HD>(), causal, window, n_sink);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, void*, float*, int, int, int,
                       int, int, Strides, Strides, Strides, Strides, int, int, int,
                       cudaStream_t);

// the instantiation for (hd, sinks, lse) of a launcher family (the row
// logsumexp is written for training). The tensor-core
// kernel runs 2 m-tiles per warp at hd 128 (each K/V fragment feeds two
// products; 246-255 registers) and at hd 80 (faster than 1 at stablelm-3b's
// prefill), and 1 at hd 64, where two made the served hymba prefill slower
// (more registers, fewer blocks per SM).
template <int HD, int MT>
Launch pick_tc(bool sinks, bool lse) {
  if (lse) return sinks ? &launch_tc<HD, MT, true, true> : &launch_tc<HD, MT, false, true>;
  return sinks ? &launch_tc<HD, MT, true, false> : &launch_tc<HD, MT, false, false>;
}

template <int HD>
Launch pick_scalar(bool sinks, bool lse) {
  if (lse) return sinks ? &launch_scalar<HD, true, true> : &launch_scalar<HD, false, true>;
  return sinks ? &launch_scalar<HD, true, false> : &launch_scalar<HD, false, false>;
}

template <bool TC>
Launch pick(int hd, bool sinks, bool lse) {
  if (hd == 64) return TC ? pick_tc<64, 1>(sinks, lse) : pick_scalar<64>(sinks, lse);
  if (hd == 80) return TC ? pick_tc<80, 2>(sinks, lse) : pick_scalar<80>(sinks, lse);
  if (hd == 128) return TC ? pick_tc<128, 2>(sinks, lse) : pick_scalar<128>(sinks, lse);
  return nullptr;
}

template <bool TC>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int K, int Sq, int Sk, int hd, long long qb, long long qs, long long qh,
           long long kb, long long ks, long long kh, long long vb, long long vs, long long vh,
           long long ob, long long os, long long oh, int causal, int window, int n_sink,
           void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Launch fn = pick<TC>(hd, window > 0 && n_sink > 0, lse != nullptr);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, static_cast<float*>(lse), B, H, Sq, Sk, H / K, Strides{qb, qs, qh},
            Strides{kb, ks, kh}, Strides{vb, vs, vh}, Strides{ob, os, oh}, causal, window,
            n_sink, static_cast<cudaStream_t>(stream));
}


// ---------------------------------------------------------------- backward
//
// The FlashAttention-2 backward in the forward's mask (causal end-aligned,
// optional window, the first n_sink keys passing the window test). Inputs
// contiguous: q, o, dO [B, Sq, H, hd]; k, v [B, Sk, K, hd]; lse and delta fp32
// [B, H, Sq]. P is recomputed per tile from
// the forward's row logsumexp, P = exp(scale q.k - lse), 0 where masked (a row
// that sees no key has lse = -inf and every key masked, so it gives 0, never
// NaN);
//   dV = P^T dO (P rounded to the input type, as the forward's PV took it),
//   dP = dO V^T,  dS = P (dP - delta),  delta = rowsum(dO o),
//   dQ = scale dS K,  dK = scale dS^T Q.
// With sinks, a dK/dV block whose keys include one below n_sink walks every
// later query tile (the window no longer bounds them), and a dQ block visits
// the tiles below n_sink first and then jumps to its window's first tile, as
// the forward does; tiles that the window or the sinks cut are masked pair by
// pair. The kernels take SINKS as a template parameter, as the forward does,
// so that the paths without sinks (every other model's training) carry no
// sink test: their bounds and pair test are the window's alone and n_sink is
// not read. The launcher picks the sink instantiation where a window and
// n_sink > 0 are given.
// What bounds it on the H100: operations (five products of 2 hd flops per kept
// (query, key) pair and head, against q, k, v, o, dO read once and dq, dk, dv
// written once: at S 512, hd 128 about 600 flops a byte). No atomics: every sum
// runs in a fixed order, so the result is the same bit for bit call after call.
//
// f32 (attention_bwd_dkdv_kernel, attention_bwd_dq_kernel): the first port's
// scalar kernels, fp32 FMAs from shared memory. One block per (32-key tile, KV
// head, batch row) loops over the group's query heads and their query tiles
// and sums dK and dV in registers; one block per (query tile, query head, batch
// row) loops over the key tiles the forward visits for dQ.
//
// bf16 (attention_bwd_dq_tc_kernel, then attention_bwd_dkdv_tc_kernel): every
// product on mma.sync m16n8k16, bf16 operands and fp32 sums, the fragments from
// ldmatrix (.trans for the operand that is transposed) out of the forward's
// shared-memory layout (swz), with its helpers. Four warps; tiles of BT = 64
// rows; a warp owns 16 rows of the block's own tile and forms its scores
// against the streamed tile whole (fp32 scores of 16 x 64 and dP beside them),
// or in halves of 32 rows where the registers do not allow that (dK/dV at hd
// 128, beside its two hd-wide sums). The streamed tiles come by cp.async,
// double-buffered: the next one is in flight while this one is used.
//   dK/dV: one block per (64-key tile, part of the GQA group, KV head, batch
//   row). Its warps hold 16 keys each and form S^T = K Q^T and dP^T = V dO^T,
//   so the accumulator rows are keys; P^T and dS^T go to bf16 straight from
//   those registers as A fragments (the m16n8 accumulator layout is the
//   m16n8k16 A layout) for dV += P^T dO and dK += dS^T Q, with dO and Q
//   through ldmatrix.trans. The block walks its part's query heads and the
//   query tiles that see its keys. A part is a slice of the group: at qwen2.5-
//   3b's shape (B 4, S 512, 2 KV heads) 64-key tiles alone give 64 blocks on
//   132 SMs, so the launcher's caller splits the group (kernels/
//   flash_attention.py bwd_parts); each part then writes fp32 partial sums to
//   a workspace, and attention_bwd_sum_kernel adds the parts in order and
//   rounds. With one part (group 1, or blocks enough) dK and dV go straight
//   out. Key tiles start in order, the first (under the causal mask the
//   longest: they see every later query tile) first, so the short ones fill
//   the wave's end.
//   dQ: one block per (64-row query tile, query head, batch row), last tiles
//   (the longest) first; warps hold 16 query rows, form S = Q K^T and
//   dP = dO V^T, and dQ += dS K with K through ldmatrix.trans. It runs first
//   and forms delta for its rows itself (o and dO read while its tiles load),
//   writing it for the dK/dV blocks.
// P is rounded to bf16 for dV (as the forward's PV took it). dS, which the
// plain version keeps in fp32, is split into bf16 hi and lo halves, two
// products each for dK and dQ (split_frags): rounded once to bf16 instead, it
// held each gradient's tolerance alone but grew the error through a deep
// chain of layers (PERF.md). Each gradient is rounded once at the end. f32
// runs a delta pass (attention_bwd_delta_kernel) first. wgmma and TMA for these
// products are later work.

constexpr int BWD_THREADS = 256;
constexpr int BQB = 64;  // f32: query rows per tile
constexpr int BKB = 32;  // f32: keys per tile
constexpr int BT = 64;   // bf16: keys of a dK/dV block, rows of a dQ block and of every tile

template <int HD>
constexpr int bwd_smem_bytes() {
  return sizeof(float) * ((2 * BQB + 2 * BKB) * (HD + 1) + 2 * BQB * (BKB + 1) + 2 * BQB);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d]: one warp per (b, i, h)
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
attention_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, int H, int Sq, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (BWD_THREADS / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(o[row * HD + d], dout[row * HD + d], acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {
    const long long bi = row / H;  // b * Sq + i
    const int h = static_cast<int>(row - bi * H);
    const long long b = bi / Sq;
    delta[(b * H + h) * Sq + (bi - b * Sq)] = acc;
  }
}

// rows [row0, row0 + n) of head `head` of a contiguous [B, S, heads, HD]
// tensor (batch row already applied) into dst [n][HD + 1] as fp32, rows at or
// past S zero
template <int HD>
__device__ __forceinline__ void bwd_load(float* dst, const float* src, int heads, int head,
                                         int row0, int n, int S) {
  for (int i = threadIdx.x; i < n * HD; i += BWD_THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    dst[r * (HD + 1) + d] =
        row0 + r < S ? src[(static_cast<long long>(row0 + r) * heads + head) * HD + d] : 0.0f;
  }
}

// One [BQB, BKB] tile: thread (rg, cl) forms S and dP for rows 2 rg, 2 rg + 1
// and keys cl + 8 c (c < 4), then writes P into ps, where ps is not null,
// and dS into dss, both [BQB][BKB + 1].
template <int HD, bool SINKS>
__device__ __forceinline__ void bwd_tile(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s, float* ps, float* dss, int q0,
                                         int k0, int Sq, int Sk, float scale, int causal,
                                         int window, int n_sink) {
  constexpr int LD = HD + 1;
  constexpr int PLD = BKB + 1;
  const int rg = threadIdx.x / 8;
  const int cl = threadIdx.x % 8;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[2], dov[2], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qv[r] = qs[(2 * rg + r) * LD + d];
      dov[r] = dos[(2 * rg + r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(cl + 8 * c) * LD + d];
      vv[c] = vs[(cl + 8 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
      }
  }
  const int off = Sk - Sq;  // align the last query with the last key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * rg + r;
    const int qpos = q0 + row + off;
    const float l = lse_s[row];
    const float dl = delta_s[row];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kj = k0 + cl + 8 * c;
      const bool ok = q0 + row < Sq && kj < Sk && (!causal || kj <= qpos) &&
                      (window <= 0 || qpos - kj < window || (SINKS && kj < n_sink));
      const float p = ok ? expf(s[r][c] * scale - l) : 0.0f;
      if (ps != nullptr) ps[row * PLD + cl + 8 * c] = p;
      dss[row * PLD + cl + 8 * c] = p * (dp[r][c] - dl);
    }
  }
}

// a thread's output dims are dl + 32 e (e < NE); at hd 80 the last e covers
// only dl < 16
template <int HD> __device__ __forceinline__ bool has_dim(int dl, int e) {
  return HD % 32 == 0 || dl + 32 * e < HD;
}

template <int HD, bool SINKS>
__global__ void __launch_bounds__(BWD_THREADS)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Sk,
                          int group, float scale, int causal, int window, int n_sink) {
  constexpr int LD = HD + 1;
  constexpr int PLD = BKB + 1;
  constexpr int NE = (HD + 31) / 32;  // dims per thread: dl + 32 e
  extern __shared__ __align__(16) float bsm[];
  float* ks = bsm;                  // [BKB][LD]
  float* vs = ks + BKB * LD;        // [BKB][LD]
  float* qs = vs + BKB * LD;        // [BQB][LD]
  float* dos = qs + BQB * LD;       // [BQB][LD]
  float* ps = dos + BQB * LD;       // [BQB][PLD]
  float* dss = ps + BQB * PLD;      // [BQB][PLD]
  float* lse_s = dss + BQB * PLD;   // [BQB]
  float* delta_s = lse_s + BQB;     // [BQB]

  const int k0 = blockIdx.x * BKB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int K = H / group;
  const float* qb = q + static_cast<long long>(b) * Sq * H * HD;
  const float* dob = dout + static_cast<long long>(b) * Sq * H * HD;
  bwd_load<HD>(ks, k + static_cast<long long>(b) * Sk * K * HD, K, kvh, k0, BKB, Sk);
  bwd_load<HD>(vs, v + static_cast<long long>(b) * Sk * K * HD, K, kvh, k0, BKB, Sk);

  // the query tiles that see a key of this tile
  const int off = Sk - Sq;
  int q_begin = causal ? max(0, k0 - off) : 0;
  q_begin = (q_begin / BQB) * BQB;
  // every later query sees a sink key; the window bounds the others
  int q_end = Sq;
  if (window > 0 && (!SINKS || k0 >= n_sink))
    q_end = min(Sq, max(0, k0 + BKB - 1 + window - off));

  const int kr = threadIdx.x / 32;  // keys 4 kr .. 4 kr + 3
  const int dl = threadIdx.x % 32;
  float adk[4][NE], adv[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) adk[r][e] = adv[r][e] = 0.0f;

  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    for (int q0 = q_begin; q0 < q_end; q0 += BQB) {
      __syncthreads();  // the previous tile is no longer read
      bwd_load<HD>(qs, qb, H, h, q0, BQB, Sq);
      bwd_load<HD>(dos, dob, H, h, q0, BQB, Sq);
      for (int r = threadIdx.x; r < BQB; r += BWD_THREADS) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse[(static_cast<long long>(b) * H + h) * Sq + q0 + r] : -INFINITY;
        delta_s[r] = in ? delta[(static_cast<long long>(b) * H + h) * Sq + q0 + r] : 0.0f;
      }
      __syncthreads();
      bwd_tile<HD, SINKS>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, Sq, Sk, scale,
                          causal, window, n_sink);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQB; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = ps[i * PLD + 4 * kr + r];
          dsv[r] = dss[i * PLD + 4 * kr + r];
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          if (!has_dim<HD>(dl, e)) continue;
          const float dov = dos[i * LD + dl + 32 * e];
          const float qv = qs[i * LD + dl + 32 * e];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            adv[r][e] = fmaf(pv[r], dov, adv[r][e]);
            adk[r][e] = fmaf(dsv[r], qv, adk[r][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + 4 * kr + r;
    if (kj >= Sk) continue;
    const long long at = ((static_cast<long long>(b) * Sk + kj) * K + kvh) * HD;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (!has_dim<HD>(dl, e)) continue;
      dk[at + dl + 32 * e] = adk[r][e] * scale;
      dv[at + dl + 32 * e] = adv[r][e];
    }
  }
}

template <int HD, bool SINKS>
__global__ void __launch_bounds__(BWD_THREADS)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Sq, int Sk, int group, float scale,
                        int causal, int window, int n_sink) {
  constexpr int LD = HD + 1;
  constexpr int PLD = BKB + 1;
  constexpr int NE = (HD + 31) / 32;
  extern __shared__ __align__(16) float bsm[];
  float* ks = bsm;
  float* vs = ks + BKB * LD;
  float* qs = vs + BKB * LD;
  float* dos = qs + BQB * LD;
  float* dss = dos + BQB * LD + BQB * PLD;  // the dK/dV kernel's layout; no P here
  float* lse_s = dss + BQB * PLD;
  float* delta_s = lse_s + BQB;

  const int q0 = blockIdx.x * BQB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int K = H / group;
  const int kvh = h / group;
  bwd_load<HD>(qs, q + static_cast<long long>(b) * Sq * H * HD, H, h, q0, BQB, Sq);
  bwd_load<HD>(dos, dout + static_cast<long long>(b) * Sq * H * HD, H, h, q0, BQB, Sq);
  for (int r = threadIdx.x; r < BQB; r += BWD_THREADS) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse[(static_cast<long long>(b) * H + h) * Sq + q0 + r] : -INFINITY;
    delta_s[r] = in ? delta[(static_cast<long long>(b) * H + h) * Sq + q0 + r] : 0.0f;
  }
  const float* kb = k + static_cast<long long>(b) * Sk * K * HD;
  const float* vb = v + static_cast<long long>(b) * Sk * K * HD;

  // keys that any row of this tile sees (as the forward)
  const int off = Sk - Sq;
  const int last_q = min(q0 + BQB, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, last_q + off + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  k_begin = (k_begin / BKB) * BKB;
  // with sinks (and a window): the tiles below sink_end first, then from k_begin on
  const int sink_end = SINKS && window > 0 && n_sink > 0 ? ((n_sink + BKB - 1) / BKB) * BKB : 0;

  const int qr = threadIdx.x / 32;  // rows 8 qr .. 8 qr + 7
  const int dl = threadIdx.x % 32;
  float adq[8][NE];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) adq[r][e] = 0.0f;

  for (int k0 = SINKS && sink_end > 0 ? 0 : k_begin; k0 < k_end;
       k0 = SINKS && k0 + BKB >= sink_end && k0 + BKB < k_begin ? k_begin : k0 + BKB) {
    __syncthreads();  // the previous tile is no longer read
    bwd_load<HD>(ks, kb, K, kvh, k0, BKB, Sk);
    bwd_load<HD>(vs, vb, K, kvh, k0, BKB, Sk);
    __syncthreads();
    bwd_tile<HD, SINKS>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0, Sq, Sk, scale,
                        causal, window, n_sink);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BKB; ++jj) {
      float kv[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) kv[e] = has_dim<HD>(dl, e) ? ks[jj * LD + dl + 32 * e] : 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float dsv = dss[(8 * qr + r) * PLD + jj];
#pragma unroll
        for (int e = 0; e < NE; ++e) adq[r][e] = fmaf(dsv, kv[e], adq[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int qi = q0 + 8 * qr + r;
    if (qi >= Sq) continue;
    const long long at = ((static_cast<long long>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (has_dim<HD>(dl, e)) dq[at + dl + 32 * e] = adq[r][e] * scale;
  }
}

// ------------------------------------------------ backward, bf16 tensor cores

// s (16 x NC, fp32 m16n8 accumulators of NC / 8 column blocks) += X[r0, r0 +
// 16) Y[c0, c0 + NC)^T over HD: X and Y bf16 tiles in swz<HD>'s layout, X the
// A operand, Y's rows the B operand's columns (as the forward's Q K^T)
template <int HD, int NC>
__device__ __forceinline__ void mma_rows_by_rows(float (&s)[NC / 8][4], const __nv_bfloat16* x,
                                                 int r0, const __nv_bfloat16* y, int c0,
                                                 int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_u32(x + swz<HD>(r0 + lane % 16, 2 * kk + lane / 16)));
#pragma unroll
    for (int np = 0; np < NC / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_u32(y + swz<HD>(c0 + 16 * np + lane % 8 + (lane / 16) * 8,
                                           2 * kk + (lane / 8) % 2)));
      mma_bf16(s[2 * np], a, bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc (16 x HD, fp32) += A Y[c0, c0 + NC): A (16 x NC) given as the sum of NA
// sets of bf16 A fragments of its NC / 16 k-steps (1: A rounded to bf16; 2: A
// split into hi + lo), Y a bf16 tile in swz<HD>'s layout read through
// ldmatrix.trans (as the forward's P V), each B fragment read once for all NA
template <int HD, int NC, int NA>
__device__ __forceinline__ void mma_frags_by_tile(float (&acc)[HD / 8][4],
                                                  const uint32_t (&a)[NA][NC / 16][4],
                                                  const __nv_bfloat16* y, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, smem_u32(y + swz<HD>(c0 + 16 * kk + lane % 8 + ((lane / 8) % 2) * 8,
                                                 2 * dp + lane / 16)));
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        mma_bf16(acc[2 * dp], a[x][kk], bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a[x][kk], bf[2], bf[3]);
      }
    }
  }
}

// the m16n8 accumulators of a 16 x NC tile, rounded to bf16, as the A
// fragments of its NC / 16 k-steps of 16 columns
template <int NC>
__device__ __forceinline__ void to_frags(uint32_t (&a)[NC / 16][4],
                                         const float (&s)[NC / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// the same split into two bf16 halves: hi = s rounded (to_frags), lo = what
// that rounding lost, rounded; hi + lo keeps about 16 bits of s
template <int NC>
__device__ __forceinline__ void split_frags(uint32_t (&a)[2][NC / 16][4],
                                            const float (&s)[NC / 8][4]) {
  float lo[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      lo[n][e] = s[n][e] - __bfloat162float(__float2bfloat16_rn(s[n][e]));
  to_frags<NC>(a[0], s);
  to_frags<NC>(a[1], lo);
}

// (query, key) kept by the mask, at end-aligned positions (off = Sk - Sq)
template <bool SINKS>
__device__ __forceinline__ bool kept(int qi, int kj, int Sq, int Sk, int off, int causal,
                                     int window, int n_sink) {
  const int qpos = qi + off;
  return qi < Sq && kj < Sk && (!causal || kj <= qpos) &&
         (window <= 0 || qpos - kj < window || (SINKS && kj < n_sink));
}

template <int HD, bool SINKS>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ work, int H, int Sq, int Sk, int group,
                             int parts, float scale, int causal, int window, int n_sink) {
  static_assert(BT == BK && THREADS == 128, "4 warps of 16 rows, 64-row tiles");
  constexpr int TILE = BT * tile_ld<HD>();
  constexpr int ND = HD / 8;
  // queries a pass: the whole tile where the registers allow (the scores of 16
  // x 64 beside the hd-wide dK and dV sums), half of it at hd 128
  constexpr int NQ = HD <= 80 ? 64 : 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BT][tile_ld]: the keys
  __nv_bfloat16* vs = ks + TILE;                                    // [BT][tile_ld]
  __nv_bfloat16* qs = vs + TILE;                                    // [2][BT][tile_ld]
  __nv_bfloat16* dos = qs + 2 * TILE;                               // [2][BT][tile_ld]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);          // [2][BT], lse log2(e)
  float* delta_s = lse_s + 2 * BT;                                  // [2][BT]

  const int K = H / group;
  const int heads = group / parts;  // query heads of this block's part
  const int kvh = blockIdx.x / parts;
  const int part = blockIdx.x - kvh * parts;
  const int h0 = kvh * group + part * heads;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator rows g, g + 8: keys
  const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8: queries
  const int off = Sk - Sq;
  const long long qld = static_cast<long long>(H) * HD;  // row strides
  const long long kld = static_cast<long long>(K) * HD;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * Sq * qld;
  const __nv_bfloat16* dob = dout + static_cast<long long>(b) * Sq * qld;

  load_tile_async<HD>(ks, k + static_cast<long long>(b) * Sk * kld + kvh * HD, kld, k0, Sk);
  load_tile_async<HD>(vs, v + static_cast<long long>(b) * Sk * kld + kvh * HD, kld, k0, Sk);

  // the query tiles that see a key of this tile, for each query head of the part
  int q_begin = causal ? max(0, k0 - off) : 0;
  q_begin = (q_begin / BT) * BT;
  // every later query sees a sink key; the window bounds the others
  int q_end = Sq;
  if (window > 0 && (!SINKS || k0 >= n_sink))
    q_end = min(Sq, max(0, k0 + BT - 1 + window - off));
  const int n_q = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;
  const int steps = heads * n_q;

  auto load_q = [&](int it, int buf) {
    const int h = h0 + it / n_q;
    const int q0 = q_begin + (it % n_q) * BT;
    load_tile_async<HD>(qs + buf * TILE, qb + h * HD, qld, q0, Sq);
    load_tile_async<HD>(dos + buf * TILE, dob + h * HD, qld, q0, Sq);
    for (int r = threadIdx.x; r < BT; r += THREADS) {
      const bool in = q0 + r < Sq;
      const long long at = (static_cast<long long>(b) * H + h) * Sq + q0 + r;
      lse_s[buf * BT + r] = in ? lse[at] * LOG2E : 0.0f;
      delta_s[buf * BT + r] = in ? delta[at] : 0.0f;
    }
  };
  if (steps > 0) load_q(0, 0);
  cp_async_commit();  // K, V and the first query tile

  const float scale_log2 = scale * LOG2E;
  const int kw = k0 + 16 * warp;  // the warp's first key
  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.0f;

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();  // this query tile (and, the first time, K and V)
    __syncthreads();     // ... for every thread; and the other buffer is no longer read
    if (it + 1 < steps) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = q_begin + (it % n_q) * BT;
    const __nv_bfloat16* qt = qs + buf * TILE;
    const __nv_bfloat16* dot = dos + buf * TILE;
    const float* ls = lse_s + buf * BT;
    const float* dl = delta_s + buf * BT;
    // the warp's 16 keys against the tile's 64 queries: all kept, or tested pair by pair
    const bool masked = q0 + BT > Sq || kw + 16 > Sk || (causal && kw + 15 > q0 + off) ||
                        (window > 0 && q0 + BT - 1 + off - kw >= window);
#pragma unroll
    for (int c0 = 0; c0 < BT; c0 += NQ) {
      float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      mma_rows_by_rows<HD, NQ>(s, ks, 16 * warp, qt, c0, lane);   // S^T = K Q^T
      mma_rows_by_rows<HD, NQ>(dp, vs, 16 * warp, dot, c0, lane); // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * n + 2 * t + (e & 1);
          float p = fast_exp2(fmaf(s[n][e], scale_log2, -ls[col]));
          if (masked &&
              !kept<SINKS>(q0 + col, kw + g + 8 * (e >> 1), Sq, Sk, off, causal, window,
                           n_sink))
            p = 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl[col]);
        }
      }
      uint32_t pa[1][NQ / 16][4], da[2][NQ / 16][4];
      to_frags<NQ>(pa[0], s);
      split_frags<NQ>(da, dp);
      mma_frags_by_tile<HD, NQ, 1>(adv, pa, dot, c0, lane);  // dV += P^T dO
      mma_frags_by_tile<HD, NQ, 2>(adk, da, qt, c0, lane);   // dK += dS^T Q
    }
  }
  cp_async_wait<0>();  // a block that saw no query tile still waits for its K and V

  // one part: the gradients, rounded; several: this part's fp32 sums, [2][parts][B][Sk][K][HD]
  const long long n_all = static_cast<long long>(gridDim.y) * Sk * kld;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + g + 8 * r;
    if (kj >= Sk) continue;
    const long long at = (static_cast<long long>(b) * Sk + kj) * kld + kvh * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float k0v = adk[n][2 * r] * scale, k1v = adk[n][2 * r + 1] * scale;
      const float v0v = adv[n][2 * r], v1v = adv[n][2 * r + 1];
      if (parts == 1) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * n) = pack_bf16(v0v, v1v);
      } else {
        *reinterpret_cast<float2*>(work + part * n_all + at + 8 * n) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(work + (parts + part) * n_all + at + 8 * n) =
            make_float2(v0v, v1v);
      }
    }
  }
}

// dk, dv = the sums of the parts' fp32 partials (work [2][parts][n]), part 0
// first, rounded to bf16; 4 elements a thread (n is a multiple of 8)
__global__ void __launch_bounds__(256)
attention_bwd_sum_kernel(const float* __restrict__ work, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, long long n, int parts) {
  const long long quads = n / 4;
  long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= 2 * quads) return;
  const bool is_v = i >= quads;
  if (is_v) i -= quads;
  const float* src = work + (is_v ? parts * n : 0) + 4 * i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int p = 1; p < parts; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + 4 * i) =
      make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// dQ, and first the block's rows of delta = rowsum(dO o): in registers for
// dS here, and to device memory for the dK/dV kernel launched after this one
template <int HD, bool SINKS>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk, int group,
                           float scale, int causal, int window, int n_sink) {
  constexpr int TILE = BT * tile_ld<HD>();
  constexpr int ND = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BT][tile_ld]
  __nv_bfloat16* dos = qs + TILE;                                   // [BT][tile_ld]
  __nv_bfloat16* ks = dos + TILE;                                   // [2][BT][tile_ld]
  __nv_bfloat16* vs = ks + 2 * TILE;                                // [2][BT][tile_ld]
  float* delta_s = reinterpret_cast<float*>(vs + 2 * TILE);        // [BT]

  // the last (under the causal mask the longest) query tiles first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int K = H / group;
  const int kvh = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator rows g, g + 8: queries
  const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8: keys
  const int off = Sk - Sq;
  const long long qld = static_cast<long long>(H) * HD;
  const long long kld = static_cast<long long>(K) * HD;
  const long long qrow0 = static_cast<long long>(b) * Sq * qld + h * HD;
  const __nv_bfloat16* kp = k + static_cast<long long>(b) * Sk * kld + kvh * HD;
  const __nv_bfloat16* vp = v + static_cast<long long>(b) * Sk * kld + kvh * HD;

  load_tile_async<HD>(qs, q + qrow0, qld, q0, Sq);
  load_tile_async<HD>(dos, dout + qrow0, qld, q0, Sq);

  // keys that any row of this tile sees (as the forward)
  const int last_q = min(q0 + BT, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, last_q + off + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  k_begin = (k_begin / BT) * BT;
  // with sinks (and a window): the tiles below sink_end first, then from
  // k_begin on, as the forward visits them
  const int sink_end = SINKS && window > 0 && n_sink > 0 ? ((n_sink + BT - 1) / BT) * BT : 0;
  auto next = [&](int k0) {
    return SINKS && k0 + BT >= sink_end && k0 + BT < k_begin ? k_begin : k0 + BT;
  };
  const int first = SINKS && sink_end > 0 ? 0 : k_begin;
  if (first < k_end) {
    load_tile_async<HD>(ks, kp, kld, first, Sk);
    load_tile_async<HD>(vs, vp, kld, first, Sk);
  }
  cp_async_commit();  // Q, dO and the first K and V

  // delta of the warp's 16 rows while the tiles load: two rows a pass, 16
  // lanes a row, 16 bytes of o and dO a lane, summed in fp32
  const int qw = q0 + 16 * warp;  // the warp's first query row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 16 * warp + 2 * i + lane / 16;
    const int c = lane % 16;
    float acc = 0.0f;
    if (q0 + r < Sq && c < HD / 8) {
      const long long at = qrow0 + (q0 + r) * qld + 8 * c;
      const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + at);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(o2[j]);
        const float2 y = __bfloat1622float2(d2[j]);
        acc = fmaf(x.y, y.y, fmaf(x.x, y.x, acc));
      }
    }
#pragma unroll
    for (int x = 8; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (c == 0) {
      delta_s[r] = acc;
      if (q0 + r < Sq) delta[(static_cast<long long>(b) * H + h) * Sq + q0 + r] = acc;
    }
  }
  __syncwarp();  // the warp reads back only its own rows
  float lr[2], dr[2];  // lse log2(e) and delta of the thread's rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + 8 * r;
    lr[r] = qi < Sq ? lse[(static_cast<long long>(b) * H + h) * Sq + qi] * LOG2E : 0.0f;
    dr[r] = delta_s[16 * warp + g + 8 * r];
  }
  const float scale_log2 = scale * LOG2E;
  float adq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.0f;

  int buf = 0;
  for (int k0 = first; k0 < k_end; k0 = next(k0)) {
    cp_async_wait<0>();  // this K and V tile (and, the first time, Q and dO)
    __syncthreads();     // ... for every thread; and the other buffer is no longer read
    const int kn = next(k0);
    if (kn < k_end) {
      load_tile_async<HD>(ks + (buf ^ 1) * TILE, kp, kld, kn, Sk);
      load_tile_async<HD>(vs + (buf ^ 1) * TILE, vp, kld, kn, Sk);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + buf * TILE;
    const __nv_bfloat16* vt = vs + buf * TILE;
    // the warp's 16 rows against the tile's 64 keys: all kept, or tested pair by pair
    const bool masked = qw + 16 > Sq || k0 + BT > Sk || (causal && k0 + BT - 1 > qw + off) ||
                        (window > 0 && qw + 15 + off - k0 >= window);
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    mma_rows_by_rows<HD, BT>(s, qs, 16 * warp, kt, 0, lane);    // S = Q K^T
    mma_rows_by_rows<HD, BT>(dp, dos, 16 * warp, vt, 0, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fast_exp2(fmaf(s[n][e], scale_log2, -lr[r]));
        if (masked && !kept<SINKS>(qw + g + 8 * r, k0 + 8 * n + 2 * t + (e & 1), Sq, Sk, off,
                                   causal, window, n_sink))
          p = 0.0f;
        dp[n][e] = p * (dp[n][e] - dr[r]);
      }
    }
    uint32_t da[2][BT / 16][4];
    split_frags<BT>(da, dp);
    mma_frags_by_tile<HD, BT, 2>(adq, da, kt, 0, lane);  // dQ += dS K
    buf ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + 8 * r;
    if (qi >= Sq) continue;
    const long long at = qrow0 + qi * qld + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dq + at + 8 * n) =
          pack_bf16(adq[n][2 * r] * scale, adq[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------- backward launchers

template <int HD>
int launch_delta(const float* o, const float* dout, float* delta, int B, int H, int Sq,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  constexpr int WARPS_PER_BLOCK = BWD_THREADS / 32;
  if (rows <= 0) return 0;
  attention_bwd_delta_kernel<HD>
      <<<static_cast<unsigned>((rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), BWD_THREADS, 0,
         stream>>>(o, dout, delta, H, Sq, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool SINKS>
int launch_bwd_scalar(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int K, int Sq, int Sk, int causal, int window,
                      int n_sink, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<HD>();
  auto dkdv = attention_bwd_dkdv_kernel<HD, SINKS>;
  auto dqk = attention_bwd_dq_kernel<HD, SINKS>;
  static std::atomic<unsigned long long> done_dkdv{0}, done_dq{0};
  cudaError_t err = smem_limit_once(done_dkdv, dkdv, smem);
  if (err == cudaSuccess) err = smem_limit_once(done_dq, dqk, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* dot = static_cast<const float*>(dout);
  int e = launch_delta<HD>(static_cast<const float*>(o), dot, delta, B, H, Sq, stream);
  if (e != 0) return e;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float scale = softmax_scale<HD>();
  dkdv<<<dim3((Sk + BKB - 1) / BKB, K, B), BWD_THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
      H / K, scale, causal, window, n_sink);
  err = cudaGetLastError();
  if (err != cudaSuccess || Sq <= 0) return static_cast<int>(err);
  dqk<<<dim3((Sq + BQB - 1) / BQB, H, B), BWD_THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), H, Sq, Sk, H / K, scale, causal,
      window, n_sink);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool SINKS>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, float* work,
                  int B, int H, int K, int Sq, int Sk, int parts, int causal, int window,
                  int n_sink, cudaStream_t stream) {
  constexpr int tiles = 6 * BT * tile_ld<HD>() * static_cast<int>(sizeof(__nv_bfloat16));
  constexpr int smem_dkdv = tiles + 4 * BT * static_cast<int>(sizeof(float));
  constexpr int smem_dq = tiles + BT * static_cast<int>(sizeof(float));
  auto dkdv = attention_bwd_dkdv_tc_kernel<HD, SINKS>;
  auto dqk = attention_bwd_dq_tc_kernel<HD, SINKS>;
  static std::atomic<unsigned long long> done_dkdv{0}, done_dq{0};
  cudaError_t err = smem_limit_once(done_dkdv, dkdv, smem_dkdv);
  if (err == cudaSuccess) err = smem_limit_once(done_dq, dqk, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const float scale = softmax_scale<HD>();
  // dQ first: it writes delta, which the dK/dV blocks read
  if (Sq > 0) {
    dqk<<<dim3(H, B, (Sq + BT - 1) / BT), THREADS, smem_dq, stream>>>(
        qt, kt, vt, static_cast<const bf*>(o), dot, lse, delta, static_cast<bf*>(dq), H, Sq, Sk,
        H / K, scale, causal, window, n_sink);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dkdv<<<dim3(K * parts, B, (Sk + BT - 1) / BT), THREADS, smem_dkdv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), work, H, Sq, Sk,
      H / K, parts, scale, causal, window, n_sink);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts > 1) {
    const long long n = static_cast<long long>(B) * Sk * K * HD;
    attention_bwd_sum_kernel<<<static_cast<unsigned>((2 * (n / 4) + 255) / 256), 256, 0,
                               stream>>>(work, static_cast<bf*>(dk), static_cast<bf*>(dv), n,
                                         parts);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// the instantiation for (bf16, sinks) at head dim HD
template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, float* work,
               int B, int H, int K, int Sq, int Sk, int parts, bool bf16, int causal,
               int window, int n_sink, cudaStream_t s) {
  const bool sinks = window > 0 && n_sink > 0;
  if (bf16)
    return sinks ? launch_bwd_tc<HD, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, work, B,
                                           H, K, Sq, Sk, parts, causal, window, n_sink, s)
                 : launch_bwd_tc<HD, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, work, B,
                                            H, K, Sq, Sk, parts, causal, window, n_sink, s);
  return sinks ? launch_bwd_scalar<HD, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, K,
                                             Sq, Sk, causal, window, n_sink, s)
               : launch_bwd_scalar<HD, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, K,
                                              Sq, Sk, causal, window, n_sink, s);
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k and v [B, Sk, K, hd], o [B, Sq, H, hd] with H = K * group,
// given by pointers and (batch, seq, head) strides in elements; hd is 64, 80 or
// 128 with unit stride. window <= 0 means no window; with a window, keys below
// n_sink (>= 0) are seen by every query the causal mask lets see them. lse:
// null (serving), or fp32 [B, H, Sq] contiguous for each row's logsumexp of
// the scaled scores (-inf where the row sees no key).
// Returns the cudaError_t of the launch.

// float32 q, k, v, o: the scalar kernel
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                           int B, int H, int K, int Sq, int Sk, int hd, long long qb,
                           long long qs, long long qh, long long kb, long long ks,
                           long long kh, long long vb, long long vs, long long vh,
                           long long ob, long long os, long long oh, int causal, int window,
                           int n_sink, void* stream) {
  return launch<false>(q, k, v, o, lse, B, H, K, Sq, Sk, hd, qb, qs, qh, kb, ks, kh, vb, vs,
                       vh, ob, os, oh, causal, window, n_sink, stream);
}

// bfloat16 q, k, v, o: the tensor-core kernel. Every pointer 16-byte aligned
// and every stride a multiple of 8 elements.
int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int K, int Sq, int Sk, int hd, long long qb,
                              long long qs, long long qh, long long kb, long long ks,
                              long long kh, long long vb, long long vs, long long vh,
                              long long ob, long long os, long long oh, int causal,
                              int window, int n_sink, void* stream) {
  return launch<true>(q, k, v, o, lse, B, H, K, Sq, Sk, hd, qb, qs, qh, kb, ks, kh, vb, vs,
                      vh, ob, os, oh, causal, window, n_sink, stream);
}

// The backward of the attention above (window and n_sink as there): q, o,
// dout [B, Sq, H, hd], k, v [B, Sk, K, hd], lse fp32 [B, H, Sq] (the
// forward's), all contiguous (bf16: 16-byte aligned); delta fp32 [B, H, Sq]
// scratch; dq, dk, dv written, of q's dtype. bf16: 1 = bfloat16 (the
// tensor-core kernels), 0 = float32 (the scalar ones). hd 64, 80 or 128.
// parts: the slices of each GQA group that the bf16 dK/dV kernel's blocks take
// (dividing H / K; 1 for float32); above 1 work is fp32 [2, parts, B, Sk, K,
// hd] scratch for their partial sums.
// Returns the cudaError_t of the launches.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, void* work, int B, int H, int K, int Sq,
                               int Sk, int hd, int bf16, int causal, int window, int n_sink,
                               int parts, void* stream) {
  if (B <= 0 || Sk <= 0) return 0;
  if (K <= 0 || H % K != 0 || Sq < 0 || parts < 1 || (H / K) % parts != 0 ||
      (parts > 1 && (!bf16 || work == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_bwd<64>(q, k, v, o, dout, l, dl, dq, dk, dv, w, B, H, K, Sq, Sk, parts, bf16,
                          causal, window, n_sink, s);
  if (hd == 80)
    return launch_bwd<80>(q, k, v, o, dout, l, dl, dq, dk, dv, w, B, H, K, Sq, Sk, parts, bf16,
                          causal, window, n_sink, s);
  if (hd == 128)
    return launch_bwd<128>(q, k, v, o, dout, l, dl, dq, dk, dv, w, B, H, K, Sq, Sk, parts, bf16,
                           causal, window, n_sink, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// BT, the keys of a bf16 dK/dV block: the launcher's caller sizes the GQA
// split (bwd_parts) by it and checks it once against its own copy.
int flash_attention_bwd_tile() { return BT; }

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
