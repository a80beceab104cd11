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
// What bounds it on the H100: bytes, if the recurrence is not stepped one
// token at a time. Each step of each sequence reads four hd vectors and writes
// one (20 hd bytes) against about 5 hd^2 flops of state work: at N = 256,
// S = 512, hd = 64 the 176 MB moved take 0.053 ms, the 2.7 GFLOP 0.040 ms on
// the fp32 CUDA cores. A serial scan (one block of hd threads per sequence,
// one step after another) is held by the latency of every step instead: 256
// blocks of two warps leave each SM about four warps to hide it with.
//
// What the design does about it: the reference's chunked form, per chunk of
// L = 16 steps, with its products on the tensor cores. With ca the inclusive
// cumulative sum of lw from the chunk's start and ca_prev = ca - lw:
//
//   out   = (r o e^{ca_prev}) S0 + A V,   A[t, s] = sum_c r_t k_s e^{ca_prev[t] - ca[s]}  (s < t)
//                                         A[t, t] = sum_c r_t u k_t             (the bonus)
//   S_new = e^{ca_L} o S0 + (k o e^{ca_L - ca})^T V
//
// No exponent is above 0 for any lw <= 0, so nothing overflows; fully decayed
// terms underflow to 0, which is their limit. Every decay is a running
// product of e^{lw} (every factor <= 1), never a difference of large sums.
// A is cut into 8 x 8 sub-chunk blocks: the two diagonal ones pairwise (one
// multiply per pair), the off-diagonal one (t in 8..15, s in 0..7) factorised
// at step 8 as (r_t e^{ca_prev[t] - ca_prev[8]}) . (k_s e^{ca_prev[8] - ca[s]}),
// both factors <= 1, a tensor-core product. The state products (inter and
// hand-off) cost 4 hd^2 flops a step whatever L is, while A's pairwise work
// grows with L; 16 keeps A small and each product one or two mma k steps.
//
// One block per sequence, its warps in two roles, a chunk apart:
//   - producers (hd / 16 warps; lane (half, c) owns channel c for the 8 steps
//     of chunk half `half`): move r, k, v, lw by cp.async a chunk ahead
//     (double-buffered), then per chunk e^{lw}, the forward and backward
//     running products (the other half's total from lane ^ 16), A's diagonal
//     blocks over the warp's 16 channels (64 sums per lane, reduced and
//     scattered over the half warp with 60 shuffles), and A's off-diagonal
//     block over the same channels on the tensor cores. Each warp's parts of
//     A go to shared memory; the consumers add them;
//   - consumers (hd / 16 warps, 16 v rows each): hold the state in registers,
//     as the accumulator fragments of S^T [v, k], for the whole sequence, and
//     per chunk run out^T = S^T (r o e^{ca_prev})^T + V^T A^T (the state tile
//     is the A operand as it lies in the accumulator, its column 2 q4 (+1)
//     standing where the mma reads q4 (+4), so the B rows are permuted alike)
//     and S^T <- S^T o e^{ca_L} + V^T (k o e^{ca_L - ca}), mma.sync m16n8k8.
// Named barriers hand each chunk's buffer (Rd, Kd, V, the parts of A,
// e^{ca_L}; two, by chunk parity) from producers to consumers and back, so the
// producers prepare chunk c + 1 while the consumers compute chunk c. Each
// input element is read once, out written once, the state read and written
// once. 85 KB of shared memory and 256 threads a block at hd 64: two blocks
// (16 warps) an SM at N = 256. The serial kernel this replaces held one block
// of two warps per sequence, about four warps an SM, each step waiting on the
// last.
//
// Precision: split-precision TF32 (3xTF32). Each operand is a = a_hi + a_lo
// with a_hi cut to TF32 (exact), and a.b is summed as a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi in the fp32 accumulator: about 1e-6 of the largest entry, where
// one TF32 product keeps about three digits and the served states and
// outputs (1e3-1e5) would miss the tolerance of 1e-4 of the largest entry.
// The decays and A's diagonal blocks are plain fp32.
//
// Any S >= 1 (the last chunk's missing steps load as zeros: r = k = v = 0 and
// lw = 0 add nothing and decay nothing) and any N; hd is a template parameter
// (8, 16, 32, 64). Below hd 16 the v rows pad to one 16-row tile with zero v,
// and the producer lanes past hd own no channel.
//
// The backward (training, rwkv_scan_bwd_kernel): dr, dk, dv, dlw, du and
// dstate0 from r, k, v, lw, u, state0 and dout. Training never differentiates
// the final state, so its cotangent is zero. With G_t the cotangent of S_t
// (G_{S-1} = 0):
//
//   dr_t = S_{t-1} dout_t + u o k_t (v_t . dout_t)
//   dk_t = G_t v_t + u o r_t (v_t . dout_t),  dv_t = G_t^T k_t + (r_t . u o k_t) dout_t
//   dlw_t = e^{lw_t} o rowsum(G_t o S_{t-1}),  du = sum_t r_t o k_t (v_t . dout_t)
//   G_{t-1} = r_t dout_t^T + e^{lw_t} o G_t,   dstate0 = G_{-1}.
//
// dlw is the hard one: it needs S_{t-1} and G_t at the same step, while the
// states run forward and G backward. Walking the state backward by dividing
// by e^{lw} fails (the decay underflows to exactly 0), and keeping every
// state is N S hd^2 floats (2.1 GB at rwkv6-7b's training shape). The kernel
// needs neither: with Phi_t = rowsum(G_t o S_t), S_t - k_t v_t^T = e^{lw_t} o
// S_{t-1} gives dlw_t = Phi_t - K_t, and G_{t-1}'s definition gives
// Phi_{t-1} = dlw_t + R_t, where K_t = k_t o (G_t v_t) and R_t = r_t o
// (S_{t-1} dout_t) are the state parts of dk and dr. So Phi walks backward
// from Phi_{S-1} = 0 beside G, one number a row (in fp64: a running sum),
// and every input of it is an hd vector a step. Two sweeps of one block per
// sequence:
//   1. forward: the state in registers (from state0), dr's state part
//      S_{t-1} dout_t written to dr (global, read back by the same block);
//   2. backward: G in registers (from 0), G_t v_t and G_t^T k_t, then per
//      row the Phi walk, dlw, dk, dr, du; G_{-1} is dstate0.
// The walk has no decay to damp it: each step's fp32 rounding of K_t and R_t
// stays in Phi. How far dlw's error grows with S is measured on the card
// (chip_smoke.py's S 4096 case with strong decays, PERF.md section 6).
// Thread (i, jg) holds row i, columns 8 jg .. 8 jg + 7 of the state or of G
// (hd^2 / 8 threads; 512 at hd 64). A chunk of CK = 16 steps of r, k, v,
// e^{lw}, dout (and dr's state part) is staged in shared memory. The sums
// over columns (row sums) go through shared memory per chunk, each row's in
// column-group order; the sums over rows (G^T k) over the warp's lanes by a
// reduce-scatter of the 8 columns and, at hd 64, the two halves of the rows
// in shared memory. Every sum runs in a fixed order and nothing is atomic, so
// the gradients are the same bit for bit call after call. fp32 FMAs; the
// states recomputed as fmaf(e^{lw}, S, k v), the plain version's order. The
// per-step latency bounds it (two sweeps of S dependent steps a block), far
// from the bytes and flops it moves: tensor-core chunks are later work.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int L = 16;    // steps per chunk

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo: hi is x cut to TF32's 10 mantissa bits (so lo = x - hi is
// exact), and lo goes to the mma as its fp32 bits, which the tensor core reads
// as TF32 by dropping the low 13: two instructions a split
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bhi[2], blo[2];
  split(b0, bhi[0], blo[0]);
  split(b1, bhi[1], blo[1]);
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// Named barriers, counted in threads; the non-.aligned forms, which a warp
// need not reach converged. The producers sync among themselves; chunk buffer
// b is handed over filled (FULL + b) and back emptied (EMPTY + b).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
constexpr int BAR_PRODUCERS = 1, BAR_FULL = 2, BAR_EMPTY = 4;

// One step of a reduce-scatter over the 16 lanes of a half warp: lanes whose
// bit LANE is set keep the upper KEEP of their 2 KEEP sums, the others the
// lower, and each adds its partner's (lane ^ LANE) copy of the sums it keeps.
template <int LANE, int KEEP, int N>
__device__ __forceinline__ void reduce_scatter(float (&a)[N], int lane) {
  const bool up = lane & LANE;
#pragma unroll
  for (int i = 0; i < KEEP; ++i) {
    const float send = up ? a[i] : a[i + KEEP];
    const float keep = up ? a[i + KEEP] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, LANE);
  }
}

template <int HD> struct Plan {
  static constexpr int HV = HD < 16 ? 16 : HD;    // v rows, padded to one 16-row tile
  static constexpr int CW = HV / 16;              // consumer warps: 16 v rows of the state each
  static constexpr int PW = HD < 16 ? 1 : HD / 16;     // producer warps: 16 channels each
  static constexpr int PT = 32 * PW;              // producer threads
  static constexpr int THREADS = 32 * (CW + PW);
  static constexpr int KT = HD / 8;               // 8-wide k tiles of the state
  static constexpr int QPW = HD < 16 ? 1 : 2;     // 8-channel k steps of a producer warp
  static constexpr int LOADS = L * HD / PT;       // 16-byte copies of a producer a chunk
  static constexpr int RS = HV + 8;               // row stride of [L][*] tiles
  // rows L/2.. of a tile sit 16 floats further on, so that rows t and t + L/2
  // (which the two halves of a producer warp touch at once) fall in other banks
  static constexpr int TILE = L * RS + 16;
  static constexpr int AS = L + 8;                // row stride of A's parts
  // shared memory, in floats
  static constexpr int RAW = 4 * TILE;            // r, k, v, lw of one chunk
  // Rd, Kd, V; A's diagonal blocks by producer warp ([PW][L][AS], [s][t]); its
  // off-diagonal block by producer warp ([PW][L/2][L/2], [s][t - L/2]); e^{ca_L}
  static constexpr int PREP = 3 * TILE + PW * L * AS + PW * L / 2 * L / 2 + HD;
  static constexpr int SMEM_FLOATS = 2 * RAW + 2 * (L / 2 * RS + 16) + HD + 2 * PREP;
  static constexpr int SMEM = 4 * SMEM_FLOATS;
  static_assert(L * HD % PT == 0 && L == 16, "whole copies per producer; 8-step blocks");
};

template <int RS> __device__ __forceinline__ int row(int t) {
  return t * RS + (t >= L / 2 ? 16 : 0);
}

template <int HD>
__global__ void __launch_bounds__(Plan<HD>::THREADS, 2)
rwkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ s_out, int S) {
  using P = Plan<HD>;
  constexpr int RS = P::RS, AS = P::AS, T = P::THREADS, TILE = P::TILE, H = L / 2;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                           // [2][4][TILE]: r, k, v, lw (producers)
  float* Rq = raw + 2 * P::RAW;                // r o e^{ca_prev - ca_prev[8]}, t >= 8 [L/2][RS]
  float* Kq = Rq + H * RS + 16;                // k o e^{ca_prev[8] - ca}, s < 8 [L/2][RS]
  float* U = Kq + H * RS + 16;                 // u [HD]
  float* prep = U + HD;                        // [2][PREP], one per chunk parity

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;      // mma fragment row and column group
  const long n = blockIdx.x;
  const long seq = n * static_cast<long>(S) * HD;
  const int n_chunks = (S + L - 1) / L;

  for (int i = tid; i < HD; i += T) U[i] = u[n * HD + i];
  if (P::HV > HD) {                            // the padded v columns stay zero
    for (int i = tid; i < 2 * L * (RS - HD); i += T) {
      const int b = i / (L * (RS - HD)), rest = i % (L * (RS - HD));
      prep[b * P::PREP + 2 * TILE + row<RS>(rest / (RS - HD)) + HD + rest % (RS - HD)] = 0.0f;
    }
  }
  __syncthreads();

  if (warp >= P::CW) {
    // ---------------------------------------------------------------- producers
    // Lane (half, cl) of producer warp pw owns channel c = 16 pw + cl (hd 8:
    // lanes with cl >= 8 own none) for the steps of chunk half `half`.
    const int pt = tid - 32 * P::CW, pw = warp - P::CW;
    const int half = lane >> 4, cl = lane & 15, c = 16 * pw + cl;
    const bool live = HD >= 16 || cl < HD;
    auto fetch = [&](int ch) {                 // chunk ch's inputs into buffer ch & 1
      float* dst = raw + (ch & 1) * P::RAW;
#pragma unroll
      for (int it = 0; it < P::LOADS; ++it) {
        const int i = pt + it * P::PT;
        const int which = i / (L * HD / 4), p = i % (L * HD / 4);
        const int t = p / (HD / 4), col = 4 * (p % (HD / 4));
        const int tt = ch * L + t;
        const float* src = which == 0 ? r : which == 1 ? k : which == 2 ? v : lw;
        const bool in = tt < S;
        cp_async16(smem_u32(dst + which * TILE + row<RS>(t) + col),
                   src + seq + (in ? static_cast<long>(tt) * HD + col : 0), in ? 16 : 0);
      }
      cp_async_commit();
    };
    fetch(0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int b = ch & 1;
      float* Rd = prep + b * P::PREP;
      float* Kd = Rd + TILE;
      float* Vc = Kd + TILE;
      float* Ad = Vc + TILE;
      float* Aoff = Ad + P::PW * L * AS;
      float* decay = Aoff + P::PW * H * H;
      cp_async_wait_all();
      bar_sync(BAR_PRODUCERS, P::PT);          // chunk ch landed; chunk ch - 1 prepared
      if (ch + 1 < n_chunks) fetch(ch + 1);
      if (ch >= 2) bar_sync(BAR_EMPTY + b, T); // the consumers are done with chunk ch - 2
      const float* R = raw + b * P::RAW;
      const float* K = R + TILE;
      const float* V = K + TILE;
      const float* LW = V + TILE;

      // 1. this channel's 8 steps: e^{lw}, and the running products forward
      //    (e^{ca_prev}, from the half's start) and backward (e^{ca_L - ca},
      //    to the half's end); every factor <= 1. The other half's total
      //    product comes from lane ^ 16.
      float rv[H], kv[H], wv[H], fw[H], bw[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int t = H * half + i;
        rv[i] = live ? R[row<RS>(t) + c] : 0.0f;
        kv[i] = live ? K[row<RS>(t) + c] : 0.0f;
        wv[i] = live ? __expf(LW[row<RS>(t) + c]) : 1.0f;
      }
      float prod = 1.0f;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        fw[i] = prod;
        prod *= wv[i];
      }
      float back = 1.0f;
#pragma unroll
      for (int i = H - 1; i >= 0; --i) {
        bw[i] = back;
        back *= wv[i];
      }
      const float other = __shfl_xor_sync(0xffffffffu, prod, 16);
      if (live) {
        const float rs = half ? other : 1.0f, ks = half ? 1.0f : other;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const int t = H * half + i;
          Rd[row<RS>(t) + c] = rv[i] * (fw[i] * rs);
          Kd[row<RS>(t) + c] = kv[i] * (bw[i] * ks);
          // factorised at step 8 for A's off-diagonal block: r_t e^{ca_prev[t]
          // - ca_prev[8]} (t >= 8) and k_s e^{ca_prev[8] - ca[s]} (s < 8)
          if (half) Rq[i * RS + c] = rv[i] * fw[i];
          else Kq[i * RS + c] = kv[i] * bw[i];
        }
        if (half) decay[c] = prod * other;
      }

      // 2. A's diagonal block `half`, this channel's terms: A[t, s] for s < t
      //    in the block is r_t k_s times the product of e^{lw} strictly
      //    between, A[s, s] = r_s u k_s (the bonus). The 64 sums are reduced
      //    over the half warp's 16 channels and scattered, lane cl ending with
      //    s = 2 (cl / 2) .. of the block, t = 4 (cl & 1) .. +4.
      const float uc = live ? U[c] : 0.0f;
      float a[H * H];                          // [s][t] of the block
#pragma unroll
      for (int s = 0; s < H; ++s) {
        float pr = kv[s];
#pragma unroll
        for (int t = 0; t < H; ++t) {
          if (t < s) {
            a[s * H + t] = 0.0f;
          } else if (t == s) {
            a[s * H + t] = rv[t] * uc * kv[s];
          } else {
            a[s * H + t] = rv[t] * pr;
            pr *= wv[t];
          }
        }
      }
      reduce_scatter<8, 32>(a, lane);
      reduce_scatter<4, 16>(a, lane);
      reduce_scatter<2, 8>(a, lane);
      reduce_scatter<1, 4>(a, lane);
      *reinterpret_cast<float4*>(Ad + (pw * L + H * half + cl / 2) * AS + H * half +
                                 4 * (cl & 1)) = make_float4(a[0], a[1], a[2], a[3]);
      __syncwarp();

      // 3. A's off-diagonal block (t in 8..15, s in 0..7) over this warp's
      //    channels, factorised at step 8: A^T[s][t] = Kq[s] . Rq[t - 8], a
      //    3xTF32 product (M = s, rows 8..15 zero; N = t - 8; K = channels)
      {
        float off[4] = {};
#pragma unroll
        for (int q = pw * P::QPW; q < (pw + 1) * P::QPW; ++q) {
          const float* kp = Kq + g * RS + 8 * q + q4;
          const float* rp = Rq + g * RS + 8 * q + q4;
          uint32_t ahi[4] = {}, alo[4] = {};
          split(kp[0], ahi[0], alo[0]);
          split(kp[4], ahi[2], alo[2]);
          mma3(off, ahi, alo, rp[0], rp[4]);
        }
        *reinterpret_cast<float2*>(Aoff + (pw * H + g) * H + 2 * q4) =
            make_float2(off[0], off[1]);
      }
      for (int i = pt; i < L * HD / 4; i += P::PT) {   // V for the consumers
        const int t = i / (HD / 4), col = 4 * (i % (HD / 4));
        *reinterpret_cast<float4*>(Vc + row<RS>(t) + col) =
            *reinterpret_cast<const float4*>(V + row<RS>(t) + col);
      }
      bar_arrive(BAR_FULL + b, T);             // chunk ch is ready for the consumers
    }
    return;
  }

  // ---------------------------------------------------------------- consumers
  // warp w's state tiles, S^T[v][k] for v in 16 w .. +16: tile j holds k in
  // 8 j .. +8; fragment (row g or g + 8, column 2 q4 or 2 q4 + 1)
  const int v0 = 16 * warp;
  float st[P::KT][4];
#pragma unroll
  for (int j = 0; j < P::KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vv = v0 + g + 8 * (e >> 1), kk = 8 * j + 2 * q4 + (e & 1);
      st[j][e] = vv < HD ? s0[(n * HD + kk) * HD + vv] : 0.0f;
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    const float* Rd = prep + b * P::PREP;
    const float* Kd = Rd + TILE;
    const float* Vc = Kd + TILE;
    const float* Ad = Vc + TILE;
    const float* Aoff = Ad + P::PW * L * AS;
    const float* decay = Aoff + P::PW * H * H;
    bar_sync(BAR_FULL + b, T);
    __syncwarp();                              // mma.sync wants the whole warp converged

    // 3. tensor cores. V^T as the A operand: rows v, columns s (two k steps)
    uint32_t vhi[2][4], vlo[2][4];
#pragma unroll
    for (int qs = 0; qs < 2; ++qs) {
      const float* vp = Vc + row<RS>(8 * qs + q4) + v0 + g;
      split(vp[0], vhi[qs][0], vlo[qs][0]);
      split(vp[8], vhi[qs][1], vlo[qs][1]);
      split(vp[4 * RS], vhi[qs][2], vlo[qs][2]);
      split(vp[4 * RS + 8], vhi[qs][3], vlo[qs][3]);
    }
    // out^T[v][t], t tiles 0..7 and 8..15, each in two accumulators
    float acc[2][2][4] = {};
    // inter: S^T times (r o e^{ca_prev})^T. The state tile is the A operand as
    // it lies in the accumulator: its column 2 q4 (+1) stands where the mma
    // reads column q4 (+4), so the B rows are permuted alike
#pragma unroll
    for (int j = 0; j < P::KT; ++j) {
      uint32_t ahi[4], alo[4];
      split(st[j][0], ahi[0], alo[0]);
      split(st[j][2], ahi[1], alo[1]);
      split(st[j][1], ahi[2], alo[2]);
      split(st[j][3], ahi[3], alo[3]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float2 bb = *reinterpret_cast<const float2*>(Rd + row<RS>(8 * m + g) + 8 * j + 2 * q4);
        mma3(acc[m][j & 1], ahi, alo, bb.x, bb.y);
      }
    }
    // intra and the bonus: V^T A^T; A is lower-triangular, so t tile m needs
    // s tiles 0..m
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int qs = 0; qs <= m; ++qs) {
        float b0 = 0.0f, b1 = 0.0f;            // A^T[s][t], the producer warps' parts
#pragma unroll
        for (int w = 0; w < P::PW; ++w) {
          if (m == qs) {                       // a diagonal block
            b0 += Ad[(w * L + 8 * qs + q4) * AS + 8 * m + g];
            b1 += Ad[(w * L + 8 * qs + q4 + 4) * AS + 8 * m + g];
          } else {                             // the off-diagonal block
            b0 += Aoff[(w * H + q4) * H + g];
            b1 += Aoff[(w * H + q4 + 4) * H + g];
          }
        }
        mma3(acc[m][qs & 1], vhi[qs], vlo[qs], b0, b1);
      }
    }
    // hand-off: S^T <- S^T o e^{ca_L} + V^T (k o e^{ca_L - ca})
#pragma unroll
    for (int j = 0; j < P::KT; ++j) {
      const float d0 = decay[8 * j + 2 * q4], d1 = decay[8 * j + 2 * q4 + 1];
      st[j][0] *= d0;
      st[j][1] *= d1;
      st[j][2] *= d0;
      st[j][3] *= d1;
#pragma unroll
      for (int qs = 0; qs < 2; ++qs) {
        const float* kp = Kd + row<RS>(8 * qs + q4) + 8 * j + g;
        mma3(st[j], vhi[qs], vlo[qs], kp[0], kp[4 * RS]);
      }
    }
    if (c + 2 < n_chunks) bar_arrive(BAR_EMPTY + b, T);   // buffer b is free again
    const int steps = min(L, S - c * L);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * m + 2 * q4 + (e & 1), vv = v0 + g + 8 * (e >> 1);
        if (t < steps && vv < HD)
          out[seq + static_cast<long>(c * L + t) * HD + vv] = acc[m][0][e] + acc[m][1][e];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P::KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vv = v0 + g + 8 * (e >> 1), kk = 8 * j + 2 * q4 + (e & 1);
      if (vv < HD) s_out[(n * HD + kk) * HD + vv] = st[j][e];
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int CK = 16;   // steps a backward chunk stages in shared memory

template <int HD> struct BwdPlan {
  static constexpr int JG = HD / 8;                      // column groups of 8
  static constexpr int THREADS = HD * JG < 32 ? 32 : HD * JG;
  static constexpr int W = HD < 32 ? HD : 32;            // a warp's lanes over one column group
  static constexpr int PARTS = HD / W;                   // row slices of a column sum
  // R, K, V, E (e^{lw}), DO, DR (dr's state part): [CK][HD] each; row partials
  // [CK][JG][HD]; column partials [CK][PARTS][HD]; v.dout and r.(u o k) [CK]; u [HD]
  static constexpr int SMEM_FLOATS = 6 * CK * HD + CK * JG * HD + CK * PARTS * HD + 2 * CK + HD;
  static constexpr int SMEM = 4 * SMEM_FLOATS;
};

template <int HD>
__global__ void __launch_bounds__(BwdPlan<HD>::THREADS)
rwkv_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     const float* __restrict__ dout, float* dr, float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dlw, float* __restrict__ du,
                     float* __restrict__ ds0, int S) {
  using P = BwdPlan<HD>;
  constexpr int JG = P::JG, T = P::THREADS, W = P::W;
  extern __shared__ __align__(16) float smem[];
  float* R = smem;                             // [CK][HD]
  float* K = R + CK * HD;
  float* V = K + CK * HD;
  float* E = V + CK * HD;                      // e^{lw}
  float* DO = E + CK * HD;
  float* DR = DO + CK * HD;                    // dr's state part (sweep 2)
  float* rp = DR + CK * HD;                    // [CK][JG][HD]
  float* cp = rp + CK * JG * HD;               // [CK][PARTS][HD]
  float* vdo = cp + CK * P::PARTS * HD;        // [CK]
  float* ruk = vdo + CK;                       // [CK]
  float* U = ruk + CK;                         // [HD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid % HD, jg = tid / HD;
  const bool live = jg < JG;                   // hd 8: lanes 8.. of the one warp own nothing
  const int j0 = live ? 8 * jg : 0;
  const long n = blockIdx.x;
  const long seq = n * static_cast<long>(S) * HD;
  const int n_chunks = (S + CK - 1) / CK;
  for (int x = tid; x < HD; x += T) U[x] = u[n * HD + x];

  // a chunk's [CK][HD] rows of `src` into `dst`, zero past S
  auto stage = [&](float* dst, const float* src, int t0, int steps, bool exp_of) {
    for (int x = tid; x < CK * HD; x += T) {
      const int q = x / HD;
      const float val = q < steps ? src[seq + static_cast<long>(t0) * HD + x] : 0.0f;
      dst[x] = exp_of ? expf(val) : val;
    }
  };

  // ---- sweep 1, forward: S_{t-1} dout_t into dr
  float st[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) st[jj] = live ? s0[(n * HD + i) * HD + j0 + jj] : 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * CK, steps = min(CK, S - t0);
    stage(K, k, t0, steps, false);
    stage(V, v, t0, steps, false);
    stage(E, lw, t0, steps, true);
    stage(DO, dout, t0, steps, false);
    __syncthreads();
    for (int q = 0; q < steps; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc = fmaf(st[jj], DO[q * HD + j0 + jj], acc);
      if (live) rp[(q * JG + jg) * HD + i] = acc;
      const float e = E[q * HD + i], kq = K[q * HD + i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) st[jj] = fmaf(e, st[jj], kq * V[q * HD + j0 + jj]);
    }
    __syncthreads();
    for (int x = tid; x < steps * HD; x += T) {
      const int q = x / HD, ii = x - q * HD;
      float sum = rp[q * JG * HD + ii];
      for (int g = 1; g < JG; ++g) sum += rp[(q * JG + g) * HD + ii];
      dr[seq + static_cast<long>(t0) * HD + x] = sum;
    }
    // the next chunk's staging writes none of rp, and its rp writes come after its sync
  }

  // ---- G_{S-1} = 0, Phi_{S-1} = 0
  float G[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) G[jj] = 0.0f;
  double phi = 0.0;                            // the row threads' (tid < HD) running Phi
  float du_acc = 0.0f;
  __syncthreads();                             // dr's state part is visible to the block

  // ---- sweep 2, backward
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * CK, steps = min(CK, S - t0);
    stage(R, r, t0, steps, false);
    stage(K, k, t0, steps, false);
    stage(V, v, t0, steps, false);
    stage(E, lw, t0, steps, true);
    stage(DO, dout, t0, steps, false);
    stage(DR, dr, t0, steps, false);
    __syncthreads();
    // the bonus's dot products, a warp a step
    for (int q = warp; q < steps; q += T / 32) {
      float a = 0.0f, b = 0.0f;
      for (int x = lane; x < HD; x += 32) {
        a = fmaf(V[q * HD + x], DO[q * HD + x], a);
        b = fmaf(R[q * HD + x] * U[x], K[q * HD + x], b);
      }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, x);
        b += __shfl_xor_sync(0xffffffffu, b, x);
      }
      if (lane == 0) {
        vdo[q] = a;
        ruk[q] = b;
      }
    }
    for (int q = steps - 1; q >= 0; --q) {
      // G holds G_t: its row sums against v_t, its column sums against k_t
      const float kq = K[q * HD + i];
      float acc = 0.0f, col[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        acc = fmaf(G[jj], V[q * HD + j0 + jj], acc);
        col[jj] = G[jj] * kq;
      }
      if (live) rp[(q * JG + jg) * HD + i] = acc;
      reduce_scatter<W / 2, 4>(col, lane);
      reduce_scatter<W / 4, 2>(col, lane);
      reduce_scatter<W / 8, 1>(col, lane);
#pragma unroll
      for (int x = W / 16; x > 0; x >>= 1) col[0] += __shfl_xor_sync(0xffffffffu, col[0], x);
      if (live && lane % (W / 8) == 0) {
        const int c = (lane % W) / (W / 8);     // the column this lane's sum is of
        cp[(q * P::PARTS + i / W) * HD + j0 + c] = col[0];
      }
      // G_{t-1} = r_t dout_t^T + e^{lw_t} o G_t
      const float rq = R[q * HD + i], e = E[q * HD + i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) G[jj] = fmaf(e, G[jj], rq * DO[q * HD + j0 + jj]);
    }
    __syncthreads();
    if (tid < HD) {                            // row i = tid: the Phi walk, dlw, dk, dr, du
      const float ui = U[tid];
      for (int q = steps - 1; q >= 0; --q) {
        const int x = q * HD + tid;
        float gv = rp[q * JG * HD + tid];
        for (int g = 1; g < JG; ++g) gv += rp[(q * JG + g) * HD + tid];
        const float rq = R[x], kq = K[x], vd = vdo[q];
        const double dlw_t = phi - static_cast<double>(kq * gv);
        phi = dlw_t + static_cast<double>(rq * DR[x]);
        const long at = seq + static_cast<long>(t0) * HD + x;
        dlw[at] = static_cast<float>(dlw_t);
        dk[at] = fmaf(ui * rq, vd, gv);
        dr[at] = fmaf(ui * kq, vd, DR[x]);
        du_acc = fmaf(rq * kq, vd, du_acc);
      }
    }
    for (int x = tid; x < steps * HD; x += T) {
      const int q = x / HD, j = x - q * HD;
      float sum = cp[q * P::PARTS * HD + j];
      for (int p = 1; p < P::PARTS; ++p) sum += cp[(q * P::PARTS + p) * HD + j];
      dv[seq + static_cast<long>(t0) * HD + x] = fmaf(ruk[q], DO[x], sum);
    }
    __syncthreads();                           // the staged chunk is read; the next overwrites it
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    if (live) ds0[(n * HD + i) * HD + j0 + jj] = G[jj];
  if (tid < HD) du[n * HD + tid] = du_acc;
}

// Raises the kernel's dynamic shared-memory limit once per device; `done` is
// the instantiation's bit set of devices already raised.
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

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* out, void* s_out, int N, int S, cudaStream_t stream) {
  using P = Plan<HD>;
  auto kernel = rwkv_scan_kernel<HD>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = smem_limit_once(done, kernel, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, P::THREADS, P::SMEM, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_out), S);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
               const void* s0, const void* dout, void* dr, void* dk, void* dv, void* dlw,
               void* du, void* ds0, int N, int S, cudaStream_t stream) {
  using P = BwdPlan<HD>;
  auto kernel = rwkv_scan_bwd_kernel<HD>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = smem_limit_once(done, kernel, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  kernel<<<N, P::THREADS, P::SMEM, stream>>>(
      f(r), f(k), f(v), f(lw), f(u), f(s0), f(dout), static_cast<float*>(dr),
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dlw),
      static_cast<float*>(du), static_cast<float*>(ds0), S);
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

// The backward: r, k, v, lw, u, state0 as above; dout [N, S, hd] (the final
// state's cotangent is zero). Writes dr, dk, dv, dlw [N, S, hd], du [N, 1, hd]
// and dstate0 [N, hd, hd]. All fp32, contiguous, on one device. Returns the
// cudaError_t of the launch.
int rwkv_scan_bwd_launch(const void* r, const void* k, const void* v, const void* lw,
                         const void* u, const void* state0, const void* dout, void* dr,
                         void* dk, void* dv, void* dlw, void* du, void* dstate0, int N, int S,
                         int hd, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  using Bwd = int (*)(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, void*, void*, void*, void*, int,
                      int, cudaStream_t);
  const Bwd fn = hd == 8 ? &launch_bwd<8> : hd == 16 ? &launch_bwd<16>
                 : hd == 32 ? &launch_bwd<32> : hd == 64 ? &launch_bwd<64> : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(r, k, v, lw, u, state0, dout, dr, dk, dv, dlw, du, dstate0, N, S,
            static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
