// Masked flash-attention backward (K3) for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the two Pallas TPU kernels of the JAX package's flash backward,
// sam2_opt_tpu/kernels/flash_attention.py::_bwd_dkdv_kernel (K3a,
// `pallas_call` at :508) and ::_bwd_dq_kernel (K3b, :536), and computes
// exactly what they compute, given the forward's row log-sum-exp `lse` and
// delta = rowsum(dO * O) (fp32, computed by the wrapper as the JAX package
// does it in XLA):
//   s  = (q . k^T) * scale
//   p  = exp(s - lse) where the key is valid and lse > -0.5e30, else 0
//   dV = sum_q round(p) dO             (p rounded to dO's dtype)
//   dP = dO . v^T
//   dS = round(p * (dP - delta))       (rounded to q's dtype)
//   dK = scale * sum_q dS q,  dQ = scale * sum_k dS k
// with every product accumulated in fp32. dQ, dK, dV are written in fp32
// ([B*H, S, D], contiguous); the wrapper casts them to the input dtypes.
// The JAX scheme, without atomics, so two launches on the same inputs give
// bitwise-equal gradients: K3a keeps the dK and dV of a tile of keys on the
// SM and streams the query tiles; K3b keeps the dQ of a tile of query rows
// and streams the kv tiles. Skipped work is exact: a K3a CTA whose keys are
// all masked writes zeros, K3a skips query tiles of fully masked rows
// (lse = -1e30), a K3b CTA with no live row writes zeros, and K3b skips kv
// tiles with no valid key (the empty memory slots of early training frames).
//
// Bound. 8 * Sq * Skv * D operations per (b, h) for K3a (S, dP, dV, dK) and
// 6 * Sq * Skv * D for K3b (S, dP, dQ), on 10-20 bytes per token row: bound
// by operations. At the training shapes (hiera-b+ global blocks, B*H = 64,
// 4096 x 4096, D = 56; memory cross attention (2, 4096, 28,704, 256) and
// self attention (2, 4096, 4096, 256)), K3a+K3b do 842 GFLOP at the cross
// shape: 0.85 ms at bf16's 989 TFLOP/s, 5.1 ms at a third of TF32's 495
// (the fp32 route below), 12.6 ms at the CUDA cores' 67.
//
// bf16: warp-specialised wgmma fed by TMA (the layout of fused_mlp.cu). A
// CTA is three warpgroups: one warp of the first keeps TMA loads in flight
// (40 registers, setmaxnreg), the other two warpgroups consume (232). Tiles
// arrive as 128-byte swizzled boxes of 64 head-dim columns (the head dim is
// padded to DP, a multiple of 64, by TMA's zero fill, and rows past S are
// zero-filled the same way), into a ring of stages with mbarrier full/empty
// pairs. The producer walks the streamed tiles and skips the dead ones; it
// writes beside each stage its first row (or the end) and what it read to
// decide, the tile's lse and delta (K3a) or its key flags (K3b), so the
// consumers read those from shared memory, not from L2 between products.
//  - K3a, 64 keys per CTA (128 up to D = 64), 64 query rows per stage.
//    Every product maps onto wgmma without a transposed copy: S^T = K Q^T
//    and dP^T = V dO^T take K-major operands; dV += P^T dO and dK += dS^T Q
//    take A from registers (the S^T / dP^T accumulator fragment, rounded, is
//    the A fragment of the next product) and the MN-major B that 16-bit
//    wgmma allows, from the same swizzled Q / dO boxes. dK and dV of 64 keys
//    at D = 256 are 128 fp32 registers a thread each, so the two consumers
//    split the work: warpgroup 1 computes S^T, P, and owns dV; warpgroup 2
//    computes dP^T and owns dK, reading P (fp32, in warpgroup 1's fragment
//    layout, which is its own) from shared memory behind two named barriers.
//    Up to D = 64 each warpgroup owns 64 keys and computes all four
//    products: 128 keys per CTA, no exchange.
//  - K3b, 128 query rows per CTA (64 per consumer warpgroup, each with its
//    own S, dP and dQ), 64 keys per stage (32 at DP > 128, for shared
//    memory): S = Q K^T, dP = dO V^T K-major, dQ += dS K with dS from
//    registers and K MN-major.
//  - Fill the card: where the grid would not fill one wave of SMs (K3b at
//    the memory-attention shapes: 64 CTAs), the streamed axis is split over
//    up to 8 CTAs that write fp32 partial sums to scratch the wrapper
//    allocates; a second kernel sums them in a fixed order.
// Against the first version of these kernels (16 keys / 32 rows per CTA at
// D = 256, synchronous loads, mma.sync), K3a re-reads Q and dO from L2 4x less often at the
// cross shape and K3b K and V 4x less often. Issuing tile i + 1's S/dP
// before tile i's D-wide product (a software pipeline in each warpgroup)
// ran slower on the card, so each warpgroup finishes a tile before the next.
//
// fp32: the tensor cores with a three-pass TF32 split, the route of the
// library's fp32 attention backward. Each fp32 operand splits as a = a_hi +
// a_lo (a_hi = tf32(a), a_lo = tf32(a - a_hi)) and each product is a_lo b_hi
// + a_hi b_lo + a_hi b_hi, accumulated in fp32 (mma.sync m16n8k8): about
// 2^-21 of |a b| per product against fp32's 2^-24. The tensor cores'
// accumulation does not round to nearest, and over the 28,704 keys of a
// memory cross attention that alone took dQ past 1e-4 of max |g|; so each
// tile's dV, dK or dQ products sum into a zeroed partial that is added to
// the running sum with an fp32 add, as an FMA kernel sums. wgmma's tf32 form
// takes K-major operands only, so fp32 keeps the first version's two-phase
// layout (P and dS through shared memory, tiles copied with 16-byte
// cp.async), with the products on mma.sync: the ones whose B is [k][n]
// take k in the order (2t, 2t+1) for lane t's (t, t+4), so A loads 8 bytes
// at once and B's rows fall on distinct banks. The head dim is padded to a
// multiple of 16 (56 kept as it is), and above D = 128 both kernels run 8
// warps (K3a 32 keys a CTA, K3b 64 rows and 32 keys a step), 4 below. The
// exponentials are one ex2 each, in both dtypes.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* mask;  // [B, Skv] bool, row stride mask_sb; null = all valid
  const float* lse;     // [B*H, Sq]
  const float* delta;   // [B*H, Sq]
  float* dq;            // [B*H, Sq, D], or [n_split, B*H, Sq, D] partial sums
  float* dk;            // [B*H, Skv, D], or partial sums
  float* dv;            // [B*H, Skv, D], or partial sums
  int B, H, Sq, Skv, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // dout
  long long mask_sb;
  float scale;
  int n_split;             // the streamed axis split over this many CTAs (bf16)
  long long part_stride;   // elements between two splits' partial sums
};

__device__ __forceinline__ bool key_valid(const uint8_t* mg, int key, int Skv) {
  return key < Skv && (mg == nullptr || mg[key] != 0);
}

// p = exp(s * scale - lse) as one ex2 (scale_log2 = scale * log2(e))
__device__ __forceinline__ float exp_shifted(float s, float scale_log2, float lse) {
  return exp2f(fmaf(s, scale_log2, -lse * LOG2E));
}

// ===========================================================================
// fp32: two phases, three-pass TF32 on mma.sync
// ===========================================================================

constexpr int BQ = 64;  // query rows per step of K3a
constexpr int PAD = 4;  // fp32 row padding: rows 16-byte aligned, on distinct banks

// rows [r0, r0 + rows) of a [*, D] matrix with row stride rs (rows 16-byte
// aligned) into a [rows][ld] tile, zero past `limit` rows and past D
// columns: 16-byte cp.async copies, all in flight at once; cp_async_wait
// before the barrier that publishes the tile
template <int DP, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long rs,
                                          int r0, int rows, int limit, int D) {
  constexpr int CH = DP / 4;  // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool in = r0 + r < limit && c < D;
    const float* g = in ? src + static_cast<long long>(r0 + r) * rs + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst + r * ld + c)),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in three TF32 products, the small ones first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma_tf32(c, alo, b0h, b1h);
  mma_tf32(c, ahi, b0l, b1l);
  mma_tf32(c, ahi, b0h, b1h);
}

// Warp products in the m16n8 accumulator layout: lane (g = lane / 4,
// t = lane % 4) holds c[n][0..3] = C[g][8n + 2t], C[g][8n + 2t + 1],
// C[g + 8][8n + 2t], C[g + 8][8n + 2t + 1]. A is row-major [16][k].
//   mma_abT: C[16][8 NT] += A[16][8 K8] . B^T, B stored [8 NT rows][k]
//   mma_ab:  C[16][8 ND] += A[16][8 K8] . B,   B stored [k rows][8 ND]
template <int NT, int K8>
__device__ __forceinline__ void mma_abT(float (&c)[NT][4], const float* A, int lda, const float* B,
                                        int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a0p = A + g * lda + t;
  const float* a1p = A + (g + 8) * lda + t;
  const float* bp = B + g * ldb + t;
#pragma unroll 2
  for (int kk = 0; kk < 8 * K8; kk += 8) {
    uint32_t ahi[4], alo[4];
    split_tf32(a0p[kk], ahi[0], alo[0]);
    split_tf32(a1p[kk], ahi[1], alo[1]);
    split_tf32(a0p[kk + 4], ahi[2], alo[2]);
    split_tf32(a1p[kk + 4], ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_3xtf32(c[n], ahi, alo, bp[8 * n * ldb + kk], bp[8 * n * ldb + kk + 4]);
  }
}

template <int ND, int K8>
__device__ __forceinline__ void mma_ab(float (&c)[ND][4], const float* A, int lda, const float* B,
                                       int ldb) {
  // the tensor cores add into their fp32 accumulator without rounding to
  // nearest, an error that grows with the number of chained products: this
  // tile's products go to a zeroed partial sum, added to c rounded
  float part[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // k of lane t's (t, t + 4) taken from columns (2t, 2t + 1) of each 8
  const float* a0p = A + g * lda + 2 * t;
  const float* a1p = A + (g + 8) * lda + 2 * t;
  const float* bp = B + 2 * t * ldb + g;
#pragma unroll 2
  for (int kk = 0; kk < 8 * K8; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(a0p + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a1p + kk);
    uint32_t ahi[4], alo[4];
    split_tf32(x0.x, ahi[0], alo[0]);
    split_tf32(x1.x, ahi[1], alo[1]);
    split_tf32(x0.y, ahi[2], alo[2]);
    split_tf32(x1.y, ahi[3], alo[3]);
    const float* brow = bp + kk * ldb;
#pragma unroll
    for (int n = 0; n < ND; ++n) mma_3xtf32(part[n], ahi, alo, brow[8 * n], brow[ldb + 8 * n]);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// K3a fp32: dK, dV. Phase A: each warp computes a 16 x n tile of S^T and
// dP^T and stores P and dS in shared memory; phase B: each warp multiplies a
// 16-row slice of P^T / dS^T with a column slice of dO / Q. So the
// accumulators stay at 64 registers a thread or fewer: 64 keys per CTA of 4
// warps up to D = 64 (two CTAs per SM, which beat one of 8 warps and 128
// keys), 32 keys on 4 warps up to 128 and on 8 above (one CTA per SM there:
// 217 KB of shared memory at D = 256).
template <int DP>
struct DkdvShape {
  static constexpr int WARPS = DP > 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BKV = DP <= 64 ? 64 : 32;  // keys per CTA
  static constexpr int KW = BKV / 16;             // 16-key warp rows
  static constexpr int QW = WARPS / KW;  // phase A: query split; phase B: column split
};

template <int DP>
constexpr int dkdv_smem_bytes() {
  constexpr int BKV = DkdvShape<DP>::BKV, LD = DP + PAD, LDP = BQ + PAD;
  return (2 * BKV * LD + 2 * BQ * LD + 2 * BKV * LDP + 2 * BQ) * 4;
}

template <int DP>
__global__ void __launch_bounds__(DkdvShape<DP>::THREADS) bwd_dkdv_fp32_kernel(const Params p) {
  constexpr int BKV = DkdvShape<DP>::BKV, KW = DkdvShape<DP>::KW, QW = DkdvShape<DP>::QW;
  constexpr int THREADS = DkdvShape<DP>::THREADS;
  constexpr int LD = DP + PAD, LDP = BQ + PAD;
  constexpr int NT = BQ / QW / 8;  // 8-query slices of a warp's phase-A tile
  constexpr int DPW = DP / QW;     // head-dim columns of a warp's phase-B tile
  constexpr int ND = DPW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BKV][LD]
  float* Vs = Ks + BKV * LD;                       // [BKV][LD]
  float* Qs = Vs + BKV * LD;                       // [BQ][LD]
  float* dOs = Qs + BQ * LD;                       // [BQ][LD]
  float* Pt = dOs + BQ * LD;                       // [BKV][LDP] P^T
  float* dSt = Pt + BKV * LDP;                     // [BKV][LDP] dS^T
  float* lse_s = dSt + BKV * LDP;                  // [BQ]
  float* delta_s = lse_s + BQ;                     // [BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BKV;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* og = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.Sq;

  const float scale_log2 = p.scale * LOG2E;
  const int kr = 16 * (warp % KW);          // this warp's 16 keys (both phases)
  const int qc = (BQ / QW) * (warp / KW);   // phase A: its query columns
  const int dc = DPW * (warp / KW);         // phase B: its head-dim columns
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);

  // a CTA whose keys are all masked has zero gradients
  if (__syncthreads_or(threadIdx.x < BKV && key_valid(mg, k0 + threadIdx.x, p.Skv))) {
    load_rows<DP, THREADS>(Ks, LD, kg, p.k_ss, k0, BKV, p.Skv, p.D);
    load_rows<DP, THREADS>(Vs, LD, vg, p.v_ss, k0, BKV, p.Skv, p.D);
    const bool kv_lo = key_valid(mg, k0 + kr + g, p.Skv);
    const bool kv_hi = key_valid(mg, k0 + kr + g + 8, p.Skv);
    for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
      const int r = q0 + threadIdx.x;
      // also the barrier after which the previous step's reads are done; a
      // tile of fully masked rows contributes nothing
      if (!__syncthreads_or(threadIdx.x < BQ && r < p.Sq && lse_g[r] > NEG_INF * 0.5f)) continue;
      load_rows<DP, THREADS>(Qs, LD, qg, p.q_ss, q0, BQ, p.Sq, p.D);
      load_rows<DP, THREADS>(dOs, LD, og, p.o_ss, q0, BQ, p.Sq, p.D);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = r < p.Sq ? lse_g[r] : NEG_INF;
        delta_s[threadIdx.x] = r < p.Sq ? delta_g[r] : 0.f;
      }
      cp_async_wait();
      __syncthreads();

      // phase A: S^T and dP^T for 16 keys x BQ/QW queries
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      mma_abT<NT, DP / 8>(s, Ks + kr * LD, LD, Qs + qc * LD, LD);
      mma_abT<NT, DP / 8>(dp, Vs + kr * LD, LD, dOs + qc * LD, LD);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = kr + g + 8 * (e >> 1), col = qc + 8 * n + 2 * t + (e & 1);
          const float lse = lse_s[col];
          const bool live = ((e >> 1) ? kv_hi : kv_lo) && lse > NEG_INF * 0.5f;
          const float pr = live ? exp_shifted(s[n][e], scale_log2, lse) : 0.f;
          Pt[row * LDP + col] = pr;
          dSt[row * LDP + col] = pr * (dp[n][e] - delta_s[col]);
        }
      __syncthreads();

      // phase B: dV += P^T dO, dK += dS^T Q on this warp's columns
      mma_ab<ND, BQ / 8>(dv, Pt + kr * LDP, LDP, dOs + dc, LD);
      mma_ab<ND, BQ / 8>(dk, dSt + kr * LDP, LDP, Qs + dc, LD);
    }
    cp_async_wait();  // K and V, where every query tile was skipped
  }

  float* dkg = p.dk + static_cast<long long>(bh) * p.Skv * p.D;
  float* dvg = p.dv + static_cast<long long>(bh) * p.Skv * p.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + kr + g + 8 * i;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = dc + 8 * n + 2 * t;
      if (col < p.D) {
        const long long o = static_cast<long long>(row) * p.D + col;
        *reinterpret_cast<float2*>(dkg + o) =
            make_float2(dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
        *reinterpret_cast<float2*>(dvg + o) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

// K3b fp32: dQ, 64 query rows per CTA; 64 keys per step on 4 warps up to
// D = 128, 32 keys per step on 8 warps above (shared memory: 209 KB at D =
// 256).
template <int DP>
struct DqShape {
  static constexpr int WARPS = DP > 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ2 = 64;                   // query rows per CTA
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys per step
  static constexpr int RW = BQ2 / 16;              // 16-row warp rows
  static constexpr int CW = WARPS / RW;  // phase A: key split; phase B: column split
};

template <int DP>
constexpr int dq_smem_bytes() {
  constexpr int BQ2 = DqShape<DP>::BQ2, BK = DqShape<DP>::BK, LD = DP + PAD, LDP = BK + PAD;
  return (2 * BQ2 * LD + 2 * BK * LD + BQ2 * LDP + BK) * 4;
}

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::THREADS) bwd_dq_fp32_kernel(const Params p) {
  constexpr int BQ2 = DqShape<DP>::BQ2, RW = DqShape<DP>::RW, CW = DqShape<DP>::CW;
  constexpr int THREADS = DqShape<DP>::THREADS, BK = DqShape<DP>::BK;
  constexpr int LD = DP + PAD, LDP = BK + PAD;
  constexpr int NT = BK / CW / 8;  // 8-key slices of a warp's phase-A tile
  constexpr int DPW = DP / CW;     // head-dim columns of a warp's phase-B tile
  constexpr int ND = DPW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ2][LD]
  float* dOs = Qs + BQ2 * LD;                      // [BQ2][LD]
  float* Ks = dOs + BQ2 * LD;                      // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* dSs = Vs + BK * LD;                       // [BQ2][LDP] dS
  int* valid_s = reinterpret_cast<int*>(dSs + BQ2 * LDP);  // [BK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ2;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* og = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.Sq;

  const float scale_log2 = p.scale * LOG2E;
  const int qr = 16 * (warp % RW);         // this warp's 16 query rows (both phases)
  const int kc = (BK / CW) * (warp / RW);  // phase A: its key columns
  const int dc = DPW * (warp / RW);        // phase B: its head-dim columns
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr + g + 8 * i;
    lse_r[i] = row < p.Sq ? lse_g[row] : NEG_INF;
    delta_r[i] = row < p.Sq ? delta_g[row] : 0.f;
  }
  float dq[ND][4];
  zero(dq);

  // a CTA of fully masked rows has zero gradients
  const int r = q0 + threadIdx.x;
  if (__syncthreads_or(threadIdx.x < BQ2 && r < p.Sq && lse_g[r] > NEG_INF * 0.5f)) {
    load_rows<DP, THREADS>(Qs, LD, qg, p.q_ss, q0, BQ2, p.Sq, p.D);
    load_rows<DP, THREADS>(dOs, LD, og, p.o_ss, q0, BQ2, p.Sq, p.D);
    for (int k0 = 0; k0 < p.Skv; k0 += BK) {
      const bool valid = threadIdx.x < BK && key_valid(mg, k0 + threadIdx.x, p.Skv);
      // also the barrier after which the previous step's reads are done; a
      // tile of masked keys contributes nothing
      if (!__syncthreads_or(valid)) continue;
      if (threadIdx.x < BK) valid_s[threadIdx.x] = valid;
      load_rows<DP, THREADS>(Ks, LD, kg, p.k_ss, k0, BK, p.Skv, p.D);
      load_rows<DP, THREADS>(Vs, LD, vg, p.v_ss, k0, BK, p.Skv, p.D);
      cp_async_wait();
      __syncthreads();

      // phase A: S and dP for 16 rows x BK/CW keys
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      mma_abT<NT, DP / 8>(s, Qs + qr * LD, LD, Ks + kc * LD, LD);
      mma_abT<NT, DP / 8>(dp, dOs + qr * LD, LD, Vs + kc * LD, LD);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, row = qr + g + 8 * i, col = kc + 8 * n + 2 * t + (e & 1);
          const bool live = valid_s[col] && lse_r[i] > NEG_INF * 0.5f;
          const float pr = live ? exp_shifted(s[n][e], scale_log2, lse_r[i]) : 0.f;
          dSs[row * LDP + col] = pr * (dp[n][e] - delta_r[i]);
        }
      __syncthreads();

      // phase B: dQ += dS K on this warp's columns
      mma_ab<ND, BK / 8>(dq, dSs + qr * LDP, LDP, Ks + dc, LD);
    }
    cp_async_wait();  // Q and dO, where every kv tile was skipped
  }

  float* dqg = p.dq + static_cast<long long>(bh) * p.Sq * p.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr + g + 8 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = dc + 8 * n + 2 * t;
      if (col < p.D)
        *reinterpret_cast<float2*>(dqg + static_cast<long long>(row) * p.D + col) =
            make_float2(dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
    }
  }
}

// ===========================================================================
// bf16: warp-specialised wgmma with TMA
// ===========================================================================

constexpr int WG_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int ROW_BYTES = 128;   // one swizzled box row: 64 bf16 head-dim columns
constexpr int SMEM_LIMIT = 232448;
constexpr int SMEM_EXTRA = 1024 + 256;  // alignment slack, BARS_BYTES
constexpr int MAX_STAGES = 4;
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2;  // K3a's named barriers

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// The fragment of an m64nN accumulator, rounded to bf16, as the A fragments
// of N/16 k16 steps: n8 chunk i (rows g and g + 8, columns 8i + 2t, +1) is
// half i % 2 of k16 step i / 2.
template <int KSTEPS>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[KSTEPS][4], const float (&x)[8 * KSTEPS]) {
#pragma unroll
  for (int i = 0; i < 2 * KSTEPS; ++i) {
    a[i / 2][2 * (i % 2)] = pack_bf16(x[4 * i], x[4 * i + 1]);
    a[i / 2][2 * (i % 2) + 1] = pack_bf16(x[4 * i + 2], x[4 * i + 3]);
  }
}

// acc[c] += A . B[:, 64c : 64c + 64] over KSTEPS k16 steps, A from registers
// and B an MN-major tile of rows x DP stored as DP/64 boxes of `box_bytes`
template <int NB, int KSTEPS>
__device__ __forceinline__ void product_rs(float (&acc)[NB][32], const uint32_t (&a)[KSTEPS][4],
                                           uint32_t b, int box_bytes) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j)
      wgmma_rs_n64_tb(acc[c], a[j], smem_desc_mn(b + c * box_bytes + j * 16 * ROW_BYTES));
  wgmma_commit();
}

// d = A . B^T over the head dim, A (64 rows) and B (N rows) K-major tiles
// stored as NB boxes of a_box / b_box bytes
template <int NB, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, int a_box, uint32_t b,
                                           int b_box) {
#pragma unroll
  for (int j = 0; j < 4 * NB; ++j) {
    const uint64_t da = smem_desc(a + (j / 4) * a_box) + 2 * (j % 4);
    const uint64_t db = smem_desc(b + (j / 4) * b_box) + 2 * (j % 4);
    if constexpr (N == 64)
      wgmma_ss_n64(d, da, db, j > 0);
    else
      wgmma_ss_n32(d, da, db, j > 0);
  }
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
}

// rows [row0, row0 + 8) and [row0 + 8, ...) of a warp's accumulator fragment
// into out [*, D] fp32, times `mult`
template <int NB>
__device__ __forceinline__ void store_acc(float* out, const float (&acc)[NB][32], int row0,
                                          int rows, int D, int t, float mult) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * c + 8 * i + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * D + col) =
              make_float2(acc[c][4 * i + 2 * r] * mult, acc[c][4 * i + 2 * r + 1] * mult);
      }
  }
}

__device__ void store_zeros(float* out, int row0, int nrows, int rows, int D) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += blockDim.x) {
    const int r = idx / D;
    if (row0 + r < rows) out[static_cast<long long>(row0 + r) * D + idx % D] = 0.f;
  }
}

// the producer's and consumers' view of the stage ring
struct Ring {
  uint32_t full, empty;  // mbarrier arrays, 8 bytes apart
  volatile int* tile;    // the stage's first row, or -1 at the end
};
constexpr int BARS_BYTES = 256;  // barriers and stage words; the stage rows follow

// K3a's two layouts: up to D = 64 each consumer warpgroup owns 64 keys
// outright (S^T, dP^T, dV, dK: 64 accumulator registers), so a CTA takes
// 128 keys; above, both work on the same 64 keys and split the products
template <int DP>
struct DkdvWg {
  static constexpr int NB = DP / 64;
  static constexpr bool OWN = DP <= 64;
  static constexpr int BKV = OWN ? 128 : 64, BQ = 64;
  static constexpr int KV_BYTES = BKV * ROW_BYTES * NB;  // K or V
  static constexpr int HALF = BQ * ROW_BYTES * NB;        // Q or dO of a stage
  static constexpr int STAGE = 2 * HALF;
  static constexpr int XCH = OWN ? 0 : 32 * 128 * 4;      // P, fp32, one word per thread
  static constexpr int ROWS = 2 * BQ;                     // a stage's lse and delta
  static constexpr int FIXED = 2 * KV_BYTES + XCH + SMEM_EXTRA + MAX_STAGES * ROWS * 4;
  static constexpr int STAGES =
      (SMEM_LIMIT - FIXED) / STAGE < MAX_STAGES ? (SMEM_LIMIT - FIXED) / STAGE : MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "K3a needs two stages");
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using S = DkdvWg<DP>;
  constexpr int NB = S::NB, BKV = S::BKV, BQ = S::BQ, ST = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + S::KV_BYTES;
  uint8_t* ring = Vs + S::KV_BYTES;
  float* xch = reinterpret_cast<float*>(ring + ST * S::STAGE);
  uint8_t* bars = reinterpret_cast<uint8_t*>(xch) + S::XCH;
  const uint32_t kv_bar = smem_u32(bars);
  const Ring rg{kv_bar + 8, kv_bar + 8 + 8 * ST,
                reinterpret_cast<volatile int*>(bars + 8 + 16 * ST)};
  float* rows_s = reinterpret_cast<float*>(bars + BARS_BYTES);  // [ST][lse 64 | delta 64]

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BKV;
  const int split = blockIdx.z;
  const long long out_off = split * p.part_stride + static_cast<long long>(bh) * p.Skv * p.D;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.Sq;

  // a CTA whose keys are all masked has zero gradients
  if (!__syncthreads_or(threadIdx.x < BKV && key_valid(mg, k0 + threadIdx.x, p.Skv))) {
    store_zeros(p.dk + out_off, k0, BKV, p.Skv, p.D);
    store_zeros(p.dv + out_off, k0, BKV, p.Skv, p.D);
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(rg.full + 8 * s, 1);
      mbar_init(rg.empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int q_tiles = (p.Sq + BQ - 1) / BQ;
  const int qt0 = split * q_tiles / p.n_split, qt1 = (split + 1) * q_tiles / p.n_split;

  if (threadIdx.x < 128) {
    // producer: warp 0 walks the query tiles, skipping those of fully
    // masked rows; its lane 0 issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * S::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem_u32(Ks + c * BKV * ROW_BYTES), &tm_k, kv_bar, 64 * c, k0, h, b);
        tma_load_4d(smem_u32(Vs + c * BKV * ROW_BYTES), &tm_v, kv_bar, 64 * c, k0, h, b);
      }
    }
    int i = 0;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ, r0 = q0 + lane, r1 = q0 + 32 + lane;
      const float l0 = r0 < p.Sq ? lse_g[r0] : NEG_INF, l1 = r1 < p.Sq ? lse_g[r1] : NEG_INF;
      if (!__any_sync(0xffffffffu, l0 > NEG_INF * 0.5f || l1 > NEG_INF * 0.5f)) continue;
      // the tile's lse and delta go beside its Q and dO, once the stage is free
      const int s = i % ST;
      if (lane == 0) mbar_wait(rg.empty + 8 * s, ((i / ST) & 1) ^ 1);
      __syncwarp();
      float* rows = rows_s + s * S::ROWS;
      rows[lane] = l0;
      rows[32 + lane] = l1;
      rows[64 + lane] = r0 < p.Sq ? delta_g[r0] : 0.f;
      rows[96 + lane] = r1 < p.Sq ? delta_g[r1] : 0.f;
      __syncwarp();
      if (lane == 0) {
        rg.tile[s] = q0;
        mbar_expect_tx(rg.full + 8 * s, S::STAGE);
        uint8_t* st = ring + s * S::STAGE;
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(smem_u32(st + c * BQ * ROW_BYTES), &tm_q, rg.full + 8 * s, 64 * c, q0, h, b);
          tma_load_4d(smem_u32(st + S::HALF + c * BQ * ROW_BYTES), &tm_o, rg.full + 8 * s, 64 * c,
                      q0, h, b);
        }
      }
      ++i;
    }
    if (lane == 0) {
      const int s = i % ST;
      mbar_wait(rg.empty + 8 * s, ((i / ST) & 1) ^ 1);
      rg.tile[s] = -1;
      mbar_arrive(rg.full + 8 * s);
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows0 = S::OWN ? 64 * wg : 0;  // this warpgroup's first key in the tile
  const int key_lo = k0 + rows0 + 16 * warp + g;
  const bool kv_lo = key_valid(mg, key_lo, p.Skv), kv_hi = key_valid(mg, key_lo + 8, p.Skv);
  const float scale_log2 = p.scale * LOG2E;
  const uint32_t kb = smem_u32(Ks) + rows0 * ROW_BYTES, vb = smem_u32(Vs) + rows0 * ROW_BYTES;
  constexpr int KBOX = BKV * ROW_BYTES, QBOX = BQ * ROW_BYTES;

  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float x[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e] = 0.f;
  uint32_t frag[4][4];
  mbar_wait(kv_bar, 0);

  if constexpr (S::OWN) {
    // acc is dV, acc2 dK; x is S^T, then P; y is dP^T, then dS
    float acc2[NB][32], y[32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc2[c][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) y[e] = 0.f;
    uint32_t frag2[4][4];
    for (int i = 0;; ++i) {
      const int s = i % ST;
      mbar_wait(rg.full + 8 * s, (i / ST) & 1);
      const int q0 = rg.tile[s];
      if (q0 < 0) break;
      const uint32_t st = smem_u32(ring + s * S::STAGE);
      wgmma_fence();
      product_ss<NB, 64>(x, kb, KBOX, st, QBOX);
      product_ss<NB, 64>(y, vb, KBOX, st + S::HALF, QBOX);
      wgmma_commit();
      // lse and delta of the 16 query columns of this thread's fragment
      const float* rows = rows_s + s * S::ROWS;
      float lse_c[16], delta_c[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lse_c[j] = rows[8 * (j / 2) + 2 * t + (j % 2)];
        delta_c[j] = rows[64 + 8 * (j / 2) + 2 * t + (j % 2)];
      }
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(y);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = 2 * (e / 4) + (e & 1);
        const bool live = ((e & 2) ? kv_hi : kv_lo) && lse_c[j] > NEG_INF * 0.5f;
        const float pr = live ? exp_shifted(x[e], scale_log2, lse_c[j]) : 0.f;
        x[e] = pr;
        y[e] = pr * (y[e] - delta_c[j]);
      }
      to_a_frag<4>(frag, x);
      to_a_frag<4>(frag2, y);
      product_rs<NB, 4>(acc, frag, st + S::HALF, QBOX);  // dV += P^T dO
      product_rs<NB, 4>(acc2, frag2, st, QBOX);          // dK += dS^T Q
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(acc2);
      fence_regs(frag);
      fence_regs(frag2);
      if (lane == 0) mbar_arrive(rg.empty + 8 * s);
    }
    store_acc(p.dv + out_off, acc, key_lo, p.Skv, p.D, t, 1.f);
    store_acc(p.dk + out_off, acc2, key_lo, p.Skv, p.D, t, p.scale);
    return;
  } else {
    // warpgroup 1 computes S^T and P and owns dV; warpgroup 2 computes dP^T
    // and dS and owns dK, reading P from warpgroup 1 through shared memory
    const bool owns_dv = wg == 0;
    const uint32_t a_tile = owns_dv ? kb : vb;
    const int b_first = owns_dv ? 0 : S::HALF, b_second = owns_dv ? S::HALF : 0;
    int i = 0;
    for (;; ++i) {
      const int s = i % ST;
      mbar_wait(rg.full + 8 * s, (i / ST) & 1);
      const int q0 = rg.tile[s];
      if (q0 < 0) break;
      const uint32_t st = smem_u32(ring + s * S::STAGE);
      wgmma_fence();
      product_ss<NB, 64>(x, a_tile, KBOX, st + b_first, QBOX);
      wgmma_commit();
      // lse (warpgroup 1) or delta (warpgroup 2) of the 16 query columns of
      // this thread's fragment: 8j + 2t, +1
      const float* rows = rows_s + s * S::ROWS + (owns_dv ? 0 : 64);
      float rowv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) rowv[j] = rows[8 * (j / 2) + 2 * t + (j % 2)];
      wgmma_wait<0>();
      fence_regs(x);
      if (owns_dv) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float lse = rowv[2 * (e / 4) + (e & 1)];
          const bool live = ((e & 2) ? kv_hi : kv_lo) && lse > NEG_INF * 0.5f;
          x[e] = live ? exp_shifted(x[e], scale_log2, lse) : 0.f;
        }
        if (i > 0) named_sync(BAR_P_EMPTY);
#pragma unroll
        for (int e = 0; e < 32; ++e) xch[e * 128 + tid] = x[e];
        named_arrive(BAR_P_FULL);
      } else {
        named_sync(BAR_P_FULL);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          x[e] = xch[e * 128 + tid] * (x[e] - rowv[2 * (e / 4) + (e & 1)]);
        named_arrive(BAR_P_EMPTY);
      }
      to_a_frag<4>(frag, x);
      product_rs<NB, 4>(acc, frag, st + b_second, QBOX);
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(frag);
      if (lane == 0) mbar_arrive(rg.empty + 8 * s);
    }
    if (owns_dv && i > 0) named_sync(BAR_P_EMPTY);  // warpgroup 2's last arrival
    store_acc(owns_dv ? p.dv + out_off : p.dk + out_off, acc, key_lo, p.Skv, p.D, t,
              owns_dv ? 1.f : p.scale);
  }
}

template <int DP>
struct DqWg {
  static constexpr int NB = DP / 64;
  static constexpr int BQ = 128;                     // two consumer warpgroups of 64 rows
  static constexpr int BKS = DP <= 128 ? 64 : 32;    // keys per stage
  static constexpr int Q_BYTES = BQ * ROW_BYTES * NB;   // Q or dO
  static constexpr int HALF = BKS * ROW_BYTES * NB;     // K or V of a stage
  static constexpr int STAGE = 2 * HALF;
  static constexpr int FIXED = 2 * Q_BYTES + SMEM_EXTRA + MAX_STAGES * 64;  // + key flags
  static constexpr int STAGES =
      (SMEM_LIMIT - FIXED) / STAGE < MAX_STAGES ? (SMEM_LIMIT - FIXED) / STAGE : MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "K3b needs two stages");
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using S = DqWg<DP>;
  constexpr int NB = S::NB, BQ = S::BQ, BKS = S::BKS, ST = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + S::Q_BYTES;
  uint8_t* ring = dOs + S::Q_BYTES;
  uint8_t* bars = ring + ST * S::STAGE;
  const uint32_t q_bar = smem_u32(bars);
  const Ring rg{q_bar + 8, q_bar + 8 + 8 * ST, reinterpret_cast<volatile int*>(bars + 8 + 16 * ST)};
  uint8_t* flags_s = bars + BARS_BYTES;  // [ST][64]: the stage's valid keys

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.z;
  float* dq_out = p.dq + split * p.part_stride + static_cast<long long>(bh) * p.Sq * p.D;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.Sq;

  // a CTA of fully masked rows has zero gradients
  const int r = q0 + threadIdx.x;
  if (!__syncthreads_or(threadIdx.x < BQ && r < p.Sq && lse_g[r] > NEG_INF * 0.5f)) {
    store_zeros(dq_out, q0, BQ, p.Sq, p.D);
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(rg.full + 8 * s, 1);
      mbar_init(rg.empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int k_tiles = (p.Skv + BKS - 1) / BKS;
  const int kt0 = split * k_tiles / p.n_split, kt1 = (split + 1) * k_tiles / p.n_split;

  if (threadIdx.x < 128) {
    // producer: warp 0 walks the kv tiles, skipping those with no valid key
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * S::Q_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem_u32(Qs + c * BQ * ROW_BYTES), &tm_q, q_bar, 64 * c, q0, h, b);
        tma_load_4d(smem_u32(dOs + c * BQ * ROW_BYTES), &tm_o, q_bar, 64 * c, q0, h, b);
      }
    }
    int i = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * BKS;
      const bool v0 = key_valid(mg, k0 + lane, p.Skv);
      const bool v1 = BKS == 64 && key_valid(mg, k0 + 32 + lane, p.Skv);
      if (!__any_sync(0xffffffffu, v0 || v1)) continue;
      // the tile's valid keys go beside its K and V, once the stage is free
      const int s = i % ST;
      if (lane == 0) mbar_wait(rg.empty + 8 * s, ((i / ST) & 1) ^ 1);
      __syncwarp();
      flags_s[s * 64 + lane] = v0;
      if (BKS == 64) flags_s[s * 64 + 32 + lane] = v1;
      __syncwarp();
      if (lane == 0) {
        rg.tile[s] = k0;
        mbar_expect_tx(rg.full + 8 * s, S::STAGE);
        uint8_t* st = ring + s * S::STAGE;
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(smem_u32(st + c * BKS * ROW_BYTES), &tm_k, rg.full + 8 * s, 64 * c, k0, h, b);
          tma_load_4d(smem_u32(st + S::HALF + c * BKS * ROW_BYTES), &tm_v, rg.full + 8 * s, 64 * c,
                      k0, h, b);
        }
      }
      ++i;
    }
    if (lane == 0) {
      const int s = i % ST;
      mbar_wait(rg.empty + 8 * s, ((i / ST) & 1) ^ 1);
      rg.tile[s] = -1;
      mbar_arrive(rg.full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup w owns rows q0 + 64 (w - 1) .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 64 * wg + 16 * warp + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row_lo + 8 * rr;
    lse_r[rr] = row < p.Sq ? lse_g[row] : NEG_INF;
    delta_r[rr] = row < p.Sq ? delta_g[row] : 0.f;
  }
  const float scale_log2 = p.scale * LOG2E;
  const uint32_t qa = smem_u32(Qs + 64 * wg * ROW_BYTES), oa = smem_u32(dOs + 64 * wg * ROW_BYTES);

  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float sx[BKS / 2], dpx[BKS / 2];
#pragma unroll
  for (int e = 0; e < BKS / 2; ++e) sx[e] = dpx[e] = 0.f;

  uint32_t frag[BKS / 16][4];
  mbar_wait(q_bar, 0);
  for (int i = 0;; ++i) {
    const int s = i % ST;
    mbar_wait(rg.full + 8 * s, (i / ST) & 1);
    const int k0 = rg.tile[s];
    if (k0 < 0) break;
    const uint32_t st = smem_u32(ring + s * S::STAGE);
    wgmma_fence();
    product_ss<NB, BKS>(sx, qa, BQ * ROW_BYTES, st, BKS * ROW_BYTES);
    product_ss<NB, BKS>(dpx, oa, BQ * ROW_BYTES, st + S::HALF, BKS * ROW_BYTES);
    wgmma_commit();
    // the valid keys of this thread's columns: 8j + 2t, +1
    const uint8_t* flags = flags_s + s * 64;
    bool valid[BKS / 4];
#pragma unroll
    for (int j = 0; j < BKS / 4; ++j) valid[j] = flags[8 * (j / 2) + 2 * t + (j % 2)] != 0;
    wgmma_wait<0>();
    fence_regs(sx);
    fence_regs(dpx);
#pragma unroll
    for (int e = 0; e < BKS / 2; ++e) {
      const int rr = (e >> 1) & 1;
      const bool live = valid[2 * (e / 4) + (e & 1)] && lse_r[rr] > NEG_INF * 0.5f;
      const float pr = live ? exp_shifted(sx[e], scale_log2, lse_r[rr]) : 0.f;
      sx[e] = pr * (dpx[e] - delta_r[rr]);
    }
    to_a_frag<BKS / 16>(frag, sx);
    product_rs<NB, BKS / 16>(acc, frag, st, BKS * ROW_BYTES);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(frag);
    if (lane == 0) mbar_arrive(rg.empty + 8 * s);
  }
  store_acc(dq_out, acc, row_lo, p.Sq, p.D, t, p.scale);
}

// out[i] = sum over s of part[s][i], in order: the splits' partial sums
__global__ void __launch_bounds__(256) combine_kernel(const float4* __restrict__ part,
                                                      float4* __restrict__ out, long long n4,
                                                      int n_split) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    float4 sum = part[i];
    for (int s = 1; s < n_split; ++s) {
      const float4 x = part[s * n4 + i];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    out[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int padded_dim(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : (D <= 192 ? 192 : 256)); }

int sm_count() {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n_sm;
}

// The width the fp32 kernels are instantiated at for a head dim D.
int fp32_dim(int D) {
  constexpr int widths[] = {16, 32, 48, 56, 64, 96, 128, 192};
  for (const int d : widths)
    if (D <= d) return d;
  return 256;
}

// A kernel's tiling, read from the structs it is built on: rows of the CTA
// axis a CTA keeps (K3a keys, K3b query rows) and rows of the streamed axis
// it takes a step (K3a query rows, K3b keys).
struct Tiling {
  int cta_rows, step_rows;
};

template <int DP>
Tiling tiling_bf16(bool dq) {
  return dq ? Tiling{DqWg<DP>::BQ, DqWg<DP>::BKS} : Tiling{DkdvWg<DP>::BKV, DkdvWg<DP>::BQ};
}

template <int DP>
Tiling tiling_fp32(bool dq) {
  return dq ? Tiling{DqShape<DP>::BQ2, DqShape<DP>::BK} : Tiling{DkdvShape<DP>::BKV, BQ};
}

Tiling tiling(bool dq, int dtype, int D) {
  if (dtype == 1) {
    switch (padded_dim(D)) {
      case 64: return tiling_bf16<64>(dq);
      case 128: return tiling_bf16<128>(dq);
      case 192: return tiling_bf16<192>(dq);
      default: return tiling_bf16<256>(dq);
    }
  }
  switch (fp32_dim(D)) {
    case 16: return tiling_fp32<16>(dq);
    case 32: return tiling_fp32<32>(dq);
    case 48: return tiling_fp32<48>(dq);
    case 56: return tiling_fp32<56>(dq);
    case 64: return tiling_fp32<64>(dq);
    case 96: return tiling_fp32<96>(dq);
    case 128: return tiling_fp32<128>(dq);
    case 192: return tiling_fp32<192>(dq);
    default: return tiling_fp32<256>(dq);
  }
}

// CTAs of one split: tiles of the CTA axis times B*H.
int grid_ctas(bool dq, const Tiling& t, int BH, int Sq, int Skv) {
  return BH * (((dq ? Sq : Skv) + t.cta_rows - 1) / t.cta_rows);
}

// The bf16 kernels split their streamed axis (K3a: query tiles, K3b: kv
// tiles) over up to 8 CTAs while the grid alone would leave SMs idle; each
// split keeps at least two tiles. The fp32 kernels never split.
int n_splits(bool dq, int dtype, int BH, int Sq, int Skv, int D) {
  if (dtype != 1) return 1;
  const Tiling t = tiling(dq, dtype, D);
  const int ctas = grid_ctas(dq, t, BH, Sq, Skv);
  const int tiles = ((dq ? Skv : Sq) + t.step_rows - 1) / t.step_rows;
  const int n_sm = sm_count();
  int n = 1;
  while (n < 8 && ctas * (n + 1) <= n_sm && tiles >= 2 * (n + 1)) ++n;
  return n;
}

// a bf16 [B, H, S, D] tensor with strides (sb, sh, ss, 1) in elements, read
// in 128-byte swizzled boxes of 64 columns x box_rows rows; zeros past its
// edges. A stride of a dimension of size 1 is never used and is replaced by
// a valid one.
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D, long long sb,
              long long sh, long long ss, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  long long st[3] = {ss * 2, sh * 2, sb * 2};
  const long long n[3] = {S, H, B};
  long long prev = ((2ll * D + 15) / 16) * 16, prev_n = 1;
  for (int i = 0; i < 3; ++i) {
    if (n[i] == 1) st[i] = prev * prev_n;
    if (st[i] <= 0 || st[i] % 16 != 0 || st[i] >= (1ll << 40)) return false;
    prev = st[i];
    prev_n = n[i];
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0]), static_cast<cuuint64_t>(st[1]),
                                 static_cast<cuuint64_t>(st[2])};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

cudaError_t combine(const float* part, float* out, long long n, int n_split, cudaStream_t stream) {
  const long long n4 = n / 4;
  const int blocks = static_cast<int>((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  combine_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                             reinterpret_cast<float4*>(out), n4, n_split);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(bool dq, Params p, float* scratch, cudaStream_t stream) {
  const int rows_q = dq ? DqWg<DP>::BQ : DkdvWg<DP>::BQ;
  const int rows_kv = dq ? DqWg<DP>::BKS : DkdvWg<DP>::BKV;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, p.q, p.B, p.H, p.Sq, p.D, p.q_sb, p.q_sh, p.q_ss, rows_q) ||
      !make_map(&mk, p.k, p.B, p.H, p.Skv, p.D, p.k_sb, p.k_sh, p.k_ss, rows_kv) ||
      !make_map(&mv, p.v, p.B, p.H, p.Skv, p.D, p.v_sb, p.v_sh, p.v_ss, rows_kv) ||
      !make_map(&mo, p.dout, p.B, p.H, p.Sq, p.D, p.o_sb, p.o_sh, p.o_ss, rows_q))
    return cudaErrorInvalidValue;
  const int BH = p.B * p.H;
  const long long n = static_cast<long long>(BH) * (dq ? p.Sq : p.Skv) * p.D;
  float* out0 = dq ? p.dq : p.dk;
  float* out1 = p.dv;
  if (p.n_split > 1) {
    // partial sums: [n_split, BH, S, D] (K3a: dK's, then dV's)
    p.part_stride = n;
    if (dq) {
      p.dq = scratch;
    } else {
      p.dk = scratch;
      p.dv = scratch + p.n_split * n;
    }
  }
  cudaError_t err;
  if (dq) {
    const int smem = DqWg<DP>::SMEM;
    err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + DqWg<DP>::BQ - 1) / DqWg<DP>::BQ, BH, p.n_split);
    bwd_dq_wgmma_kernel<DP><<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, mo, p);
  } else {
    const int smem = DkdvWg<DP>::SMEM;
    err = cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Skv + DkdvWg<DP>::BKV - 1) / DkdvWg<DP>::BKV, BH, p.n_split);
    bwd_dkdv_wgmma_kernel<DP><<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, mo, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  if (dq) return combine(p.dq, out0, n, p.n_split, stream);
  err = combine(p.dk, out0, n, p.n_split, stream);
  if (err != cudaSuccess) return err;
  return combine(p.dv, out1, n, p.n_split, stream);
}

template <typename Kernel>
cudaError_t launch_fp32(Kernel kernel, int threads, int smem, dim3 grid, const Params& p,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fp32_dp(bool dq, const Params& p, cudaStream_t stream) {
  if (dq) {
    const dim3 grid((p.Sq + DqShape<DP>::BQ2 - 1) / DqShape<DP>::BQ2, p.B * p.H);
    return launch_fp32(bwd_dq_fp32_kernel<DP>, DqShape<DP>::THREADS, dq_smem_bytes<DP>(), grid,
                       p, stream);
  }
  const dim3 grid((p.Skv + DkdvShape<DP>::BKV - 1) / DkdvShape<DP>::BKV, p.B * p.H);
  return launch_fp32(bwd_dkdv_fp32_kernel<DP>, DkdvShape<DP>::THREADS, dkdv_smem_bytes<DP>(),
                     grid, p, stream);
}

cudaError_t dispatch_fp32(bool dq, const Params& p, cudaStream_t stream) {
  switch (fp32_dim(p.D)) {
    case 16: return launch_fp32_dp<16>(dq, p, stream);
    case 32: return launch_fp32_dp<32>(dq, p, stream);
    case 48: return launch_fp32_dp<48>(dq, p, stream);
    case 56: return launch_fp32_dp<56>(dq, p, stream);  // hiera-b+'s global blocks
    case 64: return launch_fp32_dp<64>(dq, p, stream);
    case 96: return launch_fp32_dp<96>(dq, p, stream);
    case 128: return launch_fp32_dp<128>(dq, p, stream);
    case 192: return launch_fp32_dp<192>(dq, p, stream);
    default: return launch_fp32_dp<256>(dq, p, stream);
  }
}

cudaError_t dispatch_bf16(bool dq, const Params& p, float* scratch, cudaStream_t stream) {
  switch (padded_dim(p.D)) {
    case 64: return launch_bf16<64>(dq, p, scratch, stream);
    case 128: return launch_bf16<128>(dq, p, scratch, stream);
    case 192: return launch_bf16<192>(dq, p, scratch, stream);
    default: return launch_bf16<256>(dq, p, scratch, stream);
  }
}

int run(bool dq_kernel, const void* q, const void* k, const void* v, const void* mask,
        const void* dout, const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int dtype, int B, int H, int Sq, int Skv, int D,
        long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
        long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
        long long o_sh, long long o_ss, long long mask_sb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      static_cast<long long>(B) * H > 65535 || (dtype != 0 && dtype != 1) || lse == nullptr ||
      delta == nullptr || (dq_kernel ? dq == nullptr : (dk == nullptr || dv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.n_split = n_splits(dq_kernel, dtype, B * H, Sq, Skv, D);
  p.part_stride = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_fp32(dq_kernel, p, st));
  // the split scratch comes in the pointer the other kernel writes
  float* scratch = static_cast<float*>(dq_kernel ? dk : dq);
  if (p.n_split > 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_bf16(dq_kernel, p, scratch, st));
}

}  // namespace

// Both entry points take q/k/v/dout [B, H, S, D] with any batch/head/sequence
// strides and a unit stride along D (bf16: 16-byte aligned, strides multiples
// of 8), mask [B, Skv] bool or null, lse and delta [B*H, Sq] fp32; they write
// fp32 gradients [B*H, S, D] (contiguous) and return the cudaError_t of the
// launch (0 = cudaSuccess). dtype: 0 fp32, 1 bf16; D a multiple of 8 up to
// 256. In bf16, where `sam2_flash_attention_bwd_splits` gives n_split > 1,
// the pointer the kernel does not write carries its fp32 scratch for the
// partial sums: K3a's dq [2, n_split, B*H, Skv, D], K3b's dk [n_split, B*H,
// Sq, D].

// K3a: dK and dV.
extern "C" int sam2_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int H, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  return run(false, q, k, v, mask, dout, lse, delta, dq, dk, dv, dtype, B, H, Sq, Skv, D, q_sb,
             q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, scale,
             stream);
}

// K3b: dQ.
extern "C" int sam2_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int H, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  return run(true, q, k, v, mask, dout, lse, delta, dq, dk, dv, dtype, B, H, Sq, Skv, D, q_sb,
             q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, scale,
             stream);
}

// The number of CTAs over which K3a (dq = 0) or K3b (dq = 1) splits its
// streamed axis on the current device, for the wrapper's scratch; 1 = none.
extern "C" int sam2_flash_attention_bwd_splits(int dq, int dtype, int B, int H, int Sq, int Skv,
                                               int D) {
  return n_splits(dq != 0, dtype, B * H, Sq, Skv, D);
}

// The launch geometry of K3a (dq = 0) or K3b (dq = 1) for a shape on the
// current device, as the launch uses it: out[0] rows of the CTA axis per CTA
// (K3a keys, K3b query rows), out[1] rows of the streamed axis per step,
// out[2] CTAs of the grid (every split counted), out[3] the split.
extern "C" void sam2_flash_attention_bwd_tiling(int dq, int dtype, int B, int H, int Sq, int Skv,
                                                int D, int* out) {
  const Tiling t = tiling(dq != 0, dtype, D);
  const int n_split = n_splits(dq != 0, dtype, B * H, Sq, Skv, D);
  out[0] = t.cta_rows;
  out[1] = t.step_rows;
  out[2] = grid_ctas(dq != 0, t, B * H, Sq, Skv) * n_split;
  out[3] = n_split;
}
