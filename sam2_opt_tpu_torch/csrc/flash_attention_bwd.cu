// Masked flash-attention backward (K3) for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the two Pallas TPU kernels of the JAX package's flash backward,
// sam2_opt_tpu/kernels/flash_attention.py::_bwd_dkdv_kernel (K3a) and
// ::_bwd_dq_kernel (K3b), and computes exactly what they compute, given the
// forward's row log-sum-exp `lse` and delta = rowsum(dO * O) (fp32, computed
// by the wrapper as the JAX package does it in XLA):
//   s  = (q . k^T) * scale
//   p  = exp(s - lse) where the key is valid and lse > -0.5e30, else 0
//   dV = sum_q round(p) dO             (p rounded to dO's dtype)
//   dP = dO . v^T
//   dS = round(p * (dP - delta))       (rounded to q's dtype)
//   dK = scale * sum_q dS q,  dQ = scale * sum_k dS k
// with every product accumulated in fp32. dQ, dK, dV are written in fp32
// ([B*H, S, D], contiguous); the wrapper casts them to the input dtypes.
//
// Scheme (the JAX one, without atomics, so gradients are deterministic):
//  - K3a, bwd_dkdv_kernel: one CTA per tile of keys of one (b, h); it keeps
//    its dK and dV accumulators in registers and streams the query tiles.
//  - K3b, bwd_dq_kernel: one CTA per tile of query rows; it keeps dQ in
//    registers and streams the kv tiles.
// Each step runs two phases on 4 warps. Phase A: each warp computes a
// 16 x n tile of both logit products (S and dP), turns it into P and dS, and
// stores both, rounded to the input dtype, in shared memory. Phase B: each
// warp multiplies a 16-row slice of P^T / dS^T (K3a) or dS (K3b) with a
// column slice of dO, Q or K. So the head dim is split over warps in phase B
// and the accumulators stay at 64 fp32 registers per thread for every D:
// K3a takes 64 keys per CTA up to D = 64, 32 up to 128 and 16 up to 256
// (2 x 16 x 256 fp32 of dK and dV at D = 256 is 32 KB, 64 registers on each
// of 128 threads); K3b takes 64 query rows up to D = 128 and 32 above.
// The head dim is zero-padded to DP (16, 32, 48, 64, 96, 128, 192, 256) in
// shared memory only; exactly D columns are read and written.
//
// Precision. bf16 runs on the tensor cores (mma.sync m16n8k16, fp32
// accumulation; operands through ldmatrix, transposed where the product
// needs it). fp32 runs true fp32 FMAs on the CUDA cores, in the same
// fragment layout (each lane computes the four accumulator elements an mma
// would give it), so both dtypes share one kernel body.
//
// Skipped work, exact: a K3a CTA whose keys are all masked writes zeros; a
// query tile whose rows all have lse = -1e30 (fully masked rows) is skipped
// by K3a, and a K3b CTA with no live row writes zeros; K3b skips kv tiles
// with no valid key (the empty memory slots of early training frames).
//
// Bound. 10 * Sq * Skv * D operations per (b, h) (five products of 2 flops
// per multiply-add) against 10-20 bytes per token row: compute-bound. At the
// training shapes: hiera-b+ global blocks (B*H = 64, 4096 x 4096, D = 56)
// 601 GFLOP, 0.61 ms bf16 / 9.0 ms fp32; memory-attention cross
// (2, 4096, 28,704, 256) 602 GFLOP, same. This first version loads tiles
// synchronously (no copy/compute overlap), recomputes S and dP in both
// kernels (as the JAX scheme does), and reads its fp32 operands from shared
// memory with scalar loads: it is correct first, far from its bound;
// cp.async rings, wgmma and TMA are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 64;  // query rows per step of K3a
constexpr int BK = 64;  // keys per step of K3b

typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* mask;  // [B, Skv] bool, row stride mask_sb; null = all valid
  const float* lse;     // [B*H, Sq]
  const float* delta;   // [B*H, Sq]
  float* dq;            // [B*H, Sq, D]
  float* dk;            // [B*H, Skv, D]
  float* dv;            // [B*H, Skv, D]
  int B, H, Sq, Skv, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // dout
  long long mask_sb;
  float scale;
};

__device__ __forceinline__ bool key_valid(const uint8_t* mg, int key, int Skv) {
  return key < Skv && (mg == nullptr || mg[key] != 0);
}

// Row padding of the shared tiles (elements): bf16 rows stay 16-byte aligned
// for ldmatrix and fall on distinct banks; fp32 rows stay 8-byte aligned.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<bf16> { static constexpr int value = 8; };

__device__ __forceinline__ void store_round(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_round(bf16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// rows [r0, r0 + rows) of a [*, D] matrix with row stride rs into a [rows][ld]
// tile, zero past `limit` rows and past D columns
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long rs,
                                          int r0, int rows, int limit, int D) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[r * ld + c] = (r0 + r < limit && c < D) ? src[static_cast<long long>(r0 + r) * rs + c] : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, long long rs,
                                          int r0, int rows, int limit, int D) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit && c < D)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------------------
// Warp products in the m16n8k16 accumulator layout: lane (g = lane / 4,
// t = lane % 4) holds c[n][0..3] = C[g][8n + 2t], C[g][8n + 2t + 1],
// C[g + 8][8n + 2t], C[g + 8][8n + 2t + 1].
//   mma_abT: C[16][8 NT] += A[16][16 KS] . B^T, B stored [8 NT rows][k]
//   mma_ab:  C[16][8 ND] += A[16][16 KS] . B,   B stored [k rows][8 ND]
// A is row-major [16][k] in both.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int NT, int KS>
__device__ __forceinline__ void mma_abT(float (&c)[NT][4], const bf16* A, int lda, const bf16* B,
                                        int ldb) {
  const int lane = threadIdx.x & 31;
  const bf16* afrag = A + (lane & 15) * lda + 8 * (lane >> 4);
  const bf16* bfrag = B + ((lane & 7) + 8 * (lane >> 4)) * ldb + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, afrag + 16 * ks);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, bfrag + 8 * n * ldb + 16 * ks);
      mma_bf16(c[n], a, b[0], b[1]);
      mma_bf16(c[n + 1], a, b[2], b[3]);
    }
  }
}

template <int ND, int KS>
__device__ __forceinline__ void mma_ab(float (&c)[ND][4], const bf16* A, int lda, const bf16* B,
                                       int ldb) {
  const int lane = threadIdx.x & 31;
  const bf16* afrag = A + (lane & 15) * lda + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, afrag + 16 * ks);
    const bf16* brow = B + (16 * ks + (lane & 15)) * ldb + 8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, brow + 8 * n);
      mma_bf16(c[n], a, b[0], b[1]);
      mma_bf16(c[n + 1], a, b[2], b[3]);
    }
  }
}

template <int NT, int KS>
__device__ __forceinline__ void mma_abT(float (&c)[NT][4], const float* A, int lda, const float* B,
                                        int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a0p = A + g * lda;
  const float* a1p = A + (g + 8) * lda;
#pragma unroll 4
  for (int kk = 0; kk < 16 * KS; ++kk) {
    const float a0 = a0p[kk], a1 = a1p[kk];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = B[(8 * n + 2 * t) * ldb + kk], b1 = B[(8 * n + 2 * t + 1) * ldb + kk];
      c[n][0] = fmaf(a0, b0, c[n][0]);
      c[n][1] = fmaf(a0, b1, c[n][1]);
      c[n][2] = fmaf(a1, b0, c[n][2]);
      c[n][3] = fmaf(a1, b1, c[n][3]);
    }
  }
}

template <int ND, int KS>
__device__ __forceinline__ void mma_ab(float (&c)[ND][4], const float* A, int lda, const float* B,
                                       int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a0p = A + g * lda;
  const float* a1p = A + (g + 8) * lda;
#pragma unroll 4
  for (int kk = 0; kk < 16 * KS; ++kk) {
    const float a0 = a0p[kk], a1 = a1p[kk];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(B + kk * ldb + 8 * n + 2 * t);
      c[n][0] = fmaf(a0, b.x, c[n][0]);
      c[n][1] = fmaf(a0, b.y, c[n][1]);
      c[n][2] = fmaf(a1, b.x, c[n][2]);
      c[n][3] = fmaf(a1, b.y, c[n][3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// ---------------------------------------------------------------------------
// K3a: dK, dV
// ---------------------------------------------------------------------------

template <int DP>
struct DkdvShape {
  static constexpr int BKV = DP <= 64 ? 64 : (DP <= 128 ? 32 : 16);  // keys per CTA
  static constexpr int KW = BKV / 16;                                  // 16-key warp rows
  static constexpr int QW = WARPS / KW;  // phase A: query split; phase B: column split
};

template <typename T, int DP>
constexpr int dkdv_smem_bytes() {
  constexpr int BKV = DkdvShape<DP>::BKV, LD = DP + Pad<T>::value, LDP = BQ + Pad<T>::value;
  return (2 * BKV * LD + 2 * BQ * LD + 2 * BKV * LDP) * static_cast<int>(sizeof(T)) +
         2 * BQ * static_cast<int>(sizeof(float));
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(const Params p) {
  constexpr int BKV = DkdvShape<DP>::BKV, KW = DkdvShape<DP>::KW, QW = DkdvShape<DP>::QW;
  constexpr int LD = DP + Pad<T>::value, LDP = BQ + Pad<T>::value;
  constexpr int NT = BQ / QW / 8;  // 8-query slices of a warp's phase-A tile
  constexpr int DPW = DP / QW;     // head-dim columns of a warp's phase-B tile
  constexpr int ND = DPW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BKV][LD]
  T* Vs = Ks + BKV * LD;                   // [BKV][LD]
  T* Qs = Vs + BKV * LD;                   // [BQ][LD]
  T* dOs = Qs + BQ * LD;                   // [BQ][LD]
  T* Pt = dOs + BQ * LD;                   // [BKV][LDP] P^T, rounded
  T* dSt = Pt + BKV * LDP;                 // [BKV][LDP] dS^T, rounded
  float* lse_s = reinterpret_cast<float*>(dSt + BKV * LDP);  // [BQ]
  float* delta_s = lse_s + BQ;                                // [BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BKV;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.Sq;

  const int kr = 16 * (warp % KW);          // this warp's 16 keys (both phases)
  const int qc = (BQ / QW) * (warp / KW);   // phase A: its query columns
  const int dc = DPW * (warp / KW);         // phase B: its head-dim columns
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);

  // a CTA whose keys are all masked has zero gradients
  if (__syncthreads_or(threadIdx.x < BKV && key_valid(mg, k0 + threadIdx.x, p.Skv))) {
    load_rows<DP>(Ks, LD, kg, p.k_ss, k0, BKV, p.Skv, p.D);
    load_rows<DP>(Vs, LD, vg, p.v_ss, k0, BKV, p.Skv, p.D);
    const bool kv_lo = key_valid(mg, k0 + kr + g, p.Skv);
    const bool kv_hi = key_valid(mg, k0 + kr + g + 8, p.Skv);
    for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
      const int r = q0 + threadIdx.x;
      // also the barrier after which the previous step's reads are done; a
      // tile of fully masked rows contributes nothing
      if (!__syncthreads_or(threadIdx.x < BQ && r < p.Sq && lse_g[r] > NEG_INF * 0.5f)) continue;
      load_rows<DP>(Qs, LD, qg, p.q_ss, q0, BQ, p.Sq, p.D);
      load_rows<DP>(dOs, LD, og, p.o_ss, q0, BQ, p.Sq, p.D);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = r < p.Sq ? lse_g[r] : NEG_INF;
        delta_s[threadIdx.x] = r < p.Sq ? delta_g[r] : 0.f;
      }
      __syncthreads();

      // phase A: S^T and dP^T for 16 keys x BQ/QW queries
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      mma_abT<NT, DP / 16>(s, Ks + kr * LD, LD, Qs + qc * LD, LD);
      mma_abT<NT, DP / 16>(dp, Vs + kr * LD, LD, dOs + qc * LD, LD);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = kr + g + 8 * (e >> 1), col = qc + 8 * n + 2 * t + (e & 1);
          const float lse = lse_s[col];
          const bool live = ((e >> 1) ? kv_hi : kv_lo) && lse > NEG_INF * 0.5f;
          const float pr = live ? expf(s[n][e] * p.scale - lse) : 0.f;
          store_round(Pt + row * LDP + col, pr);
          store_round(dSt + row * LDP + col, pr * (dp[n][e] - delta_s[col]));
        }
      __syncthreads();

      // phase B: dV += P^T dO, dK += dS^T Q on this warp's columns
      mma_ab<ND, BQ / 16>(dv, Pt + kr * LDP, LDP, dOs + dc, LD);
      mma_ab<ND, BQ / 16>(dk, dSt + kr * LDP, LDP, Qs + dc, LD);
    }
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

// ---------------------------------------------------------------------------
// K3b: dQ
// ---------------------------------------------------------------------------

template <int DP>
struct DqShape {
  static constexpr int BQ2 = DP <= 128 ? 64 : 32;  // query rows per CTA
  static constexpr int RW = BQ2 / 16;              // 16-row warp rows
  static constexpr int CW = WARPS / RW;  // phase A: key split; phase B: column split
};

template <typename T, int DP>
constexpr int dq_smem_bytes() {
  constexpr int BQ2 = DqShape<DP>::BQ2, LD = DP + Pad<T>::value, LDP = BK + Pad<T>::value;
  return (2 * BQ2 * LD + 2 * BK * LD + BQ2 * LDP) * static_cast<int>(sizeof(T)) +
         BK * static_cast<int>(sizeof(int));
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(const Params p) {
  constexpr int BQ2 = DqShape<DP>::BQ2, RW = DqShape<DP>::RW, CW = DqShape<DP>::CW;
  constexpr int LD = DP + Pad<T>::value, LDP = BK + Pad<T>::value;
  constexpr int NT = BK / CW / 8;  // 8-key slices of a warp's phase-A tile
  constexpr int DPW = DP / CW;     // head-dim columns of a warp's phase-B tile
  constexpr int ND = DPW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ2][LD]
  T* dOs = Qs + BQ2 * LD;                  // [BQ2][LD]
  T* Ks = dOs + BQ2 * LD;                  // [BK][LD]
  T* Vs = Ks + BK * LD;                    // [BK][LD]
  T* dSs = Vs + BK * LD;                   // [BQ2][LDP] dS, rounded
  int* valid_s = reinterpret_cast<int*>(dSs + BQ2 * LDP);  // [BK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ2;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.Sq;

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
    load_rows<DP>(Qs, LD, qg, p.q_ss, q0, BQ2, p.Sq, p.D);
    load_rows<DP>(dOs, LD, og, p.o_ss, q0, BQ2, p.Sq, p.D);
    for (int k0 = 0; k0 < p.Skv; k0 += BK) {
      const bool valid = threadIdx.x < BK && key_valid(mg, k0 + threadIdx.x, p.Skv);
      // also the barrier after which the previous step's reads are done; a
      // tile of masked keys contributes nothing
      if (!__syncthreads_or(valid)) continue;
      if (threadIdx.x < BK) valid_s[threadIdx.x] = valid;
      load_rows<DP>(Ks, LD, kg, p.k_ss, k0, BK, p.Skv, p.D);
      load_rows<DP>(Vs, LD, vg, p.v_ss, k0, BK, p.Skv, p.D);
      __syncthreads();

      // phase A: S and dP for 16 rows x BK/CW keys
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      mma_abT<NT, DP / 16>(s, Qs + qr * LD, LD, Ks + kc * LD, LD);
      mma_abT<NT, DP / 16>(dp, dOs + qr * LD, LD, Vs + kc * LD, LD);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, row = qr + g + 8 * i, col = kc + 8 * n + 2 * t + (e & 1);
          const bool live = valid_s[col] && lse_r[i] > NEG_INF * 0.5f;
          const float pr = live ? expf(s[n][e] * p.scale - lse_r[i]) : 0.f;
          store_round(dSs + row * LDP + col, pr * (dp[n][e] - delta_r[i]));
        }
      __syncthreads();

      // phase B: dQ += dS K on this warp's columns
      mma_ab<ND, BK / 16>(dq, dSs + qr * LDP, LDP, Ks + dc, LD);
    }
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(bool dq, const Params& p, cudaStream_t stream) {
  if (dq) {
    const dim3 grid((p.Sq + DqShape<DP>::BQ2 - 1) / DqShape<DP>::BQ2, p.B * p.H);
    return launch(bwd_dq_kernel<T, DP>, dq_smem_bytes<T, DP>(), grid, p, stream);
  }
  const dim3 grid((p.Skv + DkdvShape<DP>::BKV - 1) / DkdvShape<DP>::BKV, p.B * p.H);
  return launch(bwd_dkdv_kernel<T, DP>, dkdv_smem_bytes<T, DP>(), grid, p, stream);
}

template <typename T>
cudaError_t dispatch(bool dq, const Params& p, cudaStream_t stream) {
  const int D = p.D;
  if (D <= 16) return launch_dp<T, 16>(dq, p, stream);
  if (D <= 32) return launch_dp<T, 32>(dq, p, stream);
  if (D <= 48) return launch_dp<T, 48>(dq, p, stream);
  if (D <= 64) return launch_dp<T, 64>(dq, p, stream);
  if (D <= 96) return launch_dp<T, 96>(dq, p, stream);
  if (D <= 128) return launch_dp<T, 128>(dq, p, stream);
  if (D <= 192) return launch_dp<T, 192>(dq, p, stream);
  if (D <= 256) return launch_dp<T, 256>(dq, p, stream);
  return cudaErrorInvalidValue;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? dispatch<bf16>(dq_kernel, p, st)
                                     : dispatch<float>(dq_kernel, p, st));
}

}  // namespace

// Both entry points take q/k/v/dout [B, H, S, D] with any batch/head/sequence
// strides and a unit stride along D (bf16: rows 16-byte aligned), mask [B,
// Skv] bool or null, lse and delta [B*H, Sq] fp32; they write fp32 gradients
// [B*H, S, D] (contiguous) and return the cudaError_t of the launch
// (0 = cudaSuccess). dtype: 0 fp32, 1 bf16; D a multiple of 8 up to 256.

// K3a: dK and dV (dq is unused).
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

// K3b: dQ (dk and dv are unused).
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
