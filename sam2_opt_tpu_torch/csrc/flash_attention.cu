// Masked flash-attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel sam2_opt_tpu/kernels/flash_attention.py::_kernel
// (K1, with its online-softmax helpers _ns_init/_ns_update/_ns_finish). It
// computes exactly what K1 computes:
//   s      = (q . k^T) * scale,  scale = 1/sqrt(D) with the true head dim D
//   s[key] = -1e30 where the key is masked (kv_mask false) or past Skv
//   out    = softmax(s) . v, accumulated in fp32 with an online softmax
//            (bf16: p is rounded to bf16 for the p . v product, l sums it in
//            fp32, as K1's p.astype(v.dtype) does)
//   lse    = m + log(l) per query row (m = running max, l = running sum)
// A row whose keys are all masked keeps m == -1e30 and gets out = 0 and
// lse = -1e30 (K1's _ns_finish rule). Masking with -1e30 rather than -inf
// keeps an all-masked kv tile inside a valid row exact: its p underflows to
// 0, and a masked prefix is rescaled away by alpha = exp(-1e30 - m) = 0.
//
// Layout. q/k/v are [B, H, S, D] with any batch/head/sequence strides and a
// unit stride along D (bf16: rows 16-byte aligned, which the wrapper
// checks); out has its own strides; lse is [B*H, Sq] fp32. The wrapper
// (sam2_opt_tpu_torch/kernels/flash_attention.py) allocates every output;
// this file launches on the caller's stream and allocates nothing. Pallas'
// sequential kv grid axis becomes a loop inside the CTA: one CTA owns a
// 64-row query tile of one (b, h), walks the 64-key tiles, and keeps the
// running m, l and the [64, D] accumulator in registers. The head dim is
// zero-padded to a multiple of 16 in shared memory only (never in device
// memory), so D = 56, 72, 96 and any multiple of 8 up to 128 run through one
// template each.
//
// Bound. At the main-path shape (hiera-L global blocks: B*H = 8,
// Sq = Skv = 4096, D = 72) K1 does 4*8*4096^2*72 = 38.7 GFLOP on 18.9 MB of
// bf16 q/k/v/out, 2000 operations per byte: compute-bound on either route.
// What the design does about it:
//  - bf16 runs on the tensor cores with mma.sync m16n8k16 (fp32
//    accumulation), bounded by 989 TFLOP/s, ~39 us. Each warp owns 16 query
//    rows; S = Q K^T stays in registers and is re-packed in place as the A
//    operand of P V (no trip through shared memory); K and V tiles stream
//    through a 2-stage cp.async ring, so the next tile loads while this one
//    is multiplied, and reach the tensor cores through ldmatrix; the softmax
//    runs in the log2 domain on the SFU's exp2.
//    wgmma, TMA and warp specialisation are the next steps.
//  - fp32 runs true fp32 FMAs on the CUDA cores (no TF32), bounded by
//    67 TFLOP/s, ~0.58 ms: a 4x4 score micro-tile from 16-byte shared loads
//    keeps the Q K^T loop FMA-bound, and 102 KB of shared memory per CTA lets
//    two CTAs share an SM to hide load latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, Skv] bool, row stride mask_sb; null = all valid
  void* o;
  float* lse;           // [B*H, Sq]
  int B, H, Sq, Skv, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long mask_sb;
  float scale;
};

__device__ __forceinline__ bool key_valid(const uint8_t* mg, int key, int Skv) {
  return key < Skv && (mg == nullptr || mg[key] != 0);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int LD = BQ + 4;    // row stride of the d-major tiles (16-byte aligned rows)

static_assert(BQ == BK, "the P^T tile reuses the K tile's row stride");

__device__ __forceinline__ float group16_max(float x) {
  // the 16 lanes sharing a query row are one aligned half-warp
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
constexpr int smem_bytes_f32() {
  // Qt [DP][LD] + (Kt [DP][LD] | P^T [BK][LD]) + Vs [BK][DP]
  return (DP * LD + (DP > BK ? DP : BK) * LD + BK * DP) * static_cast<int>(sizeof(float));
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_f32_kernel(const Params p) {
  constexpr int NC = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                            // [DP][LD]  Q tile, d-major
  float* Kt = Qt + DP * LD;                    // [DP][LD]  K tile, d-major
  float* Pt = Kt;                              // [BK][LD]  P^T, reuses the K tile
  float* Vs = Kt + (DP > BK ? DP : BK) * LD;   // [BK][DP]  V tile, row-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key columns tx*4..+3 of S; output columns tx + 16c
  const int ty = tid >> 4;  // query rows ty*4..+3
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    Qt[d * LD + r] = (q0 + r < p.Sq && d < p.D) ? qg[(q0 + r) * p.q_ss + d] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (p.Skv + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P^T and V reads are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int r = idx / DP, d = idx % DP;
      const bool in = k0 + r < p.Skv && d < p.D;
      Kt[d * LD + r] = in ? kg[(k0 + r) * p.k_ss + d] : 0.f;
      Vs[r * DP + d] = in ? vg[(k0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = key_valid(mg, k0 + tx * 4 + j, p.Skv);
    __syncthreads();  // every thread is done reading Kt before P^T overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = valid[j] ? s[i][j] * p.scale : NEG_INF;
      const float m_cur = group16_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[kk * LD + ty * 4]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * DP + tx + 16 * c];
        acc[0][c] = fmaf(a.x, vv, acc[0][c]);
        acc[1][c] = fmaf(a.y, vv, acc[1][c]);
        acc[2][c] = fmaf(a.z, vv, acc[2][c]);
        acc[3][c] = fmaf(a.w, vv, acc[3][c]);
      }
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[i] > NEG_INF * 0.5f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) og[row * p.o_ss + col] = seen_valid ? acc[i][c] / l[i] : 0.f;
    }
    if (tx == 0) p.lse[(long long)bh * p.Sq + row] = seen_valid ? m[i] + logf(l[i]) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows per CTA, 16 per warp
constexpr int TC_BK = 64;             // keys per kv tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Row stride (in bf16) of the K/V tiles: DP + 8 makes it an odd multiple of
// 16 bytes, so the 8 rows one fragment load touches hit distinct banks.
__host__ __device__ constexpr int tc_ld(int dp) { return dp + 8; }

template <int DP>
constexpr int smem_bytes_bf16() {
  return 2 * 2 * TC_BK * tc_ld(DP) * static_cast<int>(sizeof(__nv_bfloat16));  // {K,V} x 2 stages
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b for one 16x8x16 tile: a row-major [16][16], b column-major [16][8]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, transposed: the B operand of
// P . V for two 8-column slices of the head dim, from V stored [key][d]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// four 8x8 bf16 matrices from shared memory: the B operand of Q . K^T for
// two 8-key slices and one 16-wide k-step, from K stored [key][d]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16-byte async copy to shared memory; fill = false writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            bool fill) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_newest_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the 4 lanes of a quad share a query row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Up to DP = 80 the kernel is held to 128 registers, so four CTAs share an
// SM and hiera-L's 512 CTAs (B*H = 8, Sq = 4096) fill the 132 SMs in one
// wave; wider heads keep their registers (the cap spills them).
template <int DP>
__global__ void __launch_bounds__(TC_WARPS * 32, DP <= 80 ? 4 : 1)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int LDK = tc_ld(DP);
  constexpr int KS = DP / 16;     // k-steps of Q . K^T
  constexpr int ND = DP / 8;      // 8-column slices of the output
  constexpr int NT = TC_BK / 8;   // 8-key slices of S
  constexpr int TILE = TC_BK * LDK;
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* Ks = tc_smem;              // [2][TC_BK][LDK]
  __nv_bfloat16* Vs = tc_smem + 2 * TILE;   // [2][TC_BK][LDK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * TC_BQ + warp * 16;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;

  // The padded head-dim columns [D, DP) (one 8-column chunk at most) are
  // zeroed once; the copies below never write them.
  if (p.D < DP)
    for (int r = threadIdx.x; r < 4 * TC_BK; r += blockDim.x)
      *reinterpret_cast<uint4*>(&tc_smem[r * LDK + p.D]) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int chunks = p.D / 8;  // 16-byte chunks per row in device memory
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * TC_BK;
    for (int idx = threadIdx.x; idx < TC_BK * chunks; idx += blockDim.x) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      const bool in = k0 + r < p.Skv;  // rows past Skv are zero-filled
      const long long row = in ? k0 + r : 0;
      cp_async_16(Ks + stage * TILE + r * LDK + c, kg + row * p.k_ss + c, in);
      cp_async_16(Vs + stage * TILE + r * LDK + c, vg + row * p.v_ss + c, in);
    }
  };
  const int n_tiles = (p.Skv + TC_BK - 1) / TC_BK;
  load_tile(0, 0);
  cp_async_commit();

  // this warp's 16 query rows as the A operand of Q . K^T, straight from device memory
  uint32_t qa[KS][4];
  auto q_pair = [&](int row, int col) -> uint32_t {
    return (row < p.Sq && col < p.D)
               ? *reinterpret_cast<const uint32_t*>(qg + row * p.q_ss + col)
               : 0u;
  };
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = q_pair(q0 + g, 16 * ks + 2 * t);
    qa[ks][1] = q_pair(q0 + g + 8, 16 * ks + 2 * t);
    qa[ks][2] = q_pair(q0 + g, 16 * ks + 8 + 2 * t);
    qa[ks][3] = q_pair(q0 + g + 8, 16 * ks + 8 + 2 * t);
  }

  // rows g and g + 8 of the warp's tile; scores kept in the log2 domain
  const float scale_log2 = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this tile
    cp_async_wait_newest_pending();
    __syncthreads();
    const __nv_bfloat16* ks_tile = Ks + (tile & 1) * TILE;
    const __nv_bfloat16* vs_tile = Vs + (tile & 1) * TILE;

    // S = Q . K^T: [16 rows][64 keys] per warp, fp32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    // ldmatrix rows: keys 8*nt + 0..15 (two 8-key slices), d-columns 16*ks + {0, 8}
    const __nv_bfloat16* kfrag =
        ks_tile + ((lane & 7) + 8 * (lane >> 4)) * LDK + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kfrag + 8 * nt * LDK + 16 * ks);
        mma_bf16(s[nt], qa[ks], kb[0], kb[1]);
        mma_bf16(s[nt + 1], qa[ks], kb[2], kb[3]);
      }

    // scale, mask, online softmax
    const int k0 = tile * TC_BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = key_valid(mg, k0 + 8 * nt + 2 * t + j, p.Skv);
        s[nt][j] = valid ? s[nt][j] * scale_log2 : NEG_INF;
        s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : NEG_INF;
        mx[0] = fmaxf(mx[0], s[nt][j]);
        mx[1] = fmaxf(mx[1], s[nt][2 + j]);
      }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nt][j] = exp2f(s[nt][j] - m[j >> 1]);
        row_sum[j >> 1] += s[nt][j];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(row_sum[i]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P . V: S's accumulator layout is the A-operand layout, so P is
    // re-packed to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = vs_tile + (16 * kk + (lane & 15)) * LDK + 8 * (lane >> 4);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + 8 * nd);
        mma_bf16(o[nd], pa, vb[0], vb[1]);
        mma_bf16(o[nd + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + g + 8 * i;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[i] > NEG_INF * 0.5f;
    const float inv_l = seen_valid ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
            __floats2bfloat162_rn(o[nd][2 * i] * inv_l, o[nd][2 * i + 1] * inv_l);
    }
    if (t == 0)
      p.lse[(long long)bh * p.Sq + row] = seen_valid ? (m[i] + log2f(l[i])) * LN2 : NEG_INF;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int rows_per_cta, int threads, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows_per_cta - 1) / rows_per_cta, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dp(bool bf16, const Params& p, cudaStream_t stream) {
  if (bf16)
    return launch(flash_fwd_bf16_kernel<DP>, smem_bytes_bf16<DP>(), TC_BQ, TC_WARPS * 32, p,
                  stream);
  return launch(flash_fwd_f32_kernel<DP>, smem_bytes_f32<DP>(), BQ, THREADS, p, stream);
}

cudaError_t dispatch(bool bf16, const Params& p, cudaStream_t stream) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_dp<16>(bf16, p, stream);
    case 2: return launch_dp<32>(bf16, p, stream);
    case 3: return launch_dp<48>(bf16, p, stream);
    case 4: return launch_dp<64>(bf16, p, stream);
    case 5: return launch_dp<80>(bf16, p, stream);
    case 6: return launch_dp<96>(bf16, p, stream);
    case 7: return launch_dp<112>(bf16, p, stream);
    case 8: return launch_dp<128>(bf16, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = cudaSuccess). dtype: 0 fp32, 1 bf16.
extern "C" int sam2_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
    int dtype, int B, int H, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 128 || D % 8 != 0 ||
      static_cast<long long>(B) * H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = o; p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.mask_sb = mask_sb;
  p.scale = scale;
  return static_cast<int>(dispatch(dtype == 1, p, static_cast<cudaStream_t>(stream)));
}
