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
//
// K2 (sam2_flash_attention_rope_fwd) replaces the Pallas TPU kernel
// sam2_opt_tpu/kernels/flash_attention.py::_kernel_rope: K1, with K rotated
// inside the kernel in the split channel layout as each kv tile arrives,
//   kr = [k1 * cos - k2 * sin, k1 * sin + k2 * cos]   (k1, k2: halves of D)
// with cos/sin [Skv, D/2] tables (rows with cos = 1, sin = 0 leave the
// object-pointer tokens unrotated); q arrives rotated. The rotation runs in
// fp32 from the inputs with separate roundings (no FMA), rounded once to
// K's dtype, exactly as the plain version rotates. It serves memory
// attention at D = 256, H = 1: self-attention 4096 x 4096 keys and
// cross-attention 4096 x 28,736 keys (7 memory frames + 64 pointer tokens)
// under a validity mask. Bound: 4*4096*28736*256 = 120.5 GFLOP on 29 MB of
// bf16 K/V, compute-bound (0.122 ms bf16, 1.80 ms fp32). Design:
//  - bf16: K1's mma.sync scheme, but at D = 256 a warp's fp32 accumulator
//    takes 128 registers per thread, so Q lives in shared memory (one
//    ldmatrix per k-step) and the kv tile is 32 keys; each K tile is rotated
//    in place in shared memory after its cp.async lands and before the
//    ldmatrix loads. 101 KB of shared memory, two CTAs per SM.
//  - fp32: K1's FMA kernel, rotating K while it is copied to shared memory.
//  - Both skip kv tiles whose keys are all masked (the empty memory slots of
//    the first tracked frames), which is exact.
//  - At one object one CTA per 64 query rows is only 64 CTAs, under half
//    the 132 SMs. So the kv axis is split over blockIdx.z into as many
//    ranges as keep the grid in one wave of resident CTAs (the occupancy
//    API says how many fit, sam2_flash_attention_rope_splits): each split
//    writes its normalized fp32 output and row LSE to scratch, and
//    flash_rope_combine_kernel merges them (out = sum_s exp(lse_s - lse)
//    out_s), a few MB of traffic against ~100 GFLOP.

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
  const void* cos;      // K2: [Skv, D/2] in q's dtype, contiguous; K1: null
  const void* sin;
  void* o;
  float* lse;           // [B*H, Sq]
  // K2 may split the kv axis over blockIdx.z: each split writes its
  // normalized fp32 output and row LSE here, flash_rope_combine merges them
  int n_split;          // 1: no split (K1 always)
  float* part_o;        // [n_split, B*H, Sq, D]
  float* part_lse;      // [n_split, B*H, Sq]
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

// One body for K1 (ROPE = false) and K2 (ROPE = true, D == DP): K2 rotates
// each K tile as it is copied to shared memory and skips kv tiles whose keys
// are all masked.
template <int DP, bool ROPE>
__device__ __forceinline__ void flash_f32_body(const Params& p) {
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
  const int per_split = (n_tiles + p.n_split - 1) / p.n_split;
  const int t_end = min(n_tiles, (static_cast<int>(blockIdx.z) + 1) * per_split);
  for (int t = blockIdx.z * per_split; t < t_end; ++t) {
    const int k0 = t * BK;
    if constexpr (ROPE) {
      // the barrier after which the previous tile's P^T and V reads are
      // done; a tile with no valid key is skipped (exact, see the top note)
      if (!__syncthreads_or(tid < BK && key_valid(mg, k0 + tid, p.Skv))) continue;
      constexpr int HALF = DP / 2;
      const float* cg = static_cast<const float*>(p.cos);
      const float* sg = static_cast<const float*>(p.sin);
      for (int idx = tid; idx < BK * HALF; idx += THREADS) {
        const int r = idx / HALF, d = idx % HALF;
        float lo = 0.f, hi = 0.f;
        if (k0 + r < p.Skv) {
          const long long row = k0 + r;
          const float k1 = kg[row * p.k_ss + d], k2 = kg[row * p.k_ss + d + HALF];
          const float c = cg[row * HALF + d], s = sg[row * HALF + d];
          lo = __fsub_rn(__fmul_rn(k1, c), __fmul_rn(k2, s));
          hi = __fadd_rn(__fmul_rn(k1, s), __fmul_rn(k2, c));
        }
        Kt[d * LD + r] = lo;
        Kt[(d + HALF) * LD + r] = hi;
      }
      for (int idx = tid; idx < BK * DP; idx += THREADS) {
        const int r = idx / DP, d = idx % DP;
        Vs[r * DP + d] = k0 + r < p.Skv ? vg[(k0 + r) * p.v_ss + d] : 0.f;
      }
    } else {
      __syncthreads();  // the previous tile's P^T and V reads are done
      for (int idx = tid; idx < BK * DP; idx += THREADS) {
        const int r = idx / DP, d = idx % DP;
        const bool in = k0 + r < p.Skv && d < p.D;
        Kt[d * LD + r] = in ? kg[(k0 + r) * p.k_ss + d] : 0.f;
        Vs[r * DP + d] = in ? vg[(k0 + r) * p.v_ss + d] : 0.f;
      }
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
  long long o_ss = p.o_ss;
  float* lse_out = p.lse + (long long)bh * p.Sq;
  if (p.n_split > 1) {  // this split's partial result
    const long long part = static_cast<long long>(blockIdx.z) * p.B * p.H + bh;
    og = p.part_o + part * p.Sq * p.D;
    o_ss = p.D;
    lse_out = p.part_lse + part * p.Sq;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[i] > NEG_INF * 0.5f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) og[row * o_ss + col] = seen_valid ? acc[i][c] / l[i] : 0.f;
    }
    if (tx == 0) lse_out[row] = seen_valid ? m[i] + logf(l[i]) : NEG_INF;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_f32_kernel(const Params p) {
  flash_f32_body<DP, false>(p);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_rope_f32_kernel(const Params p) {
  flash_f32_body<DP, true>(p);
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// ---------------------------------------------------------------------------
// K2 bf16: K1's tensor-core scheme at head dims up to 256, K rotated in
// shared memory
// ---------------------------------------------------------------------------
//
// At D = 256 a warp's [16][256] fp32 accumulator alone takes 128 registers
// per thread, so Q leaves the registers for shared memory (one ldmatrix per
// k-step) and the kv tile shrinks to 32 keys (S takes 16 registers).
// Q [64][264] + {K, V} x 2 stages [32][264] = 101,376 bytes: two CTAs per SM.

constexpr int RP_BK = 32;  // keys per kv tile

template <int DP>
constexpr int smem_bytes_rope_bf16() {
  return (TC_BQ + 4 * RP_BK) * tc_ld(DP) * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ float rot_lo(float x1, float x2, float c, float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));  // no FMA: the plain version's rounding
}

__device__ __forceinline__ float rot_hi(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

template <int DP>
__global__ void __launch_bounds__(TC_WARPS * 32, 2) flash_rope_bf16_kernel(const Params p) {
  constexpr int LDK = tc_ld(DP);
  constexpr int KS = DP / 16;      // k-steps of Q . K^T
  constexpr int ND = DP / 8;       // 8-column slices of the output
  constexpr int NT = RP_BK / 8;    // 8-key slices of S
  constexpr int HALF = DP / 2;
  constexpr int CHUNKS = DP / 8;   // 16-byte chunks per row
  constexpr int TILE = RP_BK * LDK;
  extern __shared__ __align__(16) __nv_bfloat16 rp_smem[];
  __nv_bfloat16* Qs = rp_smem;             // [TC_BQ][LDK]
  __nv_bfloat16* Ks = Qs + TC_BQ * LDK;    // [2][RP_BK][LDK]
  __nv_bfloat16* Vs = Ks + 2 * TILE;       // [2][RP_BK][LDK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q_tile = blockIdx.x * TC_BQ;
  const int q0 = q_tile + warp * 16;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.cos);
  const __nv_bfloat16* sg = static_cast<const __nv_bfloat16*>(p.sin);
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;

  // the CTA's Q tile (rows past Sq zero-filled) rides in the first copy group
  for (int idx = threadIdx.x; idx < TC_BQ * CHUNKS; idx += blockDim.x) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    const bool in = q_tile + r < p.Sq;
    const long long row = in ? q_tile + r : 0;
    cp_async_16(Qs + r * LDK + c, qg + row * p.q_ss + c, in);
  }
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * RP_BK;
    for (int idx = threadIdx.x; idx < RP_BK * CHUNKS; idx += blockDim.x) {
      const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
      const bool in = k0 + r < p.Skv;  // rows past Skv are zero-filled
      const long long row = in ? k0 + r : 0;
      cp_async_16(Ks + stage * TILE + r * LDK + c, kg + row * p.k_ss + c, in);
      cp_async_16(Vs + stage * TILE + r * LDK + c, vg + row * p.v_ss + c, in);
    }
  };
  const int n_tiles = (p.Skv + RP_BK - 1) / RP_BK;
  const int per_split = (n_tiles + p.n_split - 1) / p.n_split;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();

  const float scale_log2 = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // ldmatrix rows of this warp's Q (A operand: rows 0..15, d-columns +0 / +8)
  const __nv_bfloat16* qfrag = Qs + (warp * 16 + (lane & 15)) * LDK + 8 * (lane >> 4);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int stage = (tile - t_begin) & 1;
    if (tile + 1 < t_end) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this tile
    cp_async_wait_newest_pending();
    const int k0 = tile * RP_BK;
    // the barrier after which this tile's copies are visible to all warps;
    // a tile with no valid key is skipped (exact, as a masked tile is in K1)
    if (!__syncthreads_or(threadIdx.x < RP_BK && key_valid(mg, k0 + threadIdx.x, p.Skv)))
      continue;
    __nv_bfloat16* ks_tile = Ks + stage * TILE;
    const __nv_bfloat16* vs_tile = Vs + stage * TILE;

    // rotate the K tile in place, two channel pairs per step, in fp32 from
    // the bf16 inputs and rounded once to bf16
    for (int idx = threadIdx.x; idx < RP_BK * (HALF / 2); idx += blockDim.x) {
      const int r = idx / (HALF / 2), d = (idx % (HALF / 2)) * 2;
      if (k0 + r >= p.Skv) continue;  // zero-filled rows stay zero
      const long long trow = static_cast<long long>(k0 + r) * HALF + d;
      __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(ks_tile + r * LDK + d);
      __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(ks_tile + r * LDK + HALF + d);
      const float2 x1 = __bfloat1622float2(*lo), x2 = __bfloat1622float2(*hi);
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cg + trow));
      const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sg + trow));
      *lo = __floats2bfloat162_rn(rot_lo(x1.x, x2.x, c.x, s.x), rot_lo(x1.y, x2.y, c.y, s.y));
      *hi = __floats2bfloat162_rn(rot_hi(x1.x, x2.x, c.x, s.x), rot_hi(x1.y, x2.y, c.y, s.y));
    }
    __syncthreads();

    // S = Q . K^T: [16 rows][32 keys] per warp, fp32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kfrag =
        ks_tile + ((lane & 7) + 8 * (lane >> 4)) * LDK + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qfrag + 16 * ks);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kfrag + 8 * nt * LDK + 16 * ks);
        mma_bf16(s[nt], qa, kb[0], kb[1]);
        mma_bf16(s[nt + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax (K1's)
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

    // O += P . V, P re-packed to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < RP_BK / 16; ++kk) {
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
  cp_async_wait_all();  // a split with no tile still has its Q copy in flight

  const long long part = static_cast<long long>(blockIdx.z) * p.B * p.H + bh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* po = p.part_o + part * p.Sq * DP;  // used when the kv axis is split
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + g + 8 * i;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[i] > NEG_INF * 0.5f;
    const float inv_l = seen_valid ? 1.f / l[i] : 0.f;
    const float lse = seen_valid ? (m[i] + log2f(l[i])) * LN2 : NEG_INF;
    if (p.n_split > 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<float2*>(po + row * DP + 8 * nd + 2 * t) =
            make_float2(o[nd][2 * i] * inv_l, o[nd][2 * i + 1] * inv_l);
      if (t == 0) p.part_lse[part * p.Sq + row] = lse;
    } else {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + 8 * nd + 2 * t) =
            __floats2bfloat162_rn(o[nd][2 * i] * inv_l, o[nd][2 * i + 1] * inv_l);
      if (t == 0) p.lse[(long long)bh * p.Sq + row] = lse;
    }
  }
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Merges K2's kv splits: out = sum_s exp(lse_s - lse) * out_s with
// lse = log sum_s exp(lse_s); a split that saw no valid key has lse_s =
// -1e30 and weight 0; a row with none at all gets 0 and -1e30. One CTA per
// (query row, b*h), one thread per output column.
template <typename T>
__global__ void __launch_bounds__(128) flash_rope_combine_kernel(const Params p) {
  const int row = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const long long split_stride = static_cast<long long>(p.B) * p.H * p.Sq;
  const float* pl = p.part_lse + static_cast<long long>(bh) * p.Sq + row;
  float m = NEG_INF;
  for (int sp = 0; sp < p.n_split; ++sp) m = fmaxf(m, pl[sp * split_stride]);
  const bool seen_valid = m > NEG_INF * 0.5f;
  float l = 0.f;
  for (int sp = 0; sp < p.n_split; ++sp) l += expf(pl[sp * split_stride] - m);
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
  const float* po = p.part_o + (static_cast<long long>(bh) * p.Sq + row) * p.D;
  for (int col = threadIdx.x; col < p.D; col += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < p.n_split; ++sp)
      acc += expf(pl[sp * split_stride] - m) * po[sp * split_stride * p.D + col];
    store_out(og + col, seen_valid ? acc / l : 0.f);
  }
  if (threadIdx.x == 0) p.lse[static_cast<long long>(bh) * p.Sq + row] =
      seen_valid ? m + logf(l) : NEG_INF;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int rows_per_cta, int threads, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows_per_cta - 1) / rows_per_cta, p.B * p.H, p.n_split);
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

template <int DP>
cudaError_t launch_rope_dp(bool bf16, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      bf16 ? launch(flash_rope_bf16_kernel<DP>, smem_bytes_rope_bf16<DP>(), TC_BQ,
                    TC_WARPS * 32, p, stream)
           : launch(flash_rope_f32_kernel<DP>, smem_bytes_f32<DP>(), BQ, THREADS, p, stream);
  if (err != cudaSuccess || p.n_split == 1) return err;
  const dim3 grid(p.Sq, p.B * p.H);
  if (bf16)
    flash_rope_combine_kernel<__nv_bfloat16><<<grid, 128, 0, stream>>>(p);
  else
    flash_rope_combine_kernel<float><<<grid, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

// Resident CTAs per SM of a kernel at its shared memory (1 if unknown).
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int smem, int threads) {
  int n = 1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

template <int DP>
int rope_ctas_per_sm(bool bf16) {
  return bf16 ? ctas_per_sm(flash_rope_bf16_kernel<DP>, smem_bytes_rope_bf16<DP>(),
                            TC_WARPS * 32)
              : ctas_per_sm(flash_rope_f32_kernel<DP>, smem_bytes_f32<DP>(), THREADS);
}

cudaError_t dispatch_rope(bool bf16, const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 64: return launch_rope_dp<64>(bf16, p, stream);
    case 128: return launch_rope_dp<128>(bf16, p, stream);
    case 256: return launch_rope_dp<256>(bf16, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool rope, const void* q, const void* k, const void* v, const void* mask,
        const void* cos, const void* sin, void* part_o, void* part_lse, void* o, void* lse,
        int dtype, int B, int H, int Sq, int Skv, int D, int n_split, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
        long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
        long long o_sb, long long o_sh, long long o_ss, long long mask_sb, float scale,
        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 ||
      static_cast<long long>(B) * H > 65535 || (dtype != 0 && dtype != 1) || n_split < 1 ||
      n_split > 65535 || (n_split > 1 && (part_o == nullptr || part_lse == nullptr)) ||
      (rope ? (cos == nullptr || sin == nullptr) : (D > 128 || n_split != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = cos; p.sin = sin;
  p.o = o; p.lse = static_cast<float*>(lse);
  p.n_split = n_split;
  p.part_o = static_cast<float*>(part_o); p.part_lse = static_cast<float*>(part_lse);
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.mask_sb = mask_sb;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rope ? dispatch_rope(dtype == 1, p, st) : dispatch(dtype == 1, p, st));
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 = cudaSuccess).
// dtype: 0 fp32, 1 bf16.

// K1: D a multiple of 8 up to 128.
extern "C" int sam2_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
    int dtype, int B, int H, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  return run(false, q, k, v, mask, nullptr, nullptr, nullptr, nullptr, o, lse, dtype, B, H, Sq,
             Skv, D, 1, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
             mask_sb, scale, stream);
}

// K2: K1 with K rotated in the kernel; D in {64, 128, 256}; cos/sin [Skv, D/2]
// in q's dtype, contiguous. With n_split > 1 the kv axis is split over
// n_split CTAs per query tile and part_o [n_split, B*H, Sq, D] / part_lse
// [n_split, B*H, Sq] (fp32, allocated by the caller) hold the partial results
// until the combine kernel, launched right after on the same stream, merges
// them.
extern "C" int sam2_flash_attention_rope_fwd(
    const void* q, const void* k, const void* v, const void* mask, const void* cos,
    const void* sin, void* part_o, void* part_lse, void* o, void* lse, int dtype, int B, int H,
    int Sq, int Skv, int D, int n_split,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  return run(true, q, k, v, mask, cos, sin, part_o, part_lse, o, lse, dtype, B, H, Sq, Skv, D,
             n_split, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
             mask_sb, scale, stream);
}

// K2's kv split for these shapes on the current device: the most splits
// that keep the grid in one wave of resident CTAs, at least 8 kv tiles each.
// Returns >= 1, or -1 for an unsupported D.
extern "C" int sam2_flash_attention_rope_splits(int dtype, int B, int H, int Sq, int Skv,
                                                int D) {
  const bool bf16 = dtype == 1;
  int per_sm;
  switch (D) {
    case 64: per_sm = rope_ctas_per_sm<64>(bf16); break;
    case 128: per_sm = rope_ctas_per_sm<128>(bf16); break;
    case 256: per_sm = rope_ctas_per_sm<256>(bf16); break;
    default: return -1;
  }
  int dev = 0, n_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const int rows = bf16 ? TC_BQ : BQ, tile = bf16 ? RP_BK : BK;
  const long long ctas = static_cast<long long>((Sq + rows - 1) / rows) * B * H;
  const long long n_tiles = (Skv + tile - 1) / tile;
  long long n = static_cast<long long>(per_sm) * n_sm / ctas;
  if (n > n_tiles / 8) n = n_tiles / 8;
  return static_cast<int>(n < 1 ? 1 : n);
}
