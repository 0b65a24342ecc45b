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
// tile of query rows of one (b, h) (fp32: 64, bf16: 128), walks the kv
// tiles, and keeps the running m, l and the [rows, D] accumulator in
// registers. The head dim is zero-padded in shared memory only (never in
// device memory): to a multiple of 16 for Q . K^T, so D = 56, 72, 96 and any
// multiple of 8 up to 128 run through one template each.
//
// Bound. At the main-path shape (hiera-L global blocks: B*H = 8,
// Sq = Skv = 4096, D = 72) K1 does 4*8*4096^2*72 = 38.7 GFLOP on 18.9 MB of
// bf16 q/k/v/out, 2000 operations per byte: compute-bound on either route.
// What the design does about it:
//  - bf16 (D <= 128) runs warp-specialised wgmma fed by TMA (its section
//    below): 128 query rows a CTA (256 CTAs at hiera-L, two waves of one CTA
//    per SM on 132 SMs), so each CTA's streaming of K and V (1.18 MB, from
//    L2) is shared by twice the rows of a 64-row tile: 0.3 GB of L2 reads a
//    call instead of 0.6. The tensor-core bound is 39 us (41 us of executed
//    work: Q . K^T at D padded to 80); 8*4096^2 = 134M exponentials at 16 a
//    clock per SM need 32 us on their own, so one warpgroup's softmax runs
//    while the other's products do.
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
//  - bf16: mma.sync m16n8k16 with fp32 accumulation, 16 query rows a warp,
//    S re-packed in registers as the A operand of P V, K and V through a
//    2-stage cp.async ring and ldmatrix; at D = 256 a warp's fp32 accumulator
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
//    flash_combine_kernel merges them (out = sum_s exp(lse_s - lse)
//    out_s), a few MB of traffic against ~100 GFLOP.
// K1 at D = 256 (memory attention with the rotation fusion turned off,
// SAM2_TPU_FUSED_ROPE=0: K rotated beforehand, the same shapes as K2's) runs
// K2's kernels without the rotation (flash_wide_bf16_kernel<256, false>,
// flash_fwd_f32_kernel<256>), with K2's kv split, combine and exact skip of
// kv tiles without a valid key.
//
// K4 (sam2_flash_attention_kvproj_fwd) replaces the Pallas TPU kernel
// sam2_opt_tpu/kernels/flash_attention.py::_kernel_rope_kvproj: K2 with the
// memory cross-attention's K and V projections (mem_dim Dm = 64 -> D = 256)
// fused in. The kv stream is read Dm wide; each kv tile is projected on the
// SM,
//   kp = round(mem_k . Wk^T + bk),  vp = round(mem_v . Wv^T + bv)
// (fp32 sums, the bias added in fp32, one rounding to q's dtype), kp is
// rotated as K2 rotates K, and the tile goes through K2's masked flash
// softmax; the projected K/V never reach device memory. Weights are
// nn.Linear [D, Dm] in q's dtype, biases fp32 [D]. Bound at the cross shape
// (B = 1, 4096 queries, 28,736 keys): 4*4096*28736*256 + 2*2*28736*64*256 =
// 122.4 GFLOP (0.124 ms bf16, 1.83 ms fp32), compute-bound. Each query tile
// re-projects every kv tile it reads, so the executed work is 120.5 GFLOP of
// attention plus (Sq / rows per CTA) x 1.88 GFLOP of projections. Design:
//  - 128 query rows per CTA (8 warps; K2 has 64), so the projections add
//    half the attention's work (60 GFLOP at 32 query tiles), not all of it;
//  - bf16: mma.sync as K2. Wk and Wv (2 x 36 KB) stay resident in shared
//    memory for the CTA's life; the raw 32-key memory tiles stream through a
//    2-stage cp.async ring. Each warp projects K for its 16 channels d of
//    the first half and the 16 channels d + D/2 of the second, so one thread
//    holds both halves of a rotation pair in its accumulators and rotates in
//    registers; V for its 32 channels. Q [128][264], Wk, Wv, K, V tiles and
//    the ring: 196 KB, one CTA per SM;
//  - fp32: K2's FMA scheme at 128 rows x 32 keys per CTA (Q, K, P^T and V
//    in shared memory, 223 KB); each thread projects 2 channels of K (a
//    rotation pair) or V for the 32 keys, reading the weight rows through
//    L1/L2 (they do not fit beside the fp32 Q tile);
//  - K2's exact skip of kv tiles without a valid key, its -1e30 masking, its
//    identity rows for the pointer tokens (cos = 1, sin = 0) and its kv split
//    over blockIdx.z with the LSE combine. Keys past Skv are masked, not
//    padded: the TPU kernel's lane padding (Dm and D to 128, Skv to the block)
//    has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::make_map;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_arrive;
using hopper::named_sync;
using hopper::pack_bf16;
using hopper::smem_desc;
using hopper::smem_desc_mn_atoms;
using hopper::smem_u32;
using hopper::tma_load_4d;
using hopper::to_a_frag;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_tb;
using hopper::wgmma_ss_n128;
using hopper::wgmma_wait;

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
  // K4: k / v are the Dm-wide memory tokens, projected in the kernel by
  // wk / wv [D, Dm] (q's dtype, contiguous) plus bk / bv [D] (fp32)
  const void* wk;
  const void* wv;
  const float* bk;
  const float* bv;
  int B, H, Sq, Skv, D, Dm;
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
// bf16 on mma.sync m16n8k16 (fp32 accumulation): the helpers of K2, K4 and
// K1 at D = 256
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows per CTA, 16 per warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Row stride (in bf16) of the K/V tiles: DP + 8 makes it an odd multiple of
// 16 bytes, so the 8 rows one fragment load touches hit distinct banks.
__host__ __device__ constexpr int tc_ld(int dp) { return dp + 8; }

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

// ---------------------------------------------------------------------------
// K1 bf16 at D <= 128: warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// A CTA is three warpgroups. One warp of the first keeps TMA loads in flight
// (40 registers, setmaxnreg); the other two consume (232), each owning 64 of
// the CTA's 128 query rows. Q arrives once; K and V tiles of 128 keys stream
// through two rings, one of K tiles and one of V tiles (3 stages each at
// D > 64, 6 below), each stage with its own full/empty mbarrier pair, so a K
// stage is free again as soon as its S is done; tiles arrive as 128-byte
// swizzled boxes of 64 head-dim columns whose columns past D TMA fills with
// zeros. Beside each K stage the producer writes the tile's first key and
// its valid keys as four 32-bit words (from the mask where one is given,
// else from Skv: no mask bytes are read), and whether all 128 are valid; a
// tile with no valid key is skipped, which is exact (see the top note). Per
// tile and warpgroup:
//   S = Q K^T      wgmma m64n128k16, both operands K-major from shared
//                  memory, over the head dim padded to DP, the next multiple
//                  of 16 (72 -> 80, 56 -> 64), not of 64;
//   O += P V       wgmma m64nDVk16, P from registers (S's accumulator fragment
//                  rounded to bf16 is the A fragment) and V as the MN-major
//                  B operand, N = DV = D at D = 56, 72 and multiples of 16
//                  (one descriptor spans both 64-column swizzle atoms: its
//                  leading offset is the box stride), else D padded to 16.
// The softmax of one warpgroup runs while the other's products do
// (FlashAttention-3's ping-pong): two named barriers hand the tensor cores
// from one warpgroup to the other, and each turn issues S of tile i and then
// P V of tile i - 1, so a warpgroup's exponentials overlap the other's
// products and its own P V.
//
// What bounds it (H100 80GB HBM3, 700 W, hiera-L's (1, 8, 4096, 72)): not
// the products nor the exponentials, whose removal each moved the time by
// under a tenth, nor the ping-pong; about 0.07 ms of a call does not grow
// with D (D = 56 and 64 take the same time), and the kv stream is slower on
// hiera's 144-byte rows than on 256-byte ones. Two CTAs sharing each K/V
// tile by TMA multicast, or 256 query rows a CTA (half the L2 reads per
// product), were slower.

constexpr int WG_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int WG_BQ = 128;       // query rows per CTA, 64 per consumer warpgroup
constexpr int WG_BK = 128;       // keys per stage
constexpr int BOX_ROW = 128;     // bytes of one swizzled box row: 64 bf16 columns
constexpr int SMEM_LIMIT = 232448;
constexpr int BARS_BYTES = 512;  // mbarriers, then each K stage's first key, key words, density
constexpr int MAX_STAGES = 6;
constexpr int BAR_TURN = 1;      // named barriers 1 and 2: the consumer warpgroups' turns

template <int DV>
struct FwdWg {
  static constexpr int DP = (DV + 15) / 16 * 16;  // depth of Q . K^T
  static constexpr int NB = (DP + 63) / 64;       // 64-column boxes of a row
  static constexpr int KSTEPS = DP / 16;
  static constexpr int Q_BOX = WG_BQ * BOX_ROW;
  static constexpr int KV_BOX = WG_BK * BOX_ROW;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int TILE = NB * KV_BOX;  // one K or V tile
  static constexpr int FIXED = Q_BYTES + 1024 + BARS_BYTES;  // + alignment slack
  static constexpr int STAGES = (SMEM_LIMIT - FIXED) / (2 * TILE) < MAX_STAGES
                                    ? (SMEM_LIMIT - FIXED) / (2 * TILE)
                                    : MAX_STAGES;
  static constexpr int SMEM = FIXED + 2 * STAGES * TILE;
  static_assert(STAGES >= 2, "K1 needs two stages in each ring");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using S = FwdWg<DV>;
  constexpr int NB = S::NB, ST = S::STAGES;
  constexpr int NX = WG_BK / 2;   // S accumulator registers: 16 n8 chunks of 4
  constexpr int PK = WG_BK / 16;  // k16 steps of P . V
  extern __shared__ uint8_t fwd_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fwd_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Qs = smem;
  uint8_t* k_ring = Qs + S::Q_BYTES;
  uint8_t* v_ring = k_ring + ST * S::TILE;
  uint8_t* bars = v_ring + ST * S::TILE;
  // mbarriers: Q, then full and empty of each K stage and each V stage
  const uint32_t q_bar = smem_u32(bars);
  const uint32_t k_full = q_bar + 8, k_empty = k_full + 8 * MAX_STAGES;
  const uint32_t v_full = k_empty + 8 * MAX_STAGES, v_empty = v_full + 8 * MAX_STAGES;
  // beside each K stage: the tile's first key (-1: the end), its valid keys
  // as four 32-bit words, and whether all 128 are valid
  volatile int* tile_s = reinterpret_cast<volatile int*>(bars + 8 + 32 * MAX_STAGES);
  volatile uint32_t* words_s =
      reinterpret_cast<volatile uint32_t*>(bars + 8 + 36 * MAX_STAGES);  // [ST][4]
  volatile int* dense_s = reinterpret_cast<volatile int*>(bars + 8 + 52 * MAX_STAGES);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * WG_BQ;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: warp 0 walks the kv tiles, skipping those with no valid key;
    // its lane 0 issues every TMA load, K then V of each tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(q_bar, S::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(smem_u32(Qs + c * S::Q_BOX), &tm_q, q_bar, 64 * c, q0, h, b);
    }
    const int n_tiles = (p.Skv + WG_BK - 1) / WG_BK;
    int i = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * WG_BK;
      uint32_t w[4];
      bool any = false, dense = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = __ballot_sync(0xffffffffu, key_valid(mg, k0 + 32 * j + lane, p.Skv));
        any = any || w[j] != 0u;
        dense = dense && w[j] == 0xffffffffu;
      }
      // a tile with no valid key is skipped, but one tile always goes: the
      // consumers' first turn has a tile (all masked: its rows end at 0)
      if (!any && (i > 0 || kt + 1 < n_tiles)) continue;
      const int s = i % ST, parity = ((i / ST) & 1) ^ 1;
      if (lane == 0) {
        mbar_wait(k_empty + 8 * s, parity);
#pragma unroll
        for (int j = 0; j < 4; ++j) words_s[4 * s + j] = w[j];
        dense_s[s] = dense;
        tile_s[s] = k0;
        mbar_expect_tx(k_full + 8 * s, S::TILE);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(smem_u32(k_ring + s * S::TILE + c * S::KV_BOX), &tm_k, k_full + 8 * s,
                      64 * c, k0, h, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, S::TILE);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(smem_u32(v_ring + s * S::TILE + c * S::KV_BOX), &tm_v, v_full + 8 * s,
                      64 * c, k0, h, b);
      }
      ++i;
    }
    if (lane == 0) {
      const int s = i % ST;
      mbar_wait(k_empty + 8 * s, ((i / ST) & 1) ^ 1);
      tile_s[s] = -1;
      mbar_arrive(k_full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int my_turn = BAR_TURN + wg, other_turn = BAR_TURN + 1 - wg;
  if (wg == 1) named_arrive(BAR_TURN);  // warpgroup 0 takes the first turn
  const uint32_t qa = smem_u32(Qs) + wg * 64 * BOX_ROW;
  const float scale_log2 = p.scale * LOG2E;

  float o[DV / 2];
#pragma unroll
  for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
  float x[NX];  // S, then P in fp32: chunk i holds rows g, g + 8 x keys 8i + 2t, +1
#pragma unroll
  for (int e = 0; e < NX; ++e) x[e] = 0.f;
  uint32_t pf[PK][4];  // P rounded to bf16: the A fragments of P . V
  // rows g and g + 8: running max (log2 domain), this lane's share of the
  // running sum, and the factor O still owes the last max move
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};

  // Every wgmma below is issued on a straight path (no branch around it),
  // so ptxas need not serialise them.
  auto issue_s = [&](int s) {  // S = Q . K^T of the tile in K stage s
    const uint32_t kb = smem_u32(k_ring + s * S::TILE);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < S::KSTEPS; ++j)
      wgmma_ss_n128(x, smem_desc(qa + (j / 4) * S::Q_BOX) + 2 * (j % 4),
                    smem_desc(kb + (j / 4) * S::KV_BOX) + 2 * (j % 4), j > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {  // O = O * alpha + P . V of the tile in V stage s
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    const uint32_t vb = smem_u32(v_ring + s * S::TILE);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PK; ++j)
      wgmma_rs_tb<DV>(o, pf[j], smem_desc_mn_atoms(vb + j * 16 * BOX_ROW, S::KV_BOX));
    wgmma_commit();
  };
  // this lane's view of a K stage's valid keys: bit 8 (i % 4) + (e & 1) of
  // wt[i / 4] is key 8i + 2t + (e & 1), read before the stage is released
  bool dense;
  uint32_t wt[4];
  auto read_keys = [&](int s) {
    dense = dense_s[s];
#pragma unroll
    for (int j = 0; j < 4; ++j) wt[j] = words_s[4 * s + j] >> (2 * t);
  };
  auto release = [&](uint32_t empty) {
    if (lane == 0) mbar_arrive(empty);
  };
  // online softmax of S in the log2 domain; masked keys and keys past Skv
  // get -1e30; leaves P in x and this tile's factor in alpha
  auto softmax = [&]() {
    float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f};
    if (dense) {
#pragma unroll
      for (int e = 0; e < NX; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        x[e] = ex2(fmaf(x[e], scale_log2, -m[(e >> 1) & 1]));
        sum[(e >> 1) & 1] += x[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        const bool valid = (wt[e / 16] >> (8 * ((e / 4) % 4) + (e & 1))) & 1u;
        x[e] = valid ? x[e] * scale_log2 : NEG_INF;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        x[e] = ex2(x[e] - m[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += x[e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  };

  // first turn: S of the first tile (the producer always delivers one)
  mbar_wait(q_bar, 0);
  mbar_wait(k_full, 0);
  read_keys(0);
  named_sync(my_turn);
  issue_s(0);
  named_arrive(other_turn);
  wgmma_wait<0>();
  fence_regs(x);
  release(k_empty);
  softmax();
  to_a_frag<PK>(pf, x);
  int prev = 0;  // the stage of the previous tile, whose P . V comes next turn
  int i = 1;      // tiles seen
  for (;; ++i) {
    const int s = i % ST;
    mbar_wait(k_full + 8 * s, (i / ST) & 1);
    if (tile_s[s] < 0) break;
    read_keys(s);
    mbar_wait(v_full + 8 * prev, ((i - 1) / ST) & 1);
    // one turn: S of this tile, then P . V of the previous one
    named_sync(my_turn);
    issue_s(s);
    issue_pv(prev);
    named_arrive(other_turn);
    wgmma_wait<1>();  // S: this K stage is free
    fence_regs(x);
    release(k_empty + 8 * s);
    softmax();
    wgmma_wait<0>();  // the previous tile's P . V: its V stage and pf are free
    fence_regs(o);
    fence_regs(pf);
    release(v_empty + 8 * prev);
    to_a_frag<PK>(pf, x);
    prev = s;
  }
  // closing turn: P . V of the last tile; warpgroup 1 gives no turn after
  // it, so the turns stay balanced
  mbar_wait(v_full + 8 * prev, ((i - 1) / ST) & 1);
  named_sync(my_turn);
  issue_pv(prev);
  if (wg == 0) named_arrive(other_turn);
  wgmma_wait<0>();
  fence_regs(o);

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_row[r] = quad_sum(l[r]);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[r] > NEG_INF * 0.5f;
    const float inv_l = seen_valid ? 1.f / l_row[r] : 0.f;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] * inv_l, o[4 * i + 2 * r + 1] * inv_l);
    }
    if (t == 0)
      p.lse[(long long)bh * p.Sq + row] =
          seen_valid ? (m[r] + log2f(l_row[r])) * LN2 : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// K2 bf16 (ROPE = true) and K1 bf16 at D = 256 (ROPE = false): mma.sync at
// head dims up to 256, K2 rotating K in shared memory
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

template <int DP, bool ROPE>
__global__ void __launch_bounds__(TC_WARPS * 32, 2) flash_wide_bf16_kernel(const Params p) {
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

    if constexpr (ROPE) {
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
    }

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

// ---------------------------------------------------------------------------
// K4: K2 with the memory K/V projections fused in (one head, D = 256)
// ---------------------------------------------------------------------------

constexpr int KP_D = 256;                // the memory-attention width (d_model)
constexpr int KP_WARPS = 8;
constexpr int KP_THREADS = KP_WARPS * 32;
constexpr int KP_BQ = 16 * KP_WARPS;     // query rows per CTA (both routes)
constexpr int KP_BK = 32;                // keys per kv tile (both routes)
constexpr int KF_LDQ = KP_BQ + 4;        // fp32: row stride of the d-major Q and P^T tiles
constexpr int KF_LDK = KP_BK + 4;        // fp32: row stride of the d-major K tile

template <int DM>
constexpr int smem_bytes_kvproj_bf16() {
  // Q [128][264] + Wk, Wv [256][DM+8] + K, V [32][264] + raw {mem_k, mem_v}
  // x 2 stages [32][DM+8], bf16; bk, bv [256] fp32
  return (KP_BQ * tc_ld(KP_D) + 2 * KP_D * (DM + 8) + 2 * KP_BK * tc_ld(KP_D) +
          4 * KP_BK * (DM + 8)) * static_cast<int>(sizeof(__nv_bfloat16)) +
         2 * KP_D * static_cast<int>(sizeof(float));
}

template <int DM>
constexpr int smem_bytes_kvproj_f32() {
  // Qt [256][132] + Kt [256][36] (P^T [32][132] after S) + V [32][256] + raw
  // {mem_k, mem_v} [32][DM] + bk, bv [256], fp32
  return (KP_D * KF_LDQ + KP_D * KF_LDK + KP_BK * KP_D + 2 * KP_BK * DM + 2 * KP_D) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int DM>
__global__ void __launch_bounds__(KP_THREADS, 1) flash_kvproj_bf16_kernel(const Params p) {
  constexpr int D = KP_D;
  constexpr int LDK = tc_ld(D);     // row stride of Q, K and V tiles
  constexpr int LDM = DM + 8;       // row stride of the weights and raw tiles (odd x 16 bytes)
  constexpr int KS = D / 16;        // k-steps of Q . K^T
  constexpr int ND = D / 8;         // 8-column slices of the output
  constexpr int NT = KP_BK / 8;     // 8-key slices of S
  constexpr int MKS = DM / 16;      // k-steps of the projections
  constexpr int HALF = D / 2;
  constexpr int CHUNKS = D / 8, MCHUNKS = DM / 8;  // 16-byte chunks per row
  constexpr int RAW = KP_BK * LDM;
  extern __shared__ __align__(16) __nv_bfloat16 kp_smem[];
  __nv_bfloat16* Qs = kp_smem;                // [KP_BQ][LDK]
  __nv_bfloat16* Wks = Qs + KP_BQ * LDK;      // [D][LDM]
  __nv_bfloat16* Wvs = Wks + D * LDM;         // [D][LDM]
  __nv_bfloat16* Ks = Wvs + D * LDM;          // [KP_BK][LDK] projected, rotated K
  __nv_bfloat16* Vs = Ks + KP_BK * LDK;       // [KP_BK][LDK] projected V
  __nv_bfloat16* Ms = Vs + KP_BK * LDK;       // [2 stages][{k, v}][KP_BK][LDM]
  float* bks = reinterpret_cast<float*>(Ms + 4 * RAW);  // [D]
  float* bvs = bks + D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  const int b = blockIdx.y;               // one head: (b, h) = (b, 0)
  const int q_tile = blockIdx.x * KP_BQ;
  const int q0 = q_tile + warp * 16;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  const __nv_bfloat16* mkg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb;
  const __nv_bfloat16* mvg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb;
  const __nv_bfloat16* wkg = static_cast<const __nv_bfloat16*>(p.wk);
  const __nv_bfloat16* wvg = static_cast<const __nv_bfloat16*>(p.wv);
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.cos);
  const __nv_bfloat16* sg = static_cast<const __nv_bfloat16*>(p.sin);
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;

  // the Q tile (rows past Sq zero-filled) and both weight matrices ride in
  // the first copy group; the biases are plain stores, visible after the
  // first barrier of the loop
  for (int idx = threadIdx.x; idx < KP_BQ * CHUNKS; idx += blockDim.x) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    const bool in = q_tile + r < p.Sq;
    const long long row = in ? q_tile + r : 0;
    cp_async_16(Qs + r * LDK + c, qg + row * p.q_ss + c, in);
  }
  for (int idx = threadIdx.x; idx < D * MCHUNKS; idx += blockDim.x) {
    const int r = idx / MCHUNKS, c = (idx % MCHUNKS) * 8;
    cp_async_16(Wks + r * LDM + c, wkg + r * DM + c, true);
    cp_async_16(Wvs + r * LDM + c, wvg + r * DM + c, true);
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    bks[i] = p.bk[i];
    bvs[i] = p.bv[i];
  }
  auto load_raw = [&](int tile, int stage) {
    const int k0 = tile * KP_BK;
    for (int idx = threadIdx.x; idx < KP_BK * MCHUNKS; idx += blockDim.x) {
      const int r = idx / MCHUNKS, c = (idx % MCHUNKS) * 8;
      const bool in = k0 + r < p.Skv;  // rows past Skv are zero-filled
      const long long row = in ? k0 + r : 0;
      cp_async_16(Ms + 2 * stage * RAW + r * LDM + c, mkg + row * p.k_ss + c, in);
      cp_async_16(Ms + (2 * stage + 1) * RAW + r * LDM + c, mvg + row * p.v_ss + c, in);
    }
  };
  const int n_tiles = (p.Skv + KP_BK - 1) / KP_BK;
  const int per_split = (n_tiles + p.n_split - 1) / p.n_split;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);
  if (t_begin < t_end) load_raw(t_begin, 0);
  cp_async_commit();

  const float scale_log2 = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // ldmatrix lane offsets: an A operand (16 rows x 16) and a pair of B
  // operands (two 8-row slices x 16) from row-major [row][k] tiles
  const int a_off = (lane & 15) * LDM + 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  const __nv_bfloat16* qfrag = Qs + (warp * 16 + (lane & 15)) * LDK + 8 * (lane >> 4);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int stage = (tile - t_begin) & 1;
    // the other stage was last read by the previous tile's projection,
    // which every warp finished before that tile's second barrier
    if (tile + 1 < t_end) load_raw(tile + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this tile
    cp_async_wait_newest_pending();
    const int k0 = tile * KP_BK;
    // the barrier after which this tile's copies are visible and every warp
    // is done reading the previous K and V tiles; a tile with no valid key
    // is skipped (exact, as in K2)
    if (!__syncthreads_or(threadIdx.x < KP_BK && key_valid(mg, k0 + threadIdx.x, p.Skv)))
      continue;
    const __nv_bfloat16* mk_s = Ms + 2 * stage * RAW;
    const __nv_bfloat16* mv_s = mk_s + RAW;

    {  // K = rotate(round(mem_k . Wk^T + bk)): this warp's channels
       // 16w..16w+15 (n-tiles 0, 1) and their rotation partners D/2 + 16w..
       // (n-tiles 2, 3), all 32 keys (two 16-key m-tiles)
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MKS; ++ks) {
        uint32_t blo[4], bhi[4];
        ldmatrix_x4(blo, Wks + (16 * warp + b_row) * LDM + 16 * ks + b_col);
        ldmatrix_x4(bhi, Wks + (HALF + 16 * warp + b_row) * LDM + 16 * ks + b_col);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, mk_s + 16 * mt * LDM + a_off + 16 * ks);
          mma_bf16(acc[mt][0], a, blo[0], blo[1]);
          mma_bf16(acc[mt][1], a, blo[2], blo[3]);
          mma_bf16(acc[mt][2], a, bhi[0], bhi[1]);
          mma_bf16(acc[mt][3], a, bhi[2], bhi[3]);
        }
      }
      // bias in fp32, one rounding to bf16, then K2's rotation (fp32 from
      // the bf16 values, one rounding); rows past Skv stay zero
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int key = 16 * mt + g + 8 * hr;
            const int d = 16 * warp + 8 * j + 2 * t;
            __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f), hi = lo;
            if (k0 + key < p.Skv) {
              const float k1x = round_bf16(acc[mt][j][2 * hr] + bks[d]);
              const float k1y = round_bf16(acc[mt][j][2 * hr + 1] + bks[d + 1]);
              const float k2x = round_bf16(acc[mt][j + 2][2 * hr] + bks[HALF + d]);
              const float k2y = round_bf16(acc[mt][j + 2][2 * hr + 1] + bks[HALF + d + 1]);
              const long long trow = static_cast<long long>(k0 + key) * HALF + d;
              const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cg + trow));
              const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sg + trow));
              lo = __floats2bfloat162_rn(rot_lo(k1x, k2x, c.x, s.x), rot_lo(k1y, k2y, c.y, s.y));
              hi = __floats2bfloat162_rn(rot_hi(k1x, k2x, c.x, s.x), rot_hi(k1y, k2y, c.y, s.y));
            }
            *reinterpret_cast<__nv_bfloat162*>(Ks + key * LDK + d) = lo;
            *reinterpret_cast<__nv_bfloat162*>(Ks + key * LDK + HALF + d) = hi;
          }
    }
    {  // V = round(mem_v . Wv^T + bv): this warp's channels 32w..32w+31
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MKS; ++ks) {
        uint32_t b0[4], b1[4];
        ldmatrix_x4(b0, Wvs + (32 * warp + b_row) * LDM + 16 * ks + b_col);
        ldmatrix_x4(b1, Wvs + (32 * warp + 16 + b_row) * LDM + 16 * ks + b_col);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, mv_s + 16 * mt * LDM + a_off + 16 * ks);
          mma_bf16(acc[mt][0], a, b0[0], b0[1]);
          mma_bf16(acc[mt][1], a, b0[2], b0[3]);
          mma_bf16(acc[mt][2], a, b1[0], b1[1]);
          mma_bf16(acc[mt][3], a, b1[2], b1[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int key = 16 * mt + g + 8 * hr;
            const int ch = 32 * warp + 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(Vs + key * LDK + ch) = __floats2bfloat162_rn(
                acc[mt][j][2 * hr] + bvs[ch], acc[mt][j][2 * hr + 1] + bvs[ch + 1]);
          }
    }
    __syncthreads();  // the K and V tiles are complete

    // S = Q . K^T: [16 rows][32 keys] per warp, fp32 (K2's)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kfrag = Ks + b_row * LDK + b_col;
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
    for (int kk = 0; kk < KP_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = Vs + (16 * kk + (lane & 15)) * LDK + 8 * (lane >> 4);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + 8 * nd);
        mma_bf16(o[nd], pa, vb[0], vb[1]);
        mma_bf16(o[nd + 1], pa, vb[2], vb[3]);
      }
    }
    // no barrier here: the next tile's first barrier comes before its
    // projection overwrites K and V
  }
  cp_async_wait_all();  // a split with no tile still has its Q and weight copies in flight

  const long long part = static_cast<long long>(blockIdx.z) * p.B + b;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb;
  float* po = p.part_o + part * p.Sq * D;  // used when the kv axis is split
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
        *reinterpret_cast<float2*>(po + row * D + 8 * nd + 2 * t) =
            make_float2(o[nd][2 * i] * inv_l, o[nd][2 * i + 1] * inv_l);
      if (t == 0) p.part_lse[part * p.Sq + row] = lse;
    } else {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + 8 * nd + 2 * t) =
            __floats2bfloat162_rn(o[nd][2 * i] * inv_l, o[nd][2 * i + 1] * inv_l);
      if (t == 0) p.lse[static_cast<long long>(b) * p.Sq + row] = lse;
    }
  }
}

// fp32: K2's FMA scheme at 128 query rows x 32 keys. Thread (ty, tx) owns
// query rows 4ty..4ty+3, keys 4tx..4tx+3 of S and output columns tx + 8c.
template <int DM>
__global__ void __launch_bounds__(KP_THREADS, 1) flash_kvproj_f32_kernel(const Params p) {
  constexpr int D = KP_D, HALF = D / 2;
  constexpr int NC = D / 8;  // output columns per thread
  extern __shared__ __align__(16) float kf_smem[];
  float* Qt = kf_smem;               // [D][KF_LDQ]  Q tile, d-major
  float* Kt = Qt + D * KF_LDQ;       // [D][KF_LDK]  K tile, d-major
  float* Pt = Kt;                    // [KP_BK][KF_LDQ]  P^T, reuses the K tile
  float* Vs = Kt + D * KF_LDK;       // [KP_BK][D]  V tile, row-major
  float* Mk = Vs + KP_BK * D;        // [KP_BK][DM] raw memory tokens
  float* Mv = Mk + KP_BK * DM;
  float* bks = Mv + KP_BK * DM;      // [D]
  float* bvs = bks + D;

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * KP_BQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb;
  const float* mkg = static_cast<const float*>(p.k) + b * p.k_sb;
  const float* mvg = static_cast<const float*>(p.v) + b * p.v_sb;
  const float* cg = static_cast<const float*>(p.cos);
  const float* sg = static_cast<const float*>(p.sin);
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;

  for (int idx = tid; idx < KP_BQ * D; idx += KP_THREADS) {
    const int r = idx / D, d = idx % D;
    Qt[d * KF_LDQ + r] = q0 + r < p.Sq ? qg[(q0 + r) * p.q_ss + d] : 0.f;
  }
  for (int i = tid; i < D; i += KP_THREADS) {
    bks[i] = p.bk[i];
    bvs[i] = p.bv[i];
  }
  // projection roles: warps 0-3 project K, warps 4-7 V; thread c of each
  // half owns channels c and c + D/2 (for K, a rotation pair)
  const bool proj_k = tid < HALF;
  const int pc = tid & (HALF - 1);
  const float* w_lo = static_cast<const float*>(proj_k ? p.wk : p.wv) + pc * DM;
  const float* w_hi = w_lo + HALF * DM;
  const float* bias = proj_k ? bks : bvs;
  const float* raw = proj_k ? Mk : Mv;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (p.Skv + KP_BK - 1) / KP_BK;
  const int per_split = (n_tiles + p.n_split - 1) / p.n_split;
  const int t_end = min(n_tiles, (static_cast<int>(blockIdx.z) + 1) * per_split);
  for (int tile = blockIdx.z * per_split; tile < t_end; ++tile) {
    const int k0 = tile * KP_BK;
    // the raw tiles (rows past Skv zero); the previous tile's projection
    // finished reading them before its second barrier
    for (int idx = tid; idx < KP_BK * DM / 4; idx += KP_THREADS) {
      const int r = idx / (DM / 4), c = (idx % (DM / 4)) * 4;
      const bool in = k0 + r < p.Skv;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Mk + r * DM + c) =
          in ? *reinterpret_cast<const float4*>(mkg + (k0 + r) * p.k_ss + c) : zero;
      *reinterpret_cast<float4*>(Mv + r * DM + c) =
          in ? *reinterpret_cast<const float4*>(mvg + (k0 + r) * p.v_ss + c) : zero;
    }
    // the barrier after which the raw tiles are visible and the previous
    // tile's P^T and V reads are done; a tile with no valid key is skipped
    if (!__syncthreads_or(tid < KP_BK && key_valid(mg, k0 + tid, p.Skv))) continue;

    // projections, 16 keys at a time: fp32 sums in order of the input
    // channel, the bias added in fp32; K rotated as K2 rotates it
#pragma unroll 1
    for (int kh = 0; kh < KP_BK; kh += 16) {
      float a_lo[16], a_hi[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) a_lo[r] = a_hi[r] = 0.f;
#pragma unroll 2
      for (int j = 0; j < DM; j += 4) {
        const float4 wl = __ldg(reinterpret_cast<const float4*>(w_lo + j));
        const float4 wh = __ldg(reinterpret_cast<const float4*>(w_hi + j));
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(raw + (kh + r) * DM + j);
          a_lo[r] = fmaf(x.w, wl.w, fmaf(x.z, wl.z, fmaf(x.y, wl.y, fmaf(x.x, wl.x, a_lo[r]))));
          a_hi[r] = fmaf(x.w, wh.w, fmaf(x.z, wh.z, fmaf(x.y, wh.y, fmaf(x.x, wh.x, a_hi[r]))));
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int key = kh + r;
        const float k1 = a_lo[r] + bias[pc], k2 = a_hi[r] + bias[pc + HALF];
        if (proj_k) {
          float lo = 0.f, hi = 0.f;
          if (k0 + key < p.Skv) {
            const long long trow = static_cast<long long>(k0 + key) * HALF + pc;
            const float c = cg[trow], s = sg[trow];
            lo = rot_lo(k1, k2, c, s);
            hi = rot_hi(k1, k2, c, s);
          }
          Kt[pc * KF_LDK + key] = lo;
          Kt[(pc + HALF) * KF_LDK + key] = hi;
        } else {
          Vs[key * D + pc] = k1;
          Vs[key * D + pc + HALF] = k2;
        }
      }
    }
    __syncthreads();  // the K and V tiles are complete

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * KF_LDQ + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * KF_LDK + tx * 4]);
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
      float m_cur = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      // the 8 lanes sharing a query row are one aligned group of the warp
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * KF_LDQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KP_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[kk * KF_LDQ + ty * 4]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * D + tx + 8 * c];
        acc[0][c] = fmaf(a.x, vv, acc[0][c]);
        acc[1][c] = fmaf(a.y, vv, acc[1][c]);
        acc[2][c] = fmaf(a.z, vv, acc[2][c]);
        acc[3][c] = fmaf(a.w, vv, acc[3][c]);
      }
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb;
  long long o_ss = p.o_ss;
  float* lse_out = p.lse + static_cast<long long>(b) * p.Sq;
  if (p.n_split > 1) {  // this split's partial result
    const long long part = static_cast<long long>(blockIdx.z) * p.B + b;
    og = p.part_o + part * p.Sq * D;
    o_ss = D;
    lse_out = p.part_lse + part * p.Sq;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[i] > NEG_INF * 0.5f;
#pragma unroll
    for (int c = 0; c < NC; ++c) og[row * o_ss + tx + 8 * c] = seen_valid ? acc[i][c] / l[i] : 0.f;
    if (tx == 0) lse_out[row] = seen_valid ? m[i] + logf(l[i]) : NEG_INF;
  }
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Merges the kv splits of K2, K4 and K1 at D = 256: out = sum_s
// exp(lse_s - lse) * out_s with lse = log sum_s exp(lse_s); a split that saw
// no valid key has lse_s = -1e30 and weight 0; a row with none at all gets 0
// and -1e30. One CTA per (query row, b*h), one thread per output column.
template <typename T>
__global__ void __launch_bounds__(128) flash_combine_kernel(const Params p) {
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
cudaError_t launch_f32_dp(const Params& p, cudaStream_t stream) {
  return launch(flash_fwd_f32_kernel<DP>, smem_bytes_f32<DP>(), BQ, THREADS, p, stream);
}

// K1 bf16 at D <= 128: the tensor maps of q, k and v, then the kernel
template <int DV>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, p.q, p.B, p.H, p.Sq, p.D, p.q_sb, p.q_sh, p.q_ss, WG_BQ) ||
      !make_map(&mk, p.k, p.B, p.H, p.Skv, p.D, p.k_sb, p.k_sh, p.k_ss, WG_BK) ||
      !make_map(&mv, p.v, p.B, p.H, p.Skv, p.D, p.v_sb, p.v_sh, p.v_ss, WG_BK))
    return cudaErrorInvalidValue;
  constexpr int smem = FwdWg<DV>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + WG_BQ - 1) / WG_BQ, p.B * p.H);
  flash_fwd_wgmma_kernel<DV><<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// P . V runs at N = D where D is 56, 72 (hiera-b+'s and hiera-L's global
// blocks) or a multiple of 16; other D at D padded to 16
cudaError_t dispatch_wgmma(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 56: return launch_wgmma<56>(p, stream);
    case 72: return launch_wgmma<72>(p, stream);
    default: break;
  }
  switch ((p.D + 15) / 16) {
    case 1: return launch_wgmma<16>(p, stream);
    case 2: return launch_wgmma<32>(p, stream);
    case 3: return launch_wgmma<48>(p, stream);
    case 4: return launch_wgmma<64>(p, stream);
    case 5: return launch_wgmma<80>(p, stream);
    case 6: return launch_wgmma<96>(p, stream);
    case 7: return launch_wgmma<112>(p, stream);
    case 8: return launch_wgmma<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// After a kv-split launch (K1 at D = 256, K2, K4): the combine kernel on the
// same stream.
cudaError_t launch_combine(cudaError_t err, bool bf16, const Params& p, cudaStream_t stream) {
  if (err != cudaSuccess || p.n_split == 1) return err;
  const dim3 grid(p.Sq, p.B * p.H);
  if (bf16)
    flash_combine_kernel<__nv_bfloat16><<<grid, 128, 0, stream>>>(p);
  else
    flash_combine_kernel<float><<<grid, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

// K1 at D = 256: K2's kernels without the rotation, kv split as K2's.
cudaError_t launch_k1_wide(bool bf16, const Params& p, cudaStream_t stream) {
  return launch_combine(
      bf16 ? launch(flash_wide_bf16_kernel<256, false>, smem_bytes_rope_bf16<256>(), TC_BQ,
                    TC_WARPS * 32, p, stream)
           : launch(flash_fwd_f32_kernel<256>, smem_bytes_f32<256>(), BQ, THREADS, p, stream),
      bf16, p, stream);
}

cudaError_t dispatch(bool bf16, const Params& p, cudaStream_t stream) {
  if (p.D == 256) return launch_k1_wide(bf16, p, stream);
  if (bf16) return dispatch_wgmma(p, stream);
  switch ((p.D + 15) / 16) {
    case 1: return launch_f32_dp<16>(p, stream);
    case 2: return launch_f32_dp<32>(p, stream);
    case 3: return launch_f32_dp<48>(p, stream);
    case 4: return launch_f32_dp<64>(p, stream);
    case 5: return launch_f32_dp<80>(p, stream);
    case 6: return launch_f32_dp<96>(p, stream);
    case 7: return launch_f32_dp<112>(p, stream);
    case 8: return launch_f32_dp<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_rope_dp(bool bf16, const Params& p, cudaStream_t stream) {
  return launch_combine(
      bf16 ? launch(flash_wide_bf16_kernel<DP, true>, smem_bytes_rope_bf16<DP>(), TC_BQ,
                    TC_WARPS * 32, p, stream)
           : launch(flash_rope_f32_kernel<DP>, smem_bytes_f32<DP>(), BQ, THREADS, p, stream),
      bf16, p, stream);
}

template <int DM>
cudaError_t launch_kvproj_dm(bool bf16, const Params& p, cudaStream_t stream) {
  return launch_combine(
      bf16 ? launch(flash_kvproj_bf16_kernel<DM>, smem_bytes_kvproj_bf16<DM>(), KP_BQ,
                    KP_THREADS, p, stream)
           : launch(flash_kvproj_f32_kernel<DM>, smem_bytes_kvproj_f32<DM>(), KP_BQ,
                    KP_THREADS, p, stream),
      bf16, p, stream);
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
  return bf16 ? ctas_per_sm(flash_wide_bf16_kernel<DP, true>, smem_bytes_rope_bf16<DP>(),
                            TC_WARPS * 32)
              : ctas_per_sm(flash_rope_f32_kernel<DP>, smem_bytes_f32<DP>(), THREADS);
}

int k1_wide_ctas_per_sm(bool bf16) {
  return bf16 ? ctas_per_sm(flash_wide_bf16_kernel<256, false>, smem_bytes_rope_bf16<256>(),
                            TC_WARPS * 32)
              : ctas_per_sm(flash_fwd_f32_kernel<256>, smem_bytes_f32<256>(), THREADS);
}

template <int DM>
int kvproj_ctas_per_sm(bool bf16) {
  return bf16 ? ctas_per_sm(flash_kvproj_bf16_kernel<DM>, smem_bytes_kvproj_bf16<DM>(), KP_THREADS)
              : ctas_per_sm(flash_kvproj_f32_kernel<DM>, smem_bytes_kvproj_f32<DM>(), KP_THREADS);
}

// The most kv splits that keep the grid in one wave of resident CTAs
// (`per_sm` of them on each SM), at least 8 kv tiles each.
int kv_splits(int per_sm, int rows, int tile, int B, int H, int Sq, int Skv) {
  int dev = 0, n_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long ctas = static_cast<long long>((Sq + rows - 1) / rows) * B * H;
  const long long n_tiles = (Skv + tile - 1) / tile;
  long long n = static_cast<long long>(per_sm) * n_sm / ctas;
  if (n > n_tiles / 8) n = n_tiles / 8;
  return static_cast<int>(n < 1 ? 1 : n);
}

cudaError_t dispatch_rope(bool bf16, const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 64: return launch_rope_dp<64>(bf16, p, stream);
    case 128: return launch_rope_dp<128>(bf16, p, stream);
    case 256: return launch_rope_dp<256>(bf16, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_kvproj(bool bf16, const Params& p, cudaStream_t stream) {
  switch (p.Dm) {
    case 32: return launch_kvproj_dm<32>(bf16, p, stream);
    case 64: return launch_kvproj_dm<64>(bf16, p, stream);
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
      (rope ? (cos == nullptr || sin == nullptr) : (D != 256 && (D > 128 || n_split != 1))))
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
  p.wk = p.wv = nullptr;
  p.bk = p.bv = nullptr;
  p.Dm = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rope ? dispatch_rope(dtype == 1, p, st) : dispatch(dtype == 1, p, st));
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 = cudaSuccess).
// dtype: 0 fp32, 1 bf16.

// K1: D a multiple of 8 up to 128 (n_split 1), or D = 256, where the kv
// axis may be split as K2's (part_o / part_lse as below).
extern "C" int sam2_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* part_o,
    void* part_lse, void* o, void* lse, int dtype, int B, int H, int Sq, int Skv, int D,
    int n_split,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  return run(false, q, k, v, mask, nullptr, nullptr, part_o, part_lse, o, lse, dtype, B, H, Sq,
             Skv, D, n_split, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
             o_ss, mask_sb, scale, stream);
}

// K1's kv split for these shapes on the current device: 1 up to D = 128,
// K2's rule at D = 256; -1 for an unsupported D.
extern "C" int sam2_flash_attention_splits(int dtype, int B, int H, int Sq, int Skv, int D) {
  const bool bf16 = dtype == 1;
  if (D != 256) return D > 0 && D <= 128 && D % 8 == 0 ? 1 : -1;
  return kv_splits(k1_wide_ctas_per_sm(bf16), bf16 ? TC_BQ : BQ, bf16 ? RP_BK : BK, B, H, Sq,
                   Skv);
}

// K1's tiling for a head dim: out[0] query rows per CTA, out[1] keys per kv
// tile, out[2] stages of the kv ring (bf16 at D <= 128: stages of each of the K
// and V rings).
extern "C" void sam2_flash_attention_tiling(int dtype, int D, int* out) {
  if (dtype == 1 && D <= 128) {
    out[0] = WG_BQ;
    out[1] = WG_BK;
    out[2] = D <= 64 ? FwdWg<64>::STAGES : FwdWg<128>::STAGES;
  } else if (dtype == 1) {
    out[0] = TC_BQ;
    out[1] = RP_BK;
    out[2] = 2;
  } else {
    out[0] = BQ;
    out[1] = BK;
    out[2] = 1;
  }
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
  return kv_splits(per_sm, bf16 ? TC_BQ : BQ, bf16 ? RP_BK : BK, B, H, Sq, Skv);
}

// K4: K2 with the K/V projections fused in; one head, D = 256, Dm in
// {32, 64}. q [B, 1, Sq, D] (rotated) with batch / row strides; mem_k, mem_v
// [B, Skv, Dm] with batch / row strides (unit stride along Dm; bf16 rows
// 16-byte aligned, fp32 rows 16-byte aligned); wk, wv [D, Dm] contiguous in
// q's dtype; bk, bv [D] fp32; cos/sin [Skv, D/2] in q's dtype, contiguous;
// out [B, Sq, D] with batch / row strides, lse [B, Sq]. The kv split and its
// scratch are as K2's (part_o [n_split, B, Sq, D], part_lse [n_split, B, Sq]).
extern "C" int sam2_flash_attention_kvproj_fwd(
    const void* q, const void* mem_k, const void* mem_v, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* mask, const void* cos, const void* sin,
    void* part_o, void* part_lse, void* o, void* lse, int dtype, int B, int Sq, int Skv, int D,
    int Dm, int n_split,
    long long q_sb, long long q_ss, long long mk_sb, long long mk_ss,
    long long mv_sb, long long mv_ss, long long o_sb, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Skv <= 0 || D != KP_D || (Dm != 32 && Dm != 64) ||
      (dtype != 0 && dtype != 1) || n_split < 1 || n_split > 65535 ||
      (n_split > 1 && (part_o == nullptr || part_lse == nullptr)) || wk == nullptr ||
      wv == nullptr || bk == nullptr || bv == nullptr || cos == nullptr || sin == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = mem_k; p.v = mem_v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = cos; p.sin = sin;
  p.o = o; p.lse = static_cast<float*>(lse);
  p.n_split = n_split;
  p.part_o = static_cast<float*>(part_o); p.part_lse = static_cast<float*>(part_lse);
  p.wk = wk; p.wv = wv;
  p.bk = static_cast<const float*>(bk); p.bv = static_cast<const float*>(bv);
  p.B = B; p.H = 1; p.Sq = Sq; p.Skv = Skv; p.D = D; p.Dm = Dm;
  p.q_sb = q_sb; p.q_sh = 0; p.q_ss = q_ss;
  p.k_sb = mk_sb; p.k_sh = 0; p.k_ss = mk_ss;
  p.v_sb = mv_sb; p.v_sh = 0; p.v_ss = mv_ss;
  p.o_sb = o_sb; p.o_sh = 0; p.o_ss = o_ss;
  p.mask_sb = mask_sb;
  p.scale = scale;
  return static_cast<int>(dispatch_kvproj(dtype == 1, p, static_cast<cudaStream_t>(stream)));
}

// K4's kv split for these shapes on the current device (K2's rule); -1 for
// an unsupported D or Dm.
extern "C" int sam2_flash_attention_kvproj_splits(int dtype, int B, int Sq, int Skv, int D,
                                                  int Dm) {
  const bool bf16 = dtype == 1;
  if (D != KP_D) return -1;
  int per_sm;
  switch (Dm) {
    case 32: per_sm = kvproj_ctas_per_sm<32>(bf16); break;
    case 64: per_sm = kvproj_ctas_per_sm<64>(bf16); break;
    default: return -1;
  }
  return kv_splits(per_sm, KP_BQ, KP_BK, B, 1, Sq, Skv);
}
