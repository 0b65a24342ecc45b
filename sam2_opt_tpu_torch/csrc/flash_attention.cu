// Masked flash-attention forward for Hopper (sm_90a), fp32 and bf16: the
// ports of three Pallas TPU kernels of sam2_opt_tpu/kernels/flash_attention.py,
// K1 (_kernel), K2 (_kernel_rope) and K4 (_kernel_rope_kvproj).
//
// K1 (sam2_flash_attention_fwd) replaces ::_kernel (with its online-softmax
// helpers _ns_init/_ns_update/_ns_finish). It computes exactly what K1
// computes:
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
// So every kernel here skips kv tiles with no valid key (the empty memory
// slots of the first tracked frames), which is exact.
//
// Layout. q/k/v are [B, H, S, D] with any batch/head/sequence strides and a
// unit stride along D (rows 16-byte aligned, which the wrapper checks); out
// has its own strides; lse is [B*H, Sq] fp32. The wrapper
// (sam2_opt_tpu_torch/kernels/flash_attention.py) allocates every output
// and scratch buffer; this file launches on the caller's stream and
// allocates nothing. Pallas' sequential kv grid axis becomes a loop inside
// the CTA: one CTA owns 128 query rows of one (b, h), walks the kv tiles,
// and keeps the running m, l and the [rows, D] accumulator in registers.
// Where one CTA per 128 query rows leaves SMs idle (memory attention: one
// head, 32 query tiles), the kv axis is split over blockIdx.z into as many
// ranges as keep the grid in one wave of resident CTAs (at least 8 kv tiles
// each, the occupancy API says how many CTAs fit): each split writes its
// normalized fp32 output and row LSE to scratch, and a combine kernel merges
// them (out = sum_s exp(lse_s - lse) out_s), a few MB against ~100 GFLOP.
//
// Bound. At hiera-L's global blocks (B*H = 8, Sq = Skv = 4096, D = 72) K1
// does 4*8*4096^2*72 = 38.7 GFLOP on 18.9 MB of bf16 q/k/v/out, 2000
// operations per byte; memory attention (one head, D = 256) does
// 4*4096*28736*256 = 120.5 GFLOP on 29 MB of bf16 K/V at the cross shape
// (7 memory frames of 4096 keys and 64 pointer tokens), 17.2 GFLOP at the
// self shape: compute-bound in both dtypes. The tensor cores' bounds:
// 0.039 / 0.122 ms in bf16 (989 TFLOP/s), 0.235 / 0.730 ms in fp32 as three
// TF32 products per product (495/3 TFLOP/s).
//  - bf16 runs warp-specialised wgmma fed by TMA (its section below), 128
//    query rows a CTA, so each CTA's stream of K and V from L2 is shared by
//    twice the rows of a 64-row tile. At D = 72 the tensor-core bound is
//    39 us and 8*4096^2 = 134M exponentials at 16 a clock per SM need 32 us
//    on their own, so one warpgroup's softmax runs while the other's
//    products do.
//  - fp32 runs the tensor cores as three TF32 products per fp32 product on
//    mma.sync (wgmma's tf32 form takes K-major operands only, and V is
//    MN-major in P . V), about 2^-21 of each product against fp32's 2^-24;
//    P never leaves the registers (its section below).
//
// K2 (sam2_flash_attention_rope_fwd) replaces ::_kernel_rope: K1 with K
// rotated in the split channel layout,
//   kr = [k1 * cos - k2 * sin, k1 * sin + k2 * cos]   (k1, k2: halves of D)
// by [Skv, D/2] tables (rows with cos = 1, sin = 0 leave the object-pointer
// tokens unrotated); q arrives rotated. It serves memory attention (D = 256,
// one head) at the self and cross shapes. K2 rotates K once per call, in a
// kernel of its own (flash_rope_rotate_kernel: fp32 from the inputs with one
// rounding per operation, no FMA, rounded once to K's dtype, as the plain
// version rotates, so the attention sees the same K bit for bit) into
// contiguous scratch the wrapper allocates, then runs K1's attention body on
// it under K2's own kernel names (flash_rope_*, so a profile tells K2's time
// from K1's), with K1's kv split and combine. Rotating inside the attention
// kernel would repeat the rotation and the table reads once per query tile
// (at the cross shape each of 32 tiles would rotate all 28,736 keys and read
// the 14.7 MB of bf16 tables), and would keep TMA from feeding wgmma (a box
// lands in shared memory without passing through registers). The rotation
// is bound by bytes: K read once, kr written once, each table row read once
// per call (44 MB in bf16 at the cross shape, 13 us at 3.35 TB/s; 88 MB and
// 26 us in fp32); kr (14.7 MB in bf16, 29 MB in fp32) then stays in the
// 50 MB L2 while the attention reads it. On an H100 80GB HBM3 at 700 W
// (chip_smoke.py, cold L2) K2 takes 0.343 ms in bf16 and 2.69 ms in fp32 at
// the cross shape, the rotation 0.023 and 0.037 ms of it.
//
// K4 (sam2_flash_attention_kvproj_fwd) replaces ::_kernel_rope_kvproj: K2
// with the memory cross-attention's K and V projections (mem_dim Dm = 64 ->
// D = 256) fused in. The kv stream is read Dm wide; each kv tile is
// projected on the SM,
//   kp = round(mem_k . Wk^T + bk),  vp = round(mem_v . Wv^T + bv)
// (fp32 sums, the bias added in fp32, one rounding to q's dtype), kp is
// rotated as K2 rotates K, and the tile goes through K1's masked flash
// softmax; the projected K/V never reach device memory. Weights are
// nn.Linear [D, Dm] in q's dtype, biases fp32 [D]. Bound at the cross shape
// (B = 1, 4096 queries, 28,736 keys): 4*4096*28736*256 + 2*2*28736*64*256 =
// 122.4 GFLOP (0.124 ms bf16, 1.83 ms fp32 on the CUDA cores), compute-bound.
// Each query tile re-projects every kv tile it reads, so the executed work is
// 120.5 GFLOP of attention plus (Sq / rows per CTA) x 1.88 GFLOP of
// projections. Design:
//  - 128 query rows per CTA (8 warps), so the projections add half the
//    attention's work (60 GFLOP at 32 query tiles), not all of it;
//  - bf16: mma.sync m16n8k16 with fp32 accumulation, 16 query rows a warp, S
//    re-packed in registers as the A operand of P V, operands through
//    ldmatrix. Wk and Wv (2 x 36 KB) stay resident in shared memory for the
//    CTA's life; the raw 32-key memory tiles stream through a 2-stage
//    cp.async ring. Each warp projects K for its 16 channels d of the first
//    half and the 16 channels d + D/2 of the second, so one thread holds
//    both halves of a rotation pair in its accumulators and rotates in
//    registers; V for its 32 channels. Q [128][264], Wk, Wv, K, V tiles and
//    the ring: 196 KB, one CTA per SM;
//  - fp32: FMAs on the CUDA cores at 128 rows x 32 keys per CTA (Q, K, P^T
//    and V in shared memory, 223 KB); each thread projects 2 channels of K
//    (a rotation pair) or V for the 32 keys, reading the weight rows through
//    L1/L2 (they do not fit beside the fp32 Q tile);
//  - K1's exact skip of kv tiles without a valid key, its -1e30 masking, the
//    identity rows for the pointer tokens (cos = 1, sin = 0) and the kv
//    split over blockIdx.z with the LSE combine. Keys past Skv are masked,
//    not padded: the TPU kernel's lane padding (Dm and D to 128, Skv to the
//    block) has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::make_map;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mma_3xtf32_int;
using hopper::named_arrive;
using hopper::named_sync;
using hopper::pack_bf16;
using hopper::smem_desc;
using hopper::smem_desc_mn_atoms;
using hopper::smem_u32;
using hopper::split_tf32_int;
using hopper::tma_load_4d;
using hopper::to_a_frag;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_tb;
using hopper::wgmma_ss_n128;
using hopper::wgmma_ss_n64;
using hopper::wgmma_wait;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, Skv] bool, row stride mask_sb; null = all valid
  const void* cos;      // K2, K4: [Skv, D/2] in q's dtype, contiguous; K1: null
  const void* sin;
  void* o;
  float* lse;           // [B*H, Sq]
  // the kv axis may be split over blockIdx.z: each split writes its
  // normalized fp32 output and row LSE here, the combine kernel merges them
  int n_split;          // 1: no split
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

// this CTA's range [kt0, kt1) of n_tiles kv tiles: blockIdx.z of n_split
// balanced ranges, none empty while n_split <= n_tiles
__device__ __forceinline__ void kv_range(const Params& p, int n_tiles, int& kt0, int& kt1) {
  kt0 = static_cast<int>(blockIdx.z * static_cast<long long>(n_tiles) / p.n_split);
  kt1 = static_cast<int>((blockIdx.z + 1ll) * n_tiles / p.n_split);
}

// ---------------------------------------------------------------------------
// mma.sync helpers (K4's bf16 route; the quad reductions of every route)
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool fill) {
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
// fp32 (K1 at every D, K2 on the rotated K): three-pass TF32 on mma.sync
// ---------------------------------------------------------------------------
//
// A CTA is 8 warps of 16 query rows (128 rows). Per kv tile, each warp:
//   S = Q K^T   m16n8k8 TF32, three products per fp32 product (hopper.cuh's
//               split_tf32_int), A from the Q tile and B from the K tile in
//               shared memory, both taking k in the order (2t, 2t + 1) for
//               lane t's slots (t, t + 4), so each fragment is one 8-byte
//               load (rows DP or DP + 8 floats apart, 8 mod 16: a half-warp
//               hits 32 distinct banks); every 8 k-steps sum into a zeroed
//               partial added to S in fp32;
//   softmax     online, in the log2 domain, masked keys and keys past Skv
//               -1e30, one division at the end;
//   O += P V    P from S's registers: the accumulator of 8 keys is the A
//               fragment of one k-step when V's rows are taken in the order
//               (2t, 2t + 1), so P never leaves the registers; V from shared
//               memory (rows DP + 4 floats apart, 4 mod 16). Each 8-column
//               tile's products sum into a zeroed partial added to O in fp32:
//               the tensor cores' accumulation does not round to nearest,
//               and without this K3's fp32 gate failed over 28,704 keys.
// K and V have one buffer each: the next tile's K streams in (16-byte
// cp.async) during this tile's P . V, its V during the next tile's S. 64 keys
// a tile up to D = 64, 32 above. Shared memory: 198 KB at D = 256 (one CTA an
// SM), 102 KB at D = 128, 71 KB at D = 64 (two CTAs an SM).

constexpr int F_WARPS = 8;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_BQ = 16 * F_WARPS;  // query rows per CTA
constexpr int F_KCH = 8;            // k-steps of S summed into one zeroed partial

template <int DP>
struct F32Tile {
  static constexpr int BK = DP > 64 ? 32 : 64;                // keys per kv tile
  static constexpr int LDQK = DP % 16 == 8 ? DP : DP + 8;     // Q and K row stride
  static constexpr int LDV = DP + 4;                          // V row stride
  static constexpr int SMEM = ((F_BQ + BK) * LDQK + BK * LDV) * static_cast<int>(sizeof(float));
  static constexpr int MIN_CTAS = DP > 128 ? 1 : 2;
};

// rows [r0, r0 + rows) of a [*, D] fp32 matrix with row stride rs (rows
// 16-byte aligned) into a [rows][ld] tile, zeros past `limit` rows and past
// D columns: 16-byte cp.async copies, all in flight at once
template <int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src, long long rs,
                                              int r0, int rows, int limit, int D) {
  constexpr int CH = DP / 4;  // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < rows * CH; idx += F_THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool in = r0 + r < limit && c < D;
    cp_async_16(dst + r * ld + c, in ? src + static_cast<long long>(r0 + r) * rs + c : src, in);
  }
}

template <int N>
__device__ __forceinline__ void zero4(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

template <int DP>
__device__ __forceinline__ void flash_tf32_body(const Params& p) {
  using T = F32Tile<DP>;
  constexpr int BK = T::BK, LDQK = T::LDQK, LDV = T::LDV;
  constexpr int K8 = DP / 8;  // k-steps of Q . K^T
  constexpr int NT = BK / 8;  // 8-key tiles of S, k-steps of P . V
  constexpr int ND = DP / 8;  // 8-column tiles of O
  extern __shared__ __align__(16) float f32_smem[];
  float* Qs = f32_smem;           // [F_BQ][LDQK]
  float* Ks = Qs + F_BQ * LDQK;   // [BK][LDQK]
  float* Vs = Ks + BK * LDQK;     // [BK][LDV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * F_BQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* mg = p.mask ? p.mask + b * p.mask_sb : nullptr;
  int kt0, kt1;
  kv_range(p, (p.Skv + BK - 1) / BK, kt0, kt1);

  // the first kv tile from kt on with a valid key (kt1: none) and whether
  // all its keys are valid; one barrier per tile looked at
  bool dense = false;
  auto next_tile = [&](int kt) {
    for (; kt < kt1; ++kt) {
      const int n =
          __syncthreads_count(threadIdx.x < BK && key_valid(mg, kt * BK + threadIdx.x, p.Skv));
      if (n > 0) {
        dense = n == BK;
        break;
      }
    }
    return kt;
  };

  int kt = next_tile(kt0);
  load_rows_f32<DP>(Qs, LDQK, qg, p.q_ss, q0, F_BQ, p.Sq, p.D);
  if (kt < kt1) load_rows_f32<DP>(Ks, LDQK, kg, p.k_ss, kt * BK, BK, p.Skv, p.D);
  cp_async_commit();
  if (kt < kt1) load_rows_f32<DP>(Vs, LDV, vg, p.v_ss, kt * BK, BK, p.Skv, p.D);
  cp_async_commit();

  const float scale_log2 = p.scale * LOG2E;
  float o[ND][4];
  zero4(o);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float* qa = Qs + (16 * warp + g) * LDQK + 2 * t;  // rows g, g + 8; k 2t, 2t + 1
  const float* kb = Ks + g * LDQK + 2 * t;                // key 8n + g; k 2t, 2t + 1
  const float* vb = Vs + 2 * t * LDV + g;                 // keys 2t, 2t + 1; column 8n + g
  // acc += this warp's Q . K^T over k-step kk, for the tile's BK keys
  auto s_step = [&](float (&acc)[NT][4], int kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * LDQK + 8 * kk);
    uint32_t ahi[4], alo[4];
    split_tf32_int(x0.x, ahi[0], alo[0]);
    split_tf32_int(x1.x, ahi[1], alo[1]);
    split_tf32_int(x0.y, ahi[2], alo[2]);
    split_tf32_int(x1.y, ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(kb + 8 * n * LDQK + 8 * kk);
      mma_3xtf32_int(acc[n], ahi, alo, y.x, y.y);
    }
  };
  // P (the exponentials in s) split as the A fragment of k-step n of P . V:
  // slots (t, t + 4) hold keys (2t, 2t + 1)
  auto p_split = [&](const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    split_tf32_int(x[0], hi[0], lo[0]);
    split_tf32_int(x[2], hi[1], lo[1]);
    split_tf32_int(x[1], hi[2], lo[2]);
    split_tf32_int(x[3], hi[3], lo[3]);
  };
  while (kt < kt1) {
    const int k0 = kt * BK;
    cp_async_wait_newest_pending();  // Q and this tile's K
    __syncthreads();

    // S = Q . K^T: [16 rows][BK keys] per warp; above 8 k-steps each 8 go
    // to a zeroed partial added to S in fp32
    float s[NT][4];
    zero4(s);
    if constexpr (K8 <= F_KCH) {
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) s_step(s, kk);
    } else {
      float part[NT][4];
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        if (kk % F_KCH == 0) zero4(part);
        s_step(part, kk);
        if (kk % F_KCH == F_KCH - 1 || kk == K8 - 1) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
        }
      }
    }

    // scale, mask, online softmax in the log2 domain
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = dense || key_valid(mg, k0 + 8 * n + 2 * t + j, p.Skv);
        s[n][j] = valid ? s[n][j] * scale_log2 : NEG_INF;
        s[n][2 + j] = valid ? s[n][2 + j] * scale_log2 : NEG_INF;
        mx[0] = fmaxf(mx[0], s[n][j]);
        mx[1] = fmaxf(mx[1], s[n][2 + j]);
      }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        row_sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum[r];

    // the next tile's K streams in during this tile's P . V
    const int next = next_tile(kt + 1);  // its first barrier: every warp is done with K
    if (next < kt1) load_rows_f32<DP>(Ks, LDQK, kg, p.k_ss, next * BK, BK, p.Skv, p.D);
    cp_async_commit();
    cp_async_wait_newest_pending();  // this tile's V
    __syncthreads();

    // O = O * alpha + P . V, the tile's products of each 8-column tile of O
    // in a zeroed partial: up to D = 64 all of them at once (each P split
    // once, 4 registers a column tile), above one column tile at a time (P
    // split once into 8 registers a k-step)
    auto add_tile = [&](float (&oc)[4], const float (&acc)[4]) {
      oc[0] = fmaf(oc[0], alpha[0], acc[0]);
      oc[1] = fmaf(oc[1], alpha[0], acc[1]);
      oc[2] = fmaf(oc[2], alpha[1], acc[2]);
      oc[3] = fmaf(oc[3], alpha[1], acc[3]);
    };
    if constexpr (ND <= 8) {
      float acc[ND][4];
      zero4(acc);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t phi[4], plo[4];
        p_split(s[n], phi, plo);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const float* vrow = vb + 8 * n * LDV + 8 * nd;
          mma_3xtf32_int(acc[nd], phi, plo, vrow[0], vrow[LDV]);
        }
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) add_tile(o[nd], acc[nd]);
    } else {
      uint32_t phi[NT][4], plo[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) p_split(s[n], phi[n], plo[n]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* vrow = vb + 8 * n * LDV + 8 * nd;
          mma_3xtf32_int(acc, phi[n], plo[n], vrow[0], vrow[LDV]);
        }
        add_tile(o[nd], acc);
      }
    }
    __syncthreads();  // every warp is done with V
    if (next < kt1) load_rows_f32<DP>(Vs, LDV, vg, p.v_ss, next * BK, BK, p.Skv, p.D);
    cp_async_commit();
    kt = next;
  }
  cp_async_wait_all();  // Q, where the range had no valid key

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  long long o_ss = p.o_ss;
  float* lse_out = p.lse + static_cast<long long>(bh) * p.Sq;
  if (p.n_split > 1) {  // this split's partial result
    const long long part_i = static_cast<long long>(blockIdx.z) * p.B * p.H + bh;
    og = p.part_o + part_i * p.Sq * p.D;
    o_ss = p.D;
    lse_out = p.part_lse + part_i * p.Sq;
  }
  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_row[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[r] > NEG_INF * 0.5f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < p.D)
        *reinterpret_cast<float2*>(og + row * o_ss + col) =
            seen_valid ? make_float2(o[nd][2 * r] / l_row[r], o[nd][2 * r + 1] / l_row[r])
                       : make_float2(0.f, 0.f);
    }
    if (t == 0) lse_out[row] = seen_valid ? (m[r] + log2f(l_row[r])) * LN2 : NEG_INF;
  }
}

template <int DP>
__global__ void __launch_bounds__(F_THREADS, F32Tile<DP>::MIN_CTAS)
    flash_fwd_tf32_kernel(const Params p) {
  flash_tf32_body<DP>(p);
}

// K2's fp32 attention: the same body under K2's name
template <int DP>
__global__ void __launch_bounds__(F_THREADS, F32Tile<DP>::MIN_CTAS)
    flash_rope_tf32_kernel(const Params p) {
  flash_tf32_body<DP>(p);
}

// ---------------------------------------------------------------------------
// bf16 (K1 at D <= 128 and 256, K2 on the rotated K): warp-specialised wgmma
// fed by TMA
// ---------------------------------------------------------------------------
//
// A CTA is three warpgroups. One warp of the first keeps TMA loads in flight
// (40 registers, setmaxnreg; 24 at D = 256); the other two consume (232; 240
// at D = 256), each owning 64 of the CTA's 128 query rows. Q arrives once; K and V tiles stream through two
// rings, one of K tiles and one of V tiles (3 stages each at D = 72-128, 6
// up to D = 64, 2 at D = 256), each stage with its own full/empty mbarrier
// pair, so a K stage is free again as soon as its S is done; tiles arrive as
// 128-byte swizzled boxes of 64 head-dim columns whose columns past D TMA
// fills with zeros. A stage holds 128 keys up to D = 128 and 64 at D = 256,
// where a 128-key K or V tile is 64 KB and two stages of each would not fit
// beside the 64 KB Q tile (Q, two K and two V stages: 194 KB). Beside each K
// stage the producer writes the tile's first key and its valid keys as one
// 32-bit word per 32 keys (from the mask where one is given, else from Skv:
// no mask bytes are read), and whether all are valid; a tile with no valid
// key is skipped. Per tile and warpgroup:
//   S = Q K^T      wgmma m64n128k16 (m64n64k16 at D = 256), both operands
//                  K-major from shared memory, over the head dim padded to
//                  DP, the next multiple of 16 (72 -> 80, 56 -> 64);
//   O += P V       wgmma m64nNk16, P from registers (S's accumulator fragment
//                  rounded to bf16 is the A fragment) and V as the MN-major
//                  B operand: N = D at D = 56, 72 and multiples of 16 up to
//                  128 (one descriptor spans both 64-column swizzle atoms: its
//                  leading offset is the box stride), else D padded to 16; at
//                  D = 256 two products of N = 128, each over two atoms.
// At D = 256 O takes 128 fp32 registers a thread, S 32 and P 16.
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
constexpr int BOX_ROW = 128;     // bytes of one swizzled box row: 64 bf16 columns
constexpr int SMEM_LIMIT = 232448;
constexpr int BARS_BYTES = 512;  // mbarriers, then each K stage's first key, key words, density
constexpr int MAX_STAGES = 6;
constexpr int BAR_TURN = 1;      // named barriers 1 and 2: the consumer warpgroups' turns

template <int DV>
struct FwdWg {
  static constexpr int BK = DV > 128 ? 64 : 128;  // keys per stage
  static constexpr int DP = (DV + 15) / 16 * 16;  // depth of Q . K^T
  static constexpr int NB = (DP + 63) / 64;       // 64-column boxes of a row
  static constexpr int KSTEPS = DP / 16;
  static constexpr int NPV = DV > 128 ? 2 : 1;    // P . V products per k-step, N = DV / NPV
  static constexpr int Q_BOX = WG_BQ * BOX_ROW;
  static constexpr int KV_BOX = BK * BOX_ROW;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int TILE = NB * KV_BOX;  // one K or V tile
  static constexpr int FIXED = Q_BYTES + 1024 + BARS_BYTES;  // + alignment slack
  static constexpr int STAGES = (SMEM_LIMIT - FIXED) / (2 * TILE) < MAX_STAGES
                                    ? (SMEM_LIMIT - FIXED) / (2 * TILE)
                                    : MAX_STAGES;
  static constexpr int SMEM = FIXED + 2 * STAGES * TILE;
  // registers (setmaxnreg) of the producer warpgroup and of each consumer:
  // at D = 256 O alone is 128 a thread, so the consumers take 240 and the
  // producer 24 (FlashAttention-3's split), else 232 and 40
  static constexpr int PRODUCER_REGS = DV > 128 ? 24 : 40;
  static constexpr int CONSUMER_REGS = DV > 128 ? 240 : 232;
  static_assert(STAGES >= 2, "the bf16 forward needs two stages in each ring");
  static_assert(BK == 64 || BK == 128, "S is one m64n64 or m64n128 product a k-step");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DV>
__device__ __forceinline__ void fwd_wgmma_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                               const CUtensorMap& tm_v, const Params& p) {
  using S = FwdWg<DV>;
  constexpr int NB = S::NB, ST = S::STAGES, BK = S::BK, NPV = S::NPV;
  constexpr int NW = DV / NPV;   // columns of one P . V product
  constexpr int NX = BK / 2;     // S accumulator registers: BK/8 n8 chunks of 4
  constexpr int PK = BK / 16;    // k16 steps of P . V
  constexpr int WORDS = BK / 32;
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
  // as up to four 32-bit words, and whether all are valid
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
    // producer: warp 0 walks this CTA's kv tiles, skipping those with no
    // valid key; its lane 0 issues every TMA load, K then V of each tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::PRODUCER_REGS));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(q_bar, S::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(smem_u32(Qs + c * S::Q_BOX), &tm_q, q_bar, 64 * c, q0, h, b);
    }
    int kt0, kt1;
    kv_range(p, (p.Skv + BK - 1) / BK, kt0, kt1);
    int i = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * BK;
      uint32_t w[WORDS];
      bool any = false, dense = true;
#pragma unroll
      for (int j = 0; j < WORDS; ++j) {
        w[j] = __ballot_sync(0xffffffffu, key_valid(mg, k0 + 32 * j + lane, p.Skv));
        any = any || w[j] != 0u;
        dense = dense && w[j] == 0xffffffffu;
      }
      // a tile with no valid key is skipped, but one tile always goes: the
      // consumers' first turn has a tile (all masked: its rows end at 0)
      if (!any && (i > 0 || kt + 1 < kt1)) continue;
      const int s = i % ST, parity = ((i / ST) & 1) ^ 1;
      if (lane == 0) {
        mbar_wait(k_empty + 8 * s, parity);
#pragma unroll
        for (int j = 0; j < WORDS; ++j) words_s[4 * s + j] = w[j];
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int my_turn = BAR_TURN + wg, other_turn = BAR_TURN + 1 - wg;
  if (wg == 1) named_arrive(BAR_TURN);  // warpgroup 0 takes the first turn
  const uint32_t qa = smem_u32(Qs) + wg * 64 * BOX_ROW;
  const float scale_log2 = p.scale * LOG2E;

  float o[NPV][NW / 2];
#pragma unroll
  for (int c = 0; c < NPV; ++c)
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) o[c][e] = 0.f;
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
    for (int j = 0; j < S::KSTEPS; ++j) {
      const uint64_t da = smem_desc(qa + (j / 4) * S::Q_BOX) + 2 * (j % 4);
      const uint64_t db = smem_desc(kb + (j / 4) * S::KV_BOX) + 2 * (j % 4);
      if constexpr (BK == 128)
        wgmma_ss_n128(x, da, db, j > 0);
      else
        wgmma_ss_n64(x, da, db, j > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {  // O = O * alpha + P . V of the tile in V stage s
#pragma unroll
    for (int c = 0; c < NPV; ++c)
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) o[c][e] *= alpha[(e >> 1) & 1];
    const uint32_t vb = smem_u32(v_ring + s * S::TILE);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NPV; ++c)
#pragma unroll
      for (int j = 0; j < PK; ++j)
        wgmma_rs_tb<NW>(o[c], pf[j],
                        smem_desc_mn_atoms(vb + c * (NW / 64) * S::KV_BOX + j * 16 * BOX_ROW,
                                           S::KV_BOX));
    wgmma_commit();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int c = 0; c < NPV; ++c) fence_regs(o[c]);
  };
  // this lane's view of a K stage's valid keys: bit 8 (i % 4) + (e & 1) of
  // wt[i / 4] is key 8i + 2t + (e & 1), read before the stage is released
  bool dense;
  uint32_t wt[WORDS];
  auto read_keys = [&](int s) {
    dense = dense_s[s];
#pragma unroll
    for (int j = 0; j < WORDS; ++j) wt[j] = words_s[4 * s + j] >> (2 * t);
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
    fence_o();
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
  fence_o();

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_row[r] = quad_sum(l[r]);
  const bool split = p.n_split > 1;
  const long long part_i = static_cast<long long>(blockIdx.z) * p.B * p.H + bh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* po = p.part_o + part_i * p.Sq * p.D;  // used when the kv axis is split
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
    if (row >= p.Sq) continue;
    const bool seen_valid = m[r] > NEG_INF * 0.5f;
    const float inv_l = seen_valid ? 1.f / l_row[r] : 0.f;
#pragma unroll
    for (int c = 0; c < NPV; ++c)
#pragma unroll
      for (int i8 = 0; i8 < NW / 8; ++i8) {
        const int col = NW * c + 8 * i8 + 2 * t;
        if (col >= p.D) continue;
        const float v0 = o[c][4 * i8 + 2 * r] * inv_l, v1 = o[c][4 * i8 + 2 * r + 1] * inv_l;
        if (split)
          *reinterpret_cast<float2*>(po + static_cast<long long>(row) * p.D + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    if (t == 0) {
      const float lse = seen_valid ? (m[r] + log2f(l_row[r])) * LN2 : NEG_INF;
      if (split)
        p.part_lse[part_i * p.Sq + row] = lse;
      else
        p.lse[static_cast<long long>(bh) * p.Sq + row] = lse;
    }
  }
}

template <int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const Params p) {
  fwd_wgmma_body<DV>(tm_q, tm_k, tm_v, p);
}

// K2's bf16 attention: the same body under K2's name
template <int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_rope_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const Params p) {
  fwd_wgmma_body<DV>(tm_q, tm_k, tm_v, p);
}

// ---------------------------------------------------------------------------
// K2, part one: the rotation, once per call
// ---------------------------------------------------------------------------

__device__ __forceinline__ float rot_lo(float x1, float x2, float c, float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));  // no FMA: the plain version's rounding
}

__device__ __forceinline__ float rot_hi(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

constexpr int ROT_THREADS = 256;

template <typename T>
struct alignas(16) Chunk {  // 16 bytes of a row
  T x[16 / sizeof(T)];
};

// kr [B*H, Skv, D] (contiguous) = k rotated by the [Skv, D/2] tables. A
// thread takes one 16-byte chunk of a table row (columns d .. d + 16 bytes)
// and rotates the chunk pair (d, d + D/2) of that key for every (b, h): each
// table byte and each K byte is read once, each kr byte written once.
template <typename T>
__global__ void __launch_bounds__(ROT_THREADS) flash_rope_rotate_kernel(const Params p, T* kr) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int half = p.D / 2, chunks = half / VEC;
  const long long idx = static_cast<long long>(blockIdx.x) * ROT_THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(p.Skv) * chunks) return;
  const int row = static_cast<int>(idx / chunks), d = static_cast<int>(idx % chunks) * VEC;
  const long long trow = static_cast<long long>(row) * half + d;
  const Chunk<T> c = *reinterpret_cast<const Chunk<T>*>(static_cast<const T*>(p.cos) + trow);
  const Chunk<T> s = *reinterpret_cast<const Chunk<T>*>(static_cast<const T*>(p.sin) + trow);
  for (int bh = 0; bh < p.B * p.H; ++bh) {
    const int b = bh / p.H, h = bh % p.H;
    const T* src = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + row * p.k_ss;
    const Chunk<T> x1 = *reinterpret_cast<const Chunk<T>*>(src + d);
    const Chunk<T> x2 = *reinterpret_cast<const Chunk<T>*>(src + half + d);
    Chunk<T> lo, hi;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a1 = to_f32(x1.x[e]), a2 = to_f32(x2.x[e]);
      const float ce = to_f32(c.x[e]), se = to_f32(s.x[e]);
      from_f32(lo.x[e], rot_lo(a1, a2, ce, se));
      from_f32(hi.x[e], rot_hi(a1, a2, ce, se));
    }
    T* dst = kr + (static_cast<long long>(bh) * p.Skv + row) * p.D;
    *reinterpret_cast<Chunk<T>*>(dst + d) = lo;
    *reinterpret_cast<Chunk<T>*>(dst + half + d) = hi;
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

    // S = Q . K^T: [16 rows][32 keys] per warp, fp32
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

// fp32: FMAs on the CUDA cores at 128 query rows x 32 keys. Thread (ty, tx) owns
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

// Merges the kv splits: out = sum_s exp(lse_s - lse) * out_s with lse = log
// sum_s exp(lse_s); a split that saw no valid key has lse_s = -1e30 and
// weight 0; a row with none at all gets 0 and -1e30. One CTA per (query row,
// b*h), one thread per output column. Each caller launches it under its own
// name (flash_fwd_ K1, flash_rope_ K2, flash_kvproj_ K4), so a profile puts
// it with the kernel whose splits it merges.
template <typename T>
__device__ __forceinline__ void combine_body(const Params& p) {
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

template <typename T>
__global__ void __launch_bounds__(128) flash_fwd_combine_kernel(const Params p) {
  combine_body<T>(p);
}

template <typename T>
__global__ void __launch_bounds__(128) flash_rope_combine_kernel(const Params p) {
  combine_body<T>(p);
}

template <typename T>
__global__ void __launch_bounds__(128) flash_kvproj_combine_kernel(const Params p) {
  combine_body<T>(p);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum class Caller { K1, K2, K4 };

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int rows_per_cta, int threads, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows_per_cta - 1) / rows_per_cta, p.B * p.H, p.n_split);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// After a kv-split launch: the caller's combine kernel on the same stream.
template <Caller C>
cudaError_t launch_combine(cudaError_t err, bool bf16, const Params& p, cudaStream_t stream) {
  if (err != cudaSuccess || p.n_split == 1) return err;
  const dim3 grid(p.Sq, p.B * p.H);
  if constexpr (C == Caller::K1) {
    if (bf16)
      flash_fwd_combine_kernel<__nv_bfloat16><<<grid, 128, 0, stream>>>(p);
    else
      flash_fwd_combine_kernel<float><<<grid, 128, 0, stream>>>(p);
  } else if constexpr (C == Caller::K2) {
    if (bf16)
      flash_rope_combine_kernel<__nv_bfloat16><<<grid, 128, 0, stream>>>(p);
    else
      flash_rope_combine_kernel<float><<<grid, 128, 0, stream>>>(p);
  } else {
    if (bf16)
      flash_kvproj_combine_kernel<__nv_bfloat16><<<grid, 128, 0, stream>>>(p);
    else
      flash_kvproj_combine_kernel<float><<<grid, 128, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// K1's kernels or, for K2, the same bodies under K2's names
template <int DV, Caller C>
constexpr auto wgmma_kernel() {
  if constexpr (C == Caller::K1)
    return &flash_fwd_wgmma_kernel<DV>;
  else
    return &flash_rope_wgmma_kernel<DV>;
}

template <int DP, Caller C>
constexpr auto tf32_kernel() {
  if constexpr (C == Caller::K1)
    return &flash_fwd_tf32_kernel<DP>;
  else
    return &flash_rope_tf32_kernel<DP>;
}

// The bf16 attention at one width: the tensor maps of q, k and v, the kernel
// under the caller's name, then the combine where the kv axis is split.
template <int DV, Caller C>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using S = FwdWg<DV>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, p.q, p.B, p.H, p.Sq, p.D, p.q_sb, p.q_sh, p.q_ss, WG_BQ) ||
      !make_map(&mk, p.k, p.B, p.H, p.Skv, p.D, p.k_sb, p.k_sh, p.k_ss, S::BK) ||
      !make_map(&mv, p.v, p.B, p.H, p.Skv, p.D, p.v_sb, p.v_sh, p.v_ss, S::BK))
    return cudaErrorInvalidValue;
  constexpr auto kernel = wgmma_kernel<DV, C>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + WG_BQ - 1) / WG_BQ, p.B * p.H, p.n_split);
  kernel<<<grid, WG_THREADS, S::SMEM, stream>>>(mq, mk, mv, p);
  return launch_combine<C>(cudaGetLastError(), true, p, stream);
}

template <int DP, Caller C>
cudaError_t launch_tf32(const Params& p, cudaStream_t stream) {
  constexpr auto kernel = tf32_kernel<DP, C>();
  return launch_combine<C>(launch(kernel, F32Tile<DP>::SMEM, F_BQ, F_THREADS, p, stream), false, p,
                           stream);
}

// The widths each dtype is built at: bf16 runs P . V at N = D for D = 56, 72
// (hiera-b+'s and hiera-L's global blocks), multiples of 16 up to 128 and
// 256, other D padded to 16; fp32 pads D up to the next of these.
int wgmma_width(int D) {
  if (D == 56 || D == 72 || D == 256) return D;
  return D <= 128 ? (D + 15) / 16 * 16 : -1;
}

int tf32_width(int D) {
  constexpr int widths[] = {16, 32, 48, 56, 64, 72, 80, 96, 112, 128, 256};
  for (const int w : widths)
    if (D <= w) return w;
  return -1;
}

// f(the width constant) for the kernel of (bf16, D); -1 for an unsupported D
template <typename F>
auto by_width(bool bf16, int D, F&& f) -> decltype(f(std::integral_constant<int, 256>())) {
  using std::integral_constant;
  switch (bf16 ? wgmma_width(D) : tf32_width(D)) {
    case 16: return f(integral_constant<int, 16>());
    case 32: return f(integral_constant<int, 32>());
    case 48: return f(integral_constant<int, 48>());
    case 56: return f(integral_constant<int, 56>());
    case 64: return f(integral_constant<int, 64>());
    case 72: return f(integral_constant<int, 72>());
    case 80: return f(integral_constant<int, 80>());
    case 96: return f(integral_constant<int, 96>());
    case 112: return f(integral_constant<int, 112>());
    case 128: return f(integral_constant<int, 128>());
    case 256: return f(integral_constant<int, 256>());
    default: return f(integral_constant<int, -1>());
  }
}

// K1 (C = K1) or K2's attention on the rotated K (C = K2: D = 64, 128, 256)
template <Caller C>
cudaError_t dispatch(bool bf16, const Params& p, cudaStream_t stream) {
  return by_width(bf16, p.D, [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    if constexpr (W < 0 || (C == Caller::K2 && W != 64 && W != 128 && W != 256)) {
      return cudaErrorInvalidValue;
    } else {
      return bf16 ? launch_wgmma<W, C>(p, stream) : launch_tf32<W, C>(p, stream);
    }
  });
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

// K1's and K2's launch geometry for (bf16, D): query rows per CTA, keys per
// kv tile, kv tiles in flight (bf16: stages of each of the K and V rings;
// fp32: one K and one V buffer) and resident CTAs per SM; rows 0 for an
// unsupported D.
struct Geometry {
  int rows, keys, stages, per_sm;
};

Geometry geometry(bool bf16, int D) {
  return by_width(bf16, D, [&](auto w) -> Geometry {
    constexpr int W = decltype(w)::value;
    if constexpr (W < 0) {
      return Geometry{0, 0, 0, 1};
    } else {
      if (bf16)
        return Geometry{WG_BQ, FwdWg<W>::BK, FwdWg<W>::STAGES,
                        ctas_per_sm(flash_fwd_wgmma_kernel<W>, FwdWg<W>::SMEM, WG_THREADS)};
      return Geometry{F_BQ, F32Tile<W>::BK, 1,
                      ctas_per_sm(flash_fwd_tf32_kernel<W>, F32Tile<W>::SMEM, F_THREADS)};
    }
  });
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

template <int DM>
cudaError_t launch_kvproj_dm(bool bf16, const Params& p, cudaStream_t stream) {
  return launch_combine<Caller::K4>(
      bf16 ? launch(flash_kvproj_bf16_kernel<DM>, smem_bytes_kvproj_bf16<DM>(), KP_BQ,
                    KP_THREADS, p, stream)
           : launch(flash_kvproj_f32_kernel<DM>, smem_bytes_kvproj_f32<DM>(), KP_BQ,
                    KP_THREADS, p, stream),
      bf16, p, stream);
}

cudaError_t dispatch_kvproj(bool bf16, const Params& p, cudaStream_t stream) {
  switch (p.Dm) {
    case 32: return launch_kvproj_dm<32>(bf16, p, stream);
    case 64: return launch_kvproj_dm<64>(bf16, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K2's rotation: k -> kr [B*H, Skv, D] contiguous, in q's dtype (p.k and its
// strides; p.cos, p.sin)
cudaError_t launch_rotate(bool bf16, const Params& p, void* kr, cudaStream_t stream) {
  const long long chunks = static_cast<long long>(p.Skv) * (p.D / 2) / (bf16 ? 8 : 4);
  const long long blocks = (chunks + ROT_THREADS - 1) / ROT_THREADS;
  if (blocks > 2147483647ll) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (bf16)
    flash_rope_rotate_kernel<__nv_bfloat16><<<grid, ROT_THREADS, 0, stream>>>(
        p, static_cast<__nv_bfloat16*>(kr));
  else
    flash_rope_rotate_kernel<float><<<grid, ROT_THREADS, 0, stream>>>(p, static_cast<float*>(kr));
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* mask, const void* cos,
                   const void* sin, void* part_o, void* part_lse, void* o, void* lse, int B,
                   int H, int Sq, int Skv, int D, int n_split, long long q_sb, long long q_sh,
                   long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                   long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                   long long mask_sb, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = cos; p.sin = sin;
  p.o = o; p.lse = static_cast<float*>(lse);
  p.n_split = n_split;
  p.part_o = static_cast<float*>(part_o); p.part_lse = static_cast<float*>(part_lse);
  p.wk = p.wv = nullptr;
  p.bk = p.bv = nullptr;
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D; p.Dm = 0;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.mask_sb = mask_sb;
  p.scale = scale;
  return p;
}

// The arguments every kernel here needs: positive sizes, D a multiple of 8,
// a grid within limits, a dtype, and a kv split with scratch and no empty
// range (at most one split per 128 keys).
bool valid_args(int dtype, int B, int H, int Sq, int Skv, int D, int n_split, const void* part_o,
                const void* part_lse) {
  return B > 0 && H > 0 && Sq > 0 && Skv > 0 && D > 0 && D % 8 == 0 &&
         static_cast<long long>(B) * H <= 65535 && (dtype == 0 || dtype == 1) &&
         (n_split == 1 || (n_split > 1 && n_split <= (Skv + 127) / 128 && part_o != nullptr &&
                           part_lse != nullptr));
}

}  // namespace

// Every entry point returns the cudaError_t of its launches (0 =
// cudaSuccess). dtype: 0 fp32, 1 bf16. With n_split > 1 the kv axis is split
// over n_split CTAs per query tile and part_o [n_split, B*H, Sq, D] /
// part_lse [n_split, B*H, Sq] (fp32, allocated by the caller) hold the
// partial results until the combine kernel, launched right after on the same
// stream, merges them.

// K1: D a multiple of 8 up to 128, or 256.
extern "C" int sam2_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* part_o,
    void* part_lse, void* o, void* lse, int dtype, int B, int H, int Sq, int Skv, int D,
    int n_split,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  if (!valid_args(dtype, B, H, Sq, Skv, D, n_split, part_o, part_lse))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, mask, nullptr, nullptr, part_o, part_lse, o, lse, B, H, Sq,
                               Skv, D, n_split, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                               v_ss, o_sb, o_sh, o_ss, mask_sb, scale);
  return static_cast<int>(dispatch<Caller::K1>(dtype == 1, p, static_cast<cudaStream_t>(stream)));
}

// K1's kv split for these shapes on the current device, and K2's (K2 runs
// K1's body): the most splits that keep the grid in one wave of resident
// CTAs, at least 8 kv tiles each; -1 for an unsupported D.
extern "C" int sam2_flash_attention_splits(int dtype, int B, int H, int Sq, int Skv, int D) {
  const Geometry geo = geometry(dtype == 1, D);
  if (geo.rows == 0) return -1;
  return kv_splits(geo.per_sm, geo.rows, geo.keys, B, H, Sq, Skv);
}

// K1's and K2's tiling for a head dim: out[0] query rows per CTA, out[1]
// keys per kv tile, out[2] kv tiles in flight (bf16: stages of each of the K
// and V rings).
extern "C" void sam2_flash_attention_tiling(int dtype, int D, int* out) {
  const Geometry geo = geometry(dtype == 1, D);
  out[0] = geo.rows;
  out[1] = geo.keys;
  out[2] = geo.stages;
}

// K2's rotation alone: kr [B*H, Skv, D] (contiguous, k's dtype) = k [B, H,
// Skv, D] (strides k_s*, unit stride along D, rows 16-byte aligned) rotated
// by cos/sin [Skv, D/2] (k's dtype, contiguous); D a multiple of 16 (bf16)
// or 8 (fp32).
extern "C" int sam2_flash_attention_rope_rotate(const void* k, const void* cos, const void* sin,
                                                void* kr, int dtype, int B, int H, int Skv, int D,
                                                long long k_sb, long long k_sh, long long k_ss,
                                                void* stream) {
  if (B <= 0 || H <= 0 || Skv <= 0 || D <= 0 || D % (dtype == 1 ? 16 : 8) != 0 ||
      (dtype != 0 && dtype != 1) || cos == nullptr || sin == nullptr || kr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(nullptr, k, nullptr, nullptr, cos, sin, nullptr, nullptr, nullptr,
                               nullptr, B, H, 0, Skv, D, 1, 0, 0, 0, k_sb, k_sh, k_ss, 0, 0, 0, 0,
                               0, 0, 0, 1.f);
  return static_cast<int>(launch_rotate(dtype == 1, p, kr, static_cast<cudaStream_t>(stream)));
}

// K2: the rotation of k into kr (contiguous [B*H, Skv, D] scratch in q's
// dtype, allocated by the caller), then K1's attention body on kr under K2's
// kernel names; D in {64, 128, 256}; cos/sin [Skv, D/2] in q's dtype,
// contiguous.
extern "C" int sam2_flash_attention_rope_fwd(
    const void* q, const void* k, const void* v, const void* mask, const void* cos,
    const void* sin, void* kr, void* part_o, void* part_lse, void* o, void* lse, int dtype, int B,
    int H, int Sq, int Skv, int D, int n_split,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  if (!valid_args(dtype, B, H, Sq, Skv, D, n_split, part_o, part_lse) ||
      (D != 64 && D != 128 && D != 256) || cos == nullptr || sin == nullptr || kr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, mask, cos, sin, part_o, part_lse, o, lse, B, H, Sq, Skv, D,
                         n_split, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
                         o_ss, mask_sb, scale);
  const bool bf16 = dtype == 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_rotate(bf16, p, kr, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.k = kr;
  p.k_ss = D;
  p.k_sh = static_cast<long long>(Skv) * D;
  p.k_sb = p.k_sh * H;
  return static_cast<int>(dispatch<Caller::K2>(bf16, p, st));
}

// K4: K2 with the K/V projections fused in; one head, D = 256, Dm in
// {32, 64}. q [B, 1, Sq, D] (rotated) with batch / row strides; mem_k, mem_v
// [B, Skv, Dm] with batch / row strides (unit stride along Dm; bf16 rows
// 16-byte aligned, fp32 rows 16-byte aligned); wk, wv [D, Dm] contiguous in
// q's dtype; bk, bv [D] fp32; cos/sin [Skv, D/2] in q's dtype, contiguous;
// out [B, Sq, D] with batch / row strides, lse [B, Sq]. The kv split and its
// scratch are as K1's (part_o [n_split, B, Sq, D], part_lse [n_split, B, Sq]).
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
  Params p = make_params(q, mem_k, mem_v, mask, cos, sin, part_o, part_lse, o, lse, B, 1, Sq, Skv,
                         D, n_split, q_sb, 0, q_ss, mk_sb, 0, mk_ss, mv_sb, 0, mv_ss, o_sb, 0,
                         o_ss, mask_sb, scale);
  p.wk = wk; p.wv = wv;
  p.bk = static_cast<const float*>(bk); p.bv = static_cast<const float*>(bv);
  p.Dm = Dm;
  return static_cast<int>(dispatch_kvproj(dtype == 1, p, static_cast<cudaStream_t>(stream)));
}

// K4's kv split for these shapes on the current device (K1's rule); -1 for
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
