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
// D = 256) fused in:
//   kp = round(mem_k . Wk^T + bk),  vp = round(mem_v . Wv^T + bv)
// (fp32 sums, the bias added in fp32, one rounding to q's dtype), kp rotated
// as K2 rotates K (from the rounded kp, as the JAX kernel orders it,
// :177-178), then K1's masked flash softmax with the row lse. Weights are
// nn.Linear [D, Dm] in q's dtype, biases [D] in fp32. Bound at the cross
// shape (B = 1, 4096 queries, 28,736 keys): 4*4096*28736*256 = 120.5 GFLOP
// of attention and 1.9 GFLOP of projections, all on the tensor cores,
// compute-bound (0.124 ms in bf16; 0.742 ms in fp32, where the products run
// as three TF32 products each, at 495/3 TFLOP/s).
// K4 projects once per call, in a kernel of its own launched first
// (flash_kvproj_project_*: K and V projected, K rotated, into contiguous
// [B, Skv, 256] scratch the wrapper allocates), then runs K1's attention
// body on (q, kr, vp) under K4's own kernel names (flash_kvproj_wgmma_kernel,
// flash_kvproj_tf32_kernel, flash_kvproj_combine_kernel) with K1's kv split.
// Projecting inside the attention, as the TPU kernel does, repeats the
// projections once per query tile (32 times at the cross shape, 60 GFLOP at
// 128-row tiles) and keeps TMA from feeding wgmma; the projection kernel is
// bound by bytes instead (the memory, the tables, kr and vp: 51.5 MB in
// bf16, 15 us at 3.35 TB/s), and kr and vp (29 MB in bf16) then sit in the
// 50 MB L2 while the attention reads them. bf16 projects on mma.sync
// m16n8k16, fp32 as three-pass TF32 on mma.sync m16n8k8 (their section
// below). On an H100 80GB HBM3 at 700 W (chip_smoke.py, cold L2, CUDA graph
// replays) K4 takes 0.347 ms in bf16 and 2.71 ms in fp32 at the cross shape
// (the kernel it replaced, which projected per query tile: 1.58 / 9.26),
// the projection kernel 0.031 / 0.062 ms of it, against 0.361 / 2.74 for
// the unfused route (two F.linear + K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::ex2;
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
  // K4: k / v are the Dm-wide memory tokens, projected by wk / wv [D, Dm]
  // (q's dtype, contiguous) plus bk / bv [D] (fp32)
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
  // the relative-position attention (sam2_flash_attention_relpos_fwd): bf16
  // rel with batch / head / row strides rel_sb, rel_sh, rel_ss, row i of
  // (b, h) holding q_i . rel_pos_h[r] (r < 2Kh - 1), then q_i . rel_pos_w[r];
  // null and 0 elsewhere
  const void* rel;
  long long rel_sb, rel_sh, rel_ss;
  int Kh, Kw;
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
// mma.sync helpers (K4's bf16 projections; the quad reductions of every route)
// ---------------------------------------------------------------------------

// c += a . b for one 16x8x16 tile: a row-major [16][16], b column-major [16][8]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory: the A operand of one 16 x 16
// tile of a row-major [row][k] matrix
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
constexpr int BAR_BIAS = 3;      // named barriers 3 and 4: a consumer warpgroup's bias rows
// the relative-position terms of the CTA's 128 query rows in shared memory,
// fp32 in the log2 domain: rel_h [128][MAX_K] then rel_w [128][MAX_K], Kh and
// Kw <= MAX_K. Columns are swizzled by row (rel_h: kh ^ 4 (row % 8); rel_w:
// kw ^ 8 (row % 4), pairs kept whole), so a warp's reads hit 32 banks.
constexpr int MAX_K = 64;

template <int DV, bool BIAS = false>
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
  static constexpr int BIAS_BYTES = BIAS ? 2 * WG_BQ * MAX_K * 4 : 0;
  static constexpr int FIXED = Q_BYTES + 1024 + BARS_BYTES + BIAS_BYTES;  // + alignment slack
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

template <int DV, bool BIAS = false>
__device__ __forceinline__ void fwd_wgmma_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                               const CUtensorMap& tm_v, const Params& p) {
  using S = FwdWg<DV, BIAS>;
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
  float* rel_h_s = reinterpret_cast<float*>(bars + BARS_BYTES);  // BIAS: [128][MAX_K]
  float* rel_w_s = rel_h_s + WG_BQ * MAX_K;                       // BIAS: [128][MAX_K]

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
  if constexpr (BIAS) {
    // this warpgroup's 64 rows of the bias terms into shared memory, gathered
    // from the products (upstream's get_rel_pos: the key kh of query row
    // (qh, qw) takes table row qh - kh + Kh - 1), in fp32 times log2(e);
    // rows past Sq zero. A row's columns go to consecutive lanes (a power of
    // two of them), so the loads coalesce; each thread issues eight loads,
    // their indices clamped rather than branched around, before it stores.
    const int cols = p.Kh + p.Kw, rh = 2 * p.Kh - 1;
    int lanes = 1;
    while (lanes < cols) lanes <<= 1;
    const int per_pass = 128 / lanes, c = tid & (lanes - 1), r0 = tid / lanes;
    const int cc = c < cols ? c : cols - 1;
    const __nv_bfloat16* gr =
        static_cast<const __nv_bfloat16*>(p.rel) + b * p.rel_sb + h * p.rel_sh;
    for (int rr0 = 0; rr0 < 64; rr0 += 8 * per_pass) {
      float val[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int rr = rr0 + u * per_pass + r0;
        const int i = min(q0 + 64 * wg + min(rr, 63), p.Sq - 1);
        const int qh = i / p.Kw, qw = i - qh * p.Kw;
        const int col = cc < p.Kh ? qh - cc + p.Kh - 1 : rh + qw - (cc - p.Kh) + p.Kw - 1;
        val[u] = __bfloat162float(gr[i * p.rel_ss + col]) * LOG2E;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int rr = rr0 + u * per_pass + r0, row = 64 * wg + rr;
        const float x = q0 + row < p.Sq ? val[u] : 0.f;
        if (c < p.Kh && rr < 64)
          rel_h_s[row * MAX_K + (c ^ (4 * (row & 7)))] = x;
        else if (c < cols && rr < 64)
          rel_w_s[row * MAX_K + ((c - p.Kh) ^ (8 * (row & 3)))] = x;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_BIAS + wg) : "memory");
  }

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
  int tile_k0 = 0;  // BIAS: the tile's first key
  auto read_keys = [&](int s) {
    dense = dense_s[s];
    if constexpr (BIAS) tile_k0 = tile_s[s];
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
    if constexpr (BIAS) {
      // s = q . k * scale + rel_h[row, kh] + rel_w[row, kw] for key
      // j = kh * Kw + kw, in the log2 domain. Lane t holds keys j = 8c + 2t
      // and j + 1 of the tile: even, so with Kw even they share kh and their
      // two rel_w terms are one 8-byte pair. Rows g and g + 8 share a swizzle.
      // The next chunk's (kh, kw) is a select, not a branch (Kw >= 8: one wrap
      // at most), so the chunks' loads schedule as one block.
      const int row = 64 * wg + 16 * warp + g;
      const int sh = 4 * (row & 7), sw = 8 * (row & 3);
      const float* bh_row[2] = {rel_h_s + row * MAX_K, rel_h_s + (row + 8) * MAX_K};
      const float* bw_row[2] = {rel_w_s + row * MAX_K, rel_w_s + (row + 8) * MAX_K};
      int kh = (tile_k0 + 2 * t) / p.Kw;
      int kw = tile_k0 + 2 * t - kh * p.Kw;
      if (dense) {
#pragma unroll
        for (int c = 0; c < NX / 4; ++c) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float th = bh_row[r][kh ^ sh];
            const float2 tw = *reinterpret_cast<const float2*>(bw_row[r] + (kw ^ sw));
            float* xe = x + 4 * c + 2 * r;
            xe[0] = fmaf(xe[0], scale_log2, th + tw.x);
            xe[1] = fmaf(xe[1], scale_log2, th + tw.y);
            mx[r] = fmaxf(mx[r], fmaxf(xe[0], xe[1]));
          }
          const bool wrap = kw + 8 >= p.Kw;
          kw = wrap ? kw + 8 - p.Kw : kw + 8;
          kh += wrap;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NX / 4; ++c) {
          const int khc = kh < p.Kh ? kh : p.Kh - 1;  // keys past Skv are masked
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float th = bh_row[r][khc ^ sh];
            const float2 tw = *reinterpret_cast<const float2*>(bw_row[r] + (kw ^ sw));
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int e = 4 * c + 2 * r + b;
              const bool valid = (wt[e / 16] >> (8 * ((e / 4) % 4) + (e & 1))) & 1u;
              x[e] = valid ? fmaf(x[e], scale_log2, th + (b ? tw.y : tw.x)) : NEG_INF;
              mx[r] = fmaxf(mx[r], x[e]);
            }
          }
          const bool wrap = kw + 8 >= p.Kw;
          kw = wrap ? kw + 8 - p.Kw : kw + 8;
          kh += wrap;
        }
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
    } else if (dense) {
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
    if (t == 0 && !BIAS) {  // the relative-position attention returns no lse
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

// The relative-position attention (SAM's ViT blocks): K1's bf16 body with the
// decomposed bias added to the logits, under a name of its own
template <int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_relpos_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const Params p) {
  fwd_wgmma_body<DV, true>(tm_q, tm_k, tm_v, p);
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
// K4, part one: the K/V projections and K's rotation, once per call
// ---------------------------------------------------------------------------
//
// kr = rotate(round(mem_k . Wk^T + bk)) and vp = round(mem_v . Wv^T + bv) for
// every (b, key), into contiguous [B, Skv, 256] scratch in q's dtype that the
// wrapper allocates: fp32 sums, the bias added in fp32, one rounding to q's
// dtype, then K2's rotation of the rounded kp (fp32 from it, one rounding per
// operation, no FMA, one rounding), in the order of the JAX kernel
// (:173-178) and the plain version. The rows are the B*Skv (b, key) pairs; a
// CTA walks tiles of them with a stride of the grid, its weights resident.

constexpr int KP_D = 256;  // the memory-attention width (d_model)
constexpr int KP_HALF = KP_D / 2;
constexpr int KP_THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16: mma.sync m16n8k16, fp32 accumulators, 32-row tiles. Warp w projects K
// for channels 16w..16w+15 and their rotation partners 128+16w.. (one thread
// holds both halves of a rotation pair in its accumulators and rotates in
// registers) and V for channels 32w..32w+31. The weights arrive once through
// shared memory (16-byte copies, then ldmatrix into fragments that stay in
// registers for the CTA's life). Each tile's raw rows and its rows of the
// cos/sin tables stream through a 2-stage cp.async ring, so neither the
// products nor the rotation wait on device memory (read in the epilogue
// straight from device memory, the tables were the largest cost); each
// tile's kr and vp rows are assembled in shared memory and leave as whole
// 512-byte rows of 16-byte stores (they are contiguous in kr and vp). 92 KB
// of shared memory: two CTAs an SM. At the cross shape it takes 0.031 ms on
// an H100 80GB HBM3 at 700 W, against the 0.015 ms its bytes need.
constexpr int KPB_ROWS = 32;
constexpr int KPB_LDT = KP_HALF + 8;  // row stride of the staged tables
constexpr int KPB_LDO = KP_D + 8;     // row stride of the staged kr / vp rows

template <int DM>
struct KpBf16 {
  static constexpr int LDM = DM + 8;  // an odd multiple of 16 bytes: ldmatrix rows miss no bank
  static constexpr int RAW = KPB_ROWS * LDM;
  static constexpr int TAB = KPB_ROWS * KPB_LDT;
  static constexpr int STAGE = 2 * RAW + 2 * TAB;     // mem_k, mem_v, cos, sin
  static constexpr int OUT = 2 * KPB_ROWS * KPB_LDO;  // [kr, vp][rows][KPB_LDO]
  static constexpr int WTS = KP_D * LDM;              // one weight matrix, before the first tile
  static constexpr int STAGED = OUT > WTS ? OUT : WTS;
  static constexpr int SMEM = (2 * STAGE + STAGED) * static_cast<int>(sizeof(__nv_bfloat16)) +
                              2 * KP_D * static_cast<int>(sizeof(float));
};

template <int DM>
__global__ void __launch_bounds__(KP_THREADS, 2)
    flash_kvproj_project_bf16_kernel(const Params p, __nv_bfloat16* kr, __nv_bfloat16* vp) {
  using S = KpBf16<DM>;
  constexpr int LDM = S::LDM, MKS = DM / 16, MCH = DM / 8, TCH = KP_HALF / 8, OCH = KP_D / 8;
  extern __shared__ __align__(16) __nv_bfloat16 kpb_smem[];
  __nv_bfloat16* ring = kpb_smem;               // [stage][mem_k, mem_v, cos, sin]
  __nv_bfloat16* staged = ring + 2 * S::STAGE;  // a weight matrix, then each tile's kr and vp rows
  float* bks = reinterpret_cast<float*>(staged + S::STAGED);  // [KP_D]
  float* bvs = bks + KP_D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rows = p.B * p.Skv;  // < 2^31 (the launch checks)
  const int n_tiles = (rows + KPB_ROWS - 1) / KPB_ROWS;
  const __nv_bfloat16* mk = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* mv = static_cast<const __nv_bfloat16*>(p.v);
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.cos);
  const __nv_bfloat16* sg = static_cast<const __nv_bfloat16*>(p.sin);

  auto load_weights = [&](const void* w) {
    for (int idx = threadIdx.x; idx < KP_D * MCH; idx += KP_THREADS) {
      const int r = idx / MCH, c = (idx % MCH) * 8;
      cp_async_16(staged + r * LDM + c, static_cast<const __nv_bfloat16*>(w) + r * DM + c, true);
    }
    cp_async_commit();
  };
  // the B fragments (W [channel][k] is B column-major) of two 16-channel
  // groups from rows ch0.. and ch1.. of the staged matrix: n-tiles 0-1, 2-3
  auto fragments = [&](uint32_t (&f)[MKS][4][2], int ch0, int ch1) {
    const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < MKS; ++ks)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t r[4];
        ldmatrix_x4(r, staged + ((q == 0 ? ch0 : ch1) + b_row) * LDM + 16 * ks + b_col);
        f[ks][2 * q][0] = r[0], f[ks][2 * q][1] = r[1];
        f[ks][2 * q + 1][0] = r[2], f[ks][2 * q + 1][1] = r[3];
      }
  };
  auto load = [&](int tile, int stage) {  // rows past B*Skv are zero-filled
    __nv_bfloat16* dst = ring + stage * S::STAGE;
    for (int idx = threadIdx.x; idx < KPB_ROWS * MCH; idx += KP_THREADS) {
      const int r = idx / MCH, c = (idx % MCH) * 8;
      const int row = tile * KPB_ROWS + r;
      const bool in = row < rows;
      const int b = in ? row / p.Skv : 0, key = in ? row % p.Skv : 0;
      cp_async_16(dst + r * LDM + c, mk + b * p.k_sb + key * p.k_ss + c, in);
      cp_async_16(dst + S::RAW + r * LDM + c, mv + b * p.v_sb + key * p.v_ss + c, in);
    }
    for (int idx = threadIdx.x; idx < KPB_ROWS * TCH; idx += KP_THREADS) {
      const int r = idx / TCH, c = (idx % TCH) * 8;
      const int row = tile * KPB_ROWS + r;
      const bool in = row < rows;
      const long long at = static_cast<long long>(in ? row % p.Skv : 0) * KP_HALF + c;
      cp_async_16(dst + 2 * S::RAW + r * KPB_LDT + c, cg + at, in);
      cp_async_16(dst + 2 * S::RAW + S::TAB + r * KPB_LDT + c, sg + at, in);
    }
    cp_async_commit();
  };

  // copy groups: Wk, then Wv, then the first tile, then one per tile
  for (int i = threadIdx.x; i < KP_D; i += KP_THREADS)
    bks[i] = p.bk[i], bvs[i] = p.bv[i];
  uint32_t fk[MKS][4][2], fv[MKS][4][2];
  load_weights(p.wk);
  cp_async_wait_all();
  __syncthreads();
  fragments(fk, 16 * warp, KP_HALF + 16 * warp);  // K n-tile j: 16w + 8j, 128 + 16w + 8(j - 2)
  __syncthreads();
  load_weights(p.wv);
  int tile = blockIdx.x;
  if (tile < n_tiles) load(tile, 0);
  else cp_async_commit();
  cp_async_wait_newest_pending();  // Wv
  __syncthreads();
  fragments(fv, 32 * warp, 32 * warp + 16);  // V n-tile j: 32w + 8j

  const int a_off = (lane & 15) * LDM + 8 * (lane >> 4);  // ldmatrix: an A operand, 16 x 16
  __nv_bfloat16* ok = staged;                       // [KPB_ROWS][KPB_LDO]
  __nv_bfloat16* ov = staged + KPB_ROWS * KPB_LDO;
  const int grid = gridDim.x;
  for (int it = 0; tile < n_tiles; tile += grid, ++it) {
    // the other stage was last read by the previous tile, and every warp is
    // done with the staged weights or the previous tile's rows: both before
    // the previous barrier
    if (tile + grid < n_tiles) load(tile + grid, (it + 1) & 1);
    else cp_async_commit();  // empty: keeps "all but the newest group" = this tile
    cp_async_wait_newest_pending();
    __syncthreads();
    const __nv_bfloat16* mk_s = ring + (it & 1) * S::STAGE;
    const __nv_bfloat16* mv_s = mk_s + S::RAW;
    const __nv_bfloat16* c_s = mk_s + 2 * S::RAW;
    const __nv_bfloat16* s_s = c_s + S::TAB;
#pragma unroll
    for (int mt = 0; mt < KPB_ROWS / 16; ++mt) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MKS; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, mk_s + 16 * mt * LDM + a_off + 16 * ks);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, fk[ks][j][0], fk[ks][j][1]);
      }
      // K: bias in fp32, one rounding, then the rotation of the rounded
      // values (fp32, one rounding per operation), one rounding
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = 16 * warp + 8 * j + 2 * t;
          const float k1x = round_bf16(acc[j][2 * hr] + bks[d]);
          const float k1y = round_bf16(acc[j][2 * hr + 1] + bks[d + 1]);
          const float k2x = round_bf16(acc[j + 2][2 * hr] + bks[KP_HALF + d]);
          const float k2y = round_bf16(acc[j + 2][2 * hr + 1] + bks[KP_HALF + d + 1]);
          const float2 c =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(c_s + r * KPB_LDT + d));
          const float2 s =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_s + r * KPB_LDT + d));
          *reinterpret_cast<__nv_bfloat162*>(ok + r * KPB_LDO + d) =
              __floats2bfloat162_rn(rot_lo(k1x, k2x, c.x, s.x), rot_lo(k1y, k2y, c.y, s.y));
          *reinterpret_cast<__nv_bfloat162*>(ok + r * KPB_LDO + KP_HALF + d) =
              __floats2bfloat162_rn(rot_hi(k1x, k2x, c.x, s.x), rot_hi(k1y, k2y, c.y, s.y));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MKS; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, mv_s + 16 * mt * LDM + a_off + 16 * ks);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, fv[ks][j][0], fv[ks][j][1]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = 32 * warp + 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(ov + r * KPB_LDO + ch) = __floats2bfloat162_rn(
              acc[j][2 * hr] + bvs[ch], acc[j][2 * hr + 1] + bvs[ch + 1]);
        }
      }
    }
    __syncthreads();  // the tile's rows are staged; every warp is done with this stage
    // the tile's rows of kr and vp are contiguous: whole rows of 16-byte stores
    for (int idx = threadIdx.x; idx < KPB_ROWS * OCH; idx += KP_THREADS) {
      const int r = idx / OCH, c = (idx % OCH) * 8;
      const int row = tile * KPB_ROWS + r;
      if (row >= rows) continue;
      const long long at = static_cast<long long>(row) * KP_D + c;
      *reinterpret_cast<uint4*>(kr + at) = *reinterpret_cast<const uint4*>(ok + r * KPB_LDO + c);
      *reinterpret_cast<uint4*>(vp + at) = *reinterpret_cast<const uint4*>(ov + r * KPB_LDO + c);
    }
  }
  cp_async_wait_all();  // a CTA with no tile still has its (empty) groups open
}

// fp32: three-pass TF32 on mma.sync m16n8k8 (each fp32 product as three TF32
// products, about 2^-21 of |a b|, as K1's fp32 body multiplies), 32-row
// tiles; blockIdx.y picks the matrix (0: K, 1: V), so a CTA holds one weight
// matrix in shared memory (73.7 KB at Dm = 64) and two CTAs share an SM.
// Warp w projects the same channels as in bf16 (K: 16w.. and 128 + 16w..,
// V: 32w..); the A (raw rows) and B (weights) fragments take k in the order
// (2t, 2t + 1) for lane t's slots (t, t + 4), so each is one 8-byte load
// from rows Dm + 8 floats apart (8 mod 32: a half-warp's reads of 4 rows x
// 4 lanes hit 32 distinct banks). The raw tiles stream through a 2-stage
// cp.async ring; a K CTA loads its rows of the cos/sin tables into registers
// before its products, so the rotation does not wait on device memory. An
// element's Dm products sum on the tensor cores in one pass (8 k-steps at
// Dm = 64), and the outputs leave as 8-byte stores, whole 32-byte sectors.
// (FMAs on the CUDA cores were slower.) At the cross shape it takes 0.062 ms
// on an H100 80GB HBM3 at 700 W, against the 0.031 ms its bytes need.
constexpr int KPF_ROWS = 32;

template <int DM>
struct KpF32 {
  static constexpr int LD = DM + 8;  // row stride of the weights and raw tiles, in floats
  static constexpr int RAW = KPF_ROWS * LD;
  static constexpr int SMEM = (KP_D * LD + 2 * RAW + KP_D) * static_cast<int>(sizeof(float));
};

template <int DM>
__global__ void __launch_bounds__(KP_THREADS, 2)
    flash_kvproj_project_f32_kernel(const Params p, float* kr, float* vp) {
  using S = KpF32<DM>;
  constexpr int LD = S::LD, K8 = DM / 8, CH = DM / 4;  // k-steps; 16-byte chunks of a row
  extern __shared__ __align__(16) float kpf_smem[];
  float* ws = kpf_smem;             // [KP_D][LD]: this CTA's weight matrix
  float* ring = ws + KP_D * LD;     // [stage][KPF_ROWS][LD]
  float* bs = ring + 2 * S::RAW;    // [KP_D]
  const bool is_k = blockIdx.y == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rows = p.B * p.Skv;  // < 2^31 (the launch checks)
  const int n_tiles = (rows + KPF_ROWS - 1) / KPF_ROWS;
  const float* mem = static_cast<const float*>(is_k ? p.k : p.v);
  const long long m_sb = is_k ? p.k_sb : p.v_sb, m_ss = is_k ? p.k_ss : p.v_ss;
  const float* w = static_cast<const float*>(is_k ? p.wk : p.wv);
  float* out = is_k ? kr : vp;
  const float* cg = static_cast<const float*>(p.cos);
  const float* sg = static_cast<const float*>(p.sin);

  for (int idx = threadIdx.x; idx < KP_D * CH; idx += KP_THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    cp_async_16(ws + r * LD + c, w + r * DM + c, true);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < KP_D; i += KP_THREADS) bs[i] = (is_k ? p.bk : p.bv)[i];
  auto load = [&](int tile, int stage) {  // rows past B*Skv are zero-filled
    float* dst = ring + stage * S::RAW;
    for (int idx = threadIdx.x; idx < KPF_ROWS * CH; idx += KP_THREADS) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const int row = tile * KPF_ROWS + r;
      const bool in = row < rows;
      const int b = in ? row / p.Skv : 0, key = in ? row % p.Skv : 0;
      cp_async_16(dst + r * LD + c, mem + b * m_sb + key * m_ss + c, in);
    }
    cp_async_commit();
  };
  int tile = blockIdx.x;
  if (tile < n_tiles) load(tile, 0);
  else cp_async_commit();

  // channel base of n-tile j: K 16w + 8j (j < 2), 128 + 16w + 8(j - 2); V 32w + 8j
  const auto chan = [&](int j) {
    return is_k ? (j < 2 ? 0 : KP_HALF) + 16 * warp + 8 * (j & 1) : 32 * warp + 8 * j;
  };
  const int grid = gridDim.x;
  for (int it = 0; tile < n_tiles; tile += grid, ++it) {
    if (tile + grid < n_tiles) load(tile + grid, (it + 1) & 1);
    else cp_async_commit();  // empty: keeps "all but the newest group" = this tile
    cp_async_wait_newest_pending();
    __syncthreads();
    // a K CTA's rows of the tables: rows 16mt + g + 8hr, columns d = 16w + 8j + 2t
    float2 tc[2][2][2], ts[2][2][2];  // [mt][hr][j]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = tile * KPF_ROWS + 16 * mt + g + 8 * hr;
        const long long at = static_cast<long long>(row < rows ? row % p.Skv : 0) * KP_HALF;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          tc[mt][hr][j] = ts[mt][hr][j] = make_float2(0.f, 0.f);
          if (is_k) {
            const int d = 16 * warp + 8 * j + 2 * t;
            tc[mt][hr][j] = *reinterpret_cast<const float2*>(cg + at + d);
            ts[mt][hr][j] = *reinterpret_cast<const float2*>(sg + at + d);
          }
        }
      }
    const float* xs = ring + (it & 1) * S::RAW;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        const float* xa = xs + (16 * mt + g) * LD + 8 * kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(xa);
        const float2 x1 = *reinterpret_cast<const float2*>(xa + 8 * LD);
        uint32_t ahi[4], alo[4];
        split_tf32_int(x0.x, ahi[0], alo[0]);
        split_tf32_int(x1.x, ahi[1], alo[1]);
        split_tf32_int(x0.y, ahi[2], alo[2]);
        split_tf32_int(x1.y, ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b =
              *reinterpret_cast<const float2*>(ws + (chan(j) + g) * LD + 8 * kk + 2 * t);
          mma_3xtf32_int(acc[j], ahi, alo, b.x, b.y);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = tile * KPF_ROWS + 16 * mt + g + 8 * hr;
        if (row >= rows) continue;
        float* dst = out + static_cast<long long>(row) * KP_D;
        if (is_k) {
          // bias in fp32 (kp in q's dtype, fp32: no rounding), then the rotation
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = 16 * warp + 8 * j + 2 * t;
            const float k1x = acc[j][2 * hr] + bs[d], k1y = acc[j][2 * hr + 1] + bs[d + 1];
            const float k2x = acc[j + 2][2 * hr] + bs[KP_HALF + d];
            const float k2y = acc[j + 2][2 * hr + 1] + bs[KP_HALF + d + 1];
            const float2 c = tc[mt][hr][j], s = ts[mt][hr][j];
            *reinterpret_cast<float2*>(dst + d) =
                make_float2(rot_lo(k1x, k2x, c.x, s.x), rot_lo(k1y, k2y, c.y, s.y));
            *reinterpret_cast<float2*>(dst + KP_HALF + d) =
                make_float2(rot_hi(k1x, k2x, c.x, s.x), rot_hi(k1y, k2y, c.y, s.y));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = chan(j) + 2 * t;
            *reinterpret_cast<float2*>(dst + ch) =
                make_float2(acc[j][2 * hr] + bs[ch], acc[j][2 * hr + 1] + bs[ch + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait_all();  // a CTA with no tile still has its weight copies in flight
}

// K4, part two: K1's attention bodies on (q, kr, vp) under K4's names
template <int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_kvproj_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const Params p) {
  fwd_wgmma_body<DV>(tm_q, tm_k, tm_v, p);
}

template <int DP>
__global__ void __launch_bounds__(F_THREADS, F32Tile<DP>::MIN_CTAS)
    flash_kvproj_tf32_kernel(const Params p) {
  flash_tf32_body<DP>(p);
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

// K1's kernels or, for K2 and K4, the same bodies under their own names
template <int DV, Caller C>
constexpr auto wgmma_kernel() {
  if constexpr (C == Caller::K1)
    return &flash_fwd_wgmma_kernel<DV>;
  else if constexpr (C == Caller::K2)
    return &flash_rope_wgmma_kernel<DV>;
  else
    return &flash_kvproj_wgmma_kernel<DV>;
}

template <int DP, Caller C>
constexpr auto tf32_kernel() {
  if constexpr (C == Caller::K1)
    return &flash_fwd_tf32_kernel<DP>;
  else if constexpr (C == Caller::K2)
    return &flash_rope_tf32_kernel<DP>;
  else
    return &flash_kvproj_tf32_kernel<DP>;
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

// K1 (C = K1), K2's attention on the rotated K (C = K2: D = 64, 128, 256) or
// K4's on the projected, rotated K and the projected V (C = K4: D = 256)
template <Caller C>
cudaError_t dispatch(bool bf16, const Params& p, cudaStream_t stream) {
  return by_width(bf16, p.D, [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    if constexpr (W < 0 || (C == Caller::K2 && W != 64 && W != 128 && W != 256) ||
                  (C == Caller::K4 && W != KP_D)) {
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

// SMs of the current device (1 if unknown)
int sm_count() {
  int dev = 0, n_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return n_sm;
}

// The most kv splits that keep the grid in one wave of resident CTAs
// (`per_sm` of them on each SM), at least 8 kv tiles each.
int kv_splits(int per_sm, int rows, int tile, int B, int H, int Sq, int Skv) {
  const int n_sm = sm_count();
  const long long ctas = static_cast<long long>((Sq + rows - 1) / rows) * B * H;
  const long long n_tiles = (Skv + tile - 1) / tile;
  long long n = static_cast<long long>(per_sm) * n_sm / ctas;
  if (n > n_tiles / 8) n = n_tiles / 8;
  return static_cast<int>(n < 1 ? 1 : n);
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

// K4's projections and rotation: p.k, p.v (mem_k, mem_v) -> kr, vp [B, Skv,
// 256] contiguous in q's dtype; a grid of resident CTAs walks the row tiles
template <int DM>
cudaError_t launch_project_dm(bool bf16, const Params& p, void* kr, void* vp,
                              cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.Skv;
  if (rows > 2147483647ll) return cudaErrorInvalidValue;
  const int n_sm = sm_count();
  if (bf16) {
    constexpr auto kernel = &flash_kvproj_project_bf16_kernel<DM>;
    constexpr int smem = KpBf16<DM>::SMEM;
    const long long tiles = (rows + KPB_ROWS - 1) / KPB_ROWS;
    const int grid = static_cast<int>(tiles < 2ll * n_sm ? tiles : 2ll * n_sm);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, KP_THREADS, smem, stream>>>(p, static_cast<__nv_bfloat16*>(kr),
                                               static_cast<__nv_bfloat16*>(vp));
  } else {  // blockIdx.y: K, V
    constexpr auto kernel = &flash_kvproj_project_f32_kernel<DM>;
    constexpr int smem = KpF32<DM>::SMEM;
    const long long tiles = (rows + KPF_ROWS - 1) / KPF_ROWS;
    const dim3 grid(static_cast<unsigned>(tiles < n_sm ? tiles : n_sm), 2);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, KP_THREADS, smem, stream>>>(p, static_cast<float*>(kr), static_cast<float*>(vp));
  }
  return cudaGetLastError();
}

cudaError_t launch_project(bool bf16, const Params& p, void* kr, void* vp, cudaStream_t stream) {
  switch (p.Dm) {
    case 32: return launch_project_dm<32>(bf16, p, kr, vp, stream);
    case 64: return launch_project_dm<64>(bf16, p, kr, vp, stream);
    default: return cudaErrorInvalidValue;
  }
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
  p.rel = nullptr;
  p.rel_sb = p.rel_sh = p.rel_ss = 0;
  p.Kh = p.Kw = 0;
  return p;
}

// The relative-position attention at one width: K1's tensor maps, one CTA per
// 128 query rows of a (b, h), no kv split.
template <int DV>
cudaError_t launch_relpos(const Params& p, cudaStream_t stream) {
  using S = FwdWg<DV, true>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, p.q, p.B, p.H, p.Sq, p.D, p.q_sb, p.q_sh, p.q_ss, WG_BQ) ||
      !make_map(&mk, p.k, p.B, p.H, p.Skv, p.D, p.k_sb, p.k_sh, p.k_ss, S::BK) ||
      !make_map(&mv, p.v, p.B, p.H, p.Skv, p.D, p.v_sb, p.v_sh, p.v_ss, S::BK))
    return cudaErrorInvalidValue;
  constexpr auto kernel = &flash_relpos_wgmma_kernel<DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + WG_BQ - 1) / WG_BQ, p.B * p.H, 1);
  kernel<<<grid, WG_THREADS, S::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
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

// K1's kv split for these shapes on the current device, and K2's and K4's
// (they run K1's body; K4 with H = 1): the most splits that keep the grid
// in one wave of resident CTAs, at least 8 kv tiles each; -1 for an
// unsupported D.
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

// K4's projections and rotation alone: kr = rotate(round(mem_k . wk^T + bk))
// and vp = round(mem_v . wv^T + bv), each [B, Skv, D] contiguous in q's dtype
// (allocated by the caller); D = 256, Dm in {32, 64}; mem_k, mem_v [B, Skv,
// Dm] with batch / row strides (unit stride along Dm, rows 16-byte aligned);
// wk, wv [D, Dm] contiguous in q's dtype; bk, bv [D] contiguous in fp32;
// cos/sin [Skv, D/2] in q's dtype, contiguous.
extern "C" int sam2_flash_attention_kvproj_project(
    const void* mem_k, const void* mem_v, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* cos, const void* sin, void* kr, void* vp, int dtype,
    int B, int Skv, int D, int Dm, long long mk_sb, long long mk_ss,
    long long mv_sb, long long mv_ss, void* stream) {
  if (B <= 0 || Skv <= 0 || D != KP_D || (Dm != 32 && Dm != 64) || (dtype != 0 && dtype != 1) ||
      wk == nullptr || wv == nullptr || bk == nullptr || bv == nullptr || cos == nullptr ||
      sin == nullptr || kr == nullptr || vp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(nullptr, mem_k, mem_v, nullptr, cos, sin, nullptr, nullptr, nullptr,
                         nullptr, B, 1, 0, Skv, D, 1, 0, 0, 0, mk_sb, 0, mk_ss, mv_sb, 0, mv_ss, 0,
                         0, 0, 0, 1.f);
  p.wk = wk; p.wv = wv;
  p.bk = static_cast<const float*>(bk); p.bv = static_cast<const float*>(bv);
  p.Dm = Dm;
  return static_cast<int>(launch_project(dtype == 1, p, kr, vp, static_cast<cudaStream_t>(stream)));
}

// K4: the projections and the rotation into kr and vp (as
// sam2_flash_attention_kvproj_project), then K1's attention body on (q, kr,
// vp) under K4's kernel names, with K1's kv split and combine. One head,
// D = 256, Dm in {32, 64}. q [B, 1, Sq, D] (rotated) with batch / row
// strides; out [B, Sq, D] with batch / row strides, lse [B, Sq]; the kv split
// and its scratch as K1's (part_o [n_split, B, Sq, D], part_lse [n_split, B,
// Sq]); the other arguments as sam2_flash_attention_kvproj_project's.
extern "C" int sam2_flash_attention_kvproj_fwd(
    const void* q, const void* mem_k, const void* mem_v, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* mask, const void* cos, const void* sin, void* kr,
    void* vp, void* part_o, void* part_lse, void* o, void* lse, int dtype, int B,
    int Sq, int Skv, int D, int Dm, int n_split,
    long long q_sb, long long q_ss, long long mk_sb, long long mk_ss,
    long long mv_sb, long long mv_ss, long long o_sb, long long o_ss,
    long long mask_sb, float scale, void* stream) {
  if (!valid_args(dtype, B, 1, Sq, Skv, D, n_split, part_o, part_lse) || D != KP_D ||
      (Dm != 32 && Dm != 64) || wk == nullptr || wv == nullptr || bk == nullptr ||
      bv == nullptr || cos == nullptr || sin == nullptr || kr == nullptr || vp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, mem_k, mem_v, mask, cos, sin, part_o, part_lse, o, lse, B, 1, Sq, Skv,
                         D, n_split, q_sb, 0, q_ss, mk_sb, 0, mk_ss, mv_sb, 0, mv_ss, o_sb, 0,
                         o_ss, mask_sb, scale);
  p.wk = wk; p.wv = wv;
  p.bk = static_cast<const float*>(bk); p.bv = static_cast<const float*>(bv);
  p.Dm = Dm;
  const bool bf16 = dtype == 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_project(bf16, p, kr, vp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.k = kr;
  p.v = vp;
  p.k_ss = p.v_ss = D;
  p.k_sh = p.v_sh = static_cast<long long>(Skv) * D;
  p.k_sb = p.v_sb = p.k_sh;
  return static_cast<int>(dispatch<Caller::K4>(bf16, p, st));
}

// The relative-position attention of SAM's ViT blocks, bf16, no mask, no kv
// split, no lse: out = softmax(q . k^T * scale + bias) . v, the keys a Kh x Kw
// grid in raster order (Skv = Kh * Kw; the queries the same grid, Sq = Skv)
// and bias[i, kh * Kw + kw] = rel[i, qh - kh + Kh - 1] + rel[i, 2Kh - 1 + qw -
// kw + Kw - 1] for query i = qh * Kw + qw (upstream's decomposed
// relative-position bias from the products of q with its two tables). q, k,
// v [B, H, S, D] with batch / head / row strides (unit stride along D, rows
// 16-byte aligned), D in {64, 80}; rel [B, H, Sq, 2 (Kh + Kw) - 2] bf16 with
// batch / head / row strides and a unit stride along its rows; Kh <= 64,
// 8 <= Kw <= 64 even.
extern "C" int sam2_flash_attention_relpos_fwd(
    const void* q, const void* k, const void* v, const void* rel, void* o, int B, int H,
    int Sq, int Skv, int D, int Kh, int Kw, long long rel_sb, long long rel_sh, long long rel_ss,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale, void* stream) {
  if (!valid_args(1, B, H, Sq, Skv, D, 1, nullptr, nullptr) || (D != 64 && D != 80) ||
      rel == nullptr || Kh < 1 || Kw < 8 || Kh > MAX_K || Kw > MAX_K || Kw % 2 ||
      static_cast<long long>(Kh) * Kw != Skv || Sq != Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr, o, nullptr, B, H,
                         Sq, Skv, D, 1, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                         o_sh, o_ss, 0, scale);
  p.rel = rel;
  p.rel_sb = rel_sb;
  p.rel_sh = rel_sh;
  p.rel_ss = rel_ss;
  p.Kh = Kh;
  p.Kw = Kw;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? launch_relpos<64>(p, st) : launch_relpos<80>(p, st));
}

