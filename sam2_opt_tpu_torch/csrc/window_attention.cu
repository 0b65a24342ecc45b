// Per-window softmax attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces three Pallas TPU kernels of sam2_opt_tpu/kernels/window_attention.py,
// which compute one function in three TPU layouts:
//   K5 _kernel        [N, S, D]            (window_attention)
//   K6 _kernel_3d     [N, S, heads, d]     (window_flash_3d)
//   K7 _packed_kernel [N, Sq/Skv, heads, d] (packed_window_attention; its
//                     block-diagonal packing only shaped the MXU's products)
// and the bench tool's two (tools/bench_window_flash.py::_kern_h, _kern_3d).
// Here the layout is strides: every (window, head) pair is one attention of
// Sq query rows over Skv keys, at window / head / row strides given per
// tensor (unit stride along the head dim), so Hiera's q/k/v views of one
// [N, S, 3, heads, d] projection are read where they lie and the output is
// written as [N, S, heads, d] for the output projection. What it computes
// is the Pallas kernels' plain softmax:
//   s = (q . k^T) * scale in fp32, scale = 1/sqrt(D)
//   p = exp(s - rowmax(s)) / rowsum(exp(s - rowmax(s))), rounded to v's dtype
//   out = p . v in fp32, rounded to q's dtype
// with no mask: the zero-padded tokens of window_partition attend, as they
// do in the JAX package.
//
// bf16 normalizes the probabilities before it rounds them, as the reference
// does, so its CTA walks the keys twice: pass 1 forms the logits and keeps
// the running row max and row sum, pass 2 forms them again and multiplies
// the normalized probabilities into V. In fp32 that rounding is the
// identity, so fp32 makes one pass with an online softmax (O rescaled as the
// row max moves, one division at the end): the same function up to the
// order of fp32 roundings.
//
// Bound. At hiera-L's shapes (1024 windows of 64 tokens at 2 heads, 1024 x 16
// at 4, 16 x 256 at 8, 16 x 64 at 16; D = 72) the function does 4*S*D
// operations per query row (74K at S = 256) against 4*D*itemsize bytes of
// q, k, v and out. bf16: 128 operations per byte at S = 256, under the
// card's 295, so bound by bytes (22.5, 11.3, 5.6 and 2.8 us at 3.35 TB/s).
// fp32 on the tensor cores runs three TF32 products per fp32 product, so its
// rate is a third of TF32's 495 TFLOP/s: S/4 operations per byte against a
// ridge of 49, bound by bytes below S = 196 (45.1, 22.5 and 5.6 us at
// stages 1, 2 and 4) and by operations at stage 3 (14.6 us). Design:
//  - one launch per block, logits never leave the SM (an unfused graph
//    writes and reads the [pairs, S, S] logits and probabilities);
//  - thousands of 16-row windows (stage 2) do not get a 64-row tile each:
//    a CTA of 4 warps gives each warp 16 query rows and packs up to 4
//    (window, head) pairs into one CTA (1 per warp at S <= 16, 2 at S <= 32),
//    each group of warps with its own kv tiles in shared memory;
//  - bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulation):
//    Q fragments straight from device memory, K and V tiles of 32 keys
//    through a 2-stage cp.async ring and ldmatrix, S kept in registers and
//    re-packed as the A operand of P . V, exp2 on the SFU. The second pass
//    re-reads K from L2 (or shared memory when the window has one kv tile);
//    at 6*S*D operations per row bf16 stays bound by bytes;
//  - fp32 runs on the tensor cores as three TF32 products per fp32 product
//    (mma.sync m16n8k8, each operand split as hi + lo, about 2^-21 of |a b|
//    per product), as K3's fp32 route does and the library's fp32 attention
//    does: S and P never leave the registers, K and V in a ring of up to 2
//    tiles of 32 keys per pair group (a window of up to 64 keys is loaded
//    once), one pass. Each tile's P . V products go into a zeroed partial
//    that is added to the rescaled output in fp32, as K3 needed over 28,704
//    keys, so the error does not grow with the window. 55 KB of shared
//    memory and at most 128 registers a thread at D = 72: four CTAs an SM.
//    The operand split takes two integer operations (split_tf32_int), not two
//    conversions: with it and the fourth CTA, stage 3 ran in 0.076 ms, not
//    0.140 (on an H100 80GB HBM3 at 700 W).
// wgmma's tf32 form takes K-major operands only (V in P . V is MN-major), so
// fp32 stays on mma.sync; wgmma and TMA for bf16 are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mma_3xtf32_int;
using hopper::mma_tf32;
using hopper::pack_bf16;
using hopper::split_tf32_int;

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;  // query rows per warp
constexpr int KT = 32;    // keys per kv tile
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int N, H, Sq, Skv, D;
  long long q_sn, q_sh, q_ss;
  long long k_sn, k_sh, k_ss;
  long long v_sn, v_sh, v_ss;
  long long o_sn, o_sh, o_ss;
  float scale;
  int wpp;  // warps per (window, head) pair in a CTA: 1, 2 or 4
};

// Which pair and rows a warp owns: CTA x packs WARPS / wpp pairs, y walks
// the query rows in steps of wpp * 16.
struct Slot {
  int grp, gtid, gthreads, q0;
  bool live;
  long long off_q, off_k, off_v, off_o;
};

__device__ __forceinline__ Slot slot_of(const Params& p) {
  const int warp = threadIdx.x >> 5;
  const int ppc = WARPS / p.wpp;
  Slot s;
  s.grp = warp / p.wpp;
  s.gthreads = p.wpp * 32;
  s.gtid = threadIdx.x - s.grp * s.gthreads;
  s.q0 = (blockIdx.y * p.wpp + warp % p.wpp) * ROWS;
  const long long pair = static_cast<long long>(blockIdx.x) * ppc + s.grp;
  s.live = pair < static_cast<long long>(p.N) * p.H;
  const long long n = s.live ? pair / p.H : 0, h = s.live ? pair % p.H : 0;
  s.off_q = n * p.q_sn + h * p.q_sh;
  s.off_k = n * p.k_sn + h * p.k_sh;
  s.off_v = n * p.v_sn + h * p.v_sh;
  s.off_o = n * p.o_sn + h * p.o_sh;
  return s;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int ld_bf16(int dp) { return dp + 8; }  // odd multiple of 16 B

template <int DP>
constexpr int smem_bf16(int ppc) {  // {K, V} x 2 stages per pair group
  return ppc * 4 * KT * ld_bf16(DP) * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>
__global__ void __launch_bounds__(THREADS) window_attn_bf16_kernel(const Params p) {
  constexpr int LDK = ld_bf16(DP);
  constexpr int KS = DP / 16;  // k-steps of Q . K^T
  constexpr int ND = DP / 8;   // 8-column slices of the output
  constexpr int NT = KT / 8;   // 8-key slices of S
  constexpr int TILE = KT * LDK;
  extern __shared__ __align__(16) __nv_bfloat16 smem_b[];

  const Slot sl = slot_of(p);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  __nv_bfloat16* group = smem_b + sl.grp * 4 * TILE;  // [stage][K, V][KT][LDK]
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + sl.off_q;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + sl.off_k;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + sl.off_v;

  // the padded head-dim columns [D, DP) stay zero: the copies never write them
  const int total = (WARPS / p.wpp) * 4 * TILE;
  for (int i = threadIdx.x * 8; i < total; i += THREADS * 8)
    *reinterpret_cast<uint4*>(smem_b + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int n_tiles = (p.Skv + KT - 1) / KT;
  const int steps = 2 * n_tiles;  // pass 1: max and sum; pass 2: P . V
  const int chunks = p.D / 8;     // 16-byte chunks per row
  auto load = [&](int step, int stage) {
    const int k0 = (step % n_tiles) * KT;
    const bool with_v = step >= n_tiles;
    __nv_bfloat16* ks = group + stage * 2 * TILE;
    for (int idx = sl.gtid; idx < KT * chunks; idx += sl.gthreads) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      const bool in = sl.live && k0 + r < p.Skv;  // rows past Skv are zero-filled
      const long long row = in ? k0 + r : 0;
      cp_async_16(ks + r * LDK + c, kg + row * p.k_ss + c, in);
      if (with_v) cp_async_16(ks + TILE + r * LDK + c, vg + row * p.v_ss + c, in);
    }
  };
  load(0, 0);
  cp_async_commit();

  // this warp's 16 query rows as the A operand, straight from device memory
  uint32_t qa[KS][4];
  auto q_pair = [&](int row, int col) -> uint32_t {
    return (sl.live && row < p.Sq && col < p.D)
               ? *reinterpret_cast<const uint32_t*>(qg + row * p.q_ss + col)
               : 0u;
  };
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = q_pair(sl.q0 + g, 16 * ks + 2 * t);
    qa[ks][1] = q_pair(sl.q0 + g + 8, 16 * ks + 2 * t);
    qa[ks][2] = q_pair(sl.q0 + g, 16 * ks + 8 + 2 * t);
    qa[ks][3] = q_pair(sl.q0 + g + 8, 16 * ks + 8 + 2 * t);
  }

  // rows g and g + 8 of the warp's tile; logits kept in the log2 domain
  const float scale_log2 = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1, (step + 1) & 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this step
    cp_async_wait_newest_pending();
    __syncthreads();
    const __nv_bfloat16* ks_tile = group + (step & 1) * 2 * TILE;
    const __nv_bfloat16* vs_tile = ks_tile + TILE;
    const int k0 = (step % n_tiles) * KT;

    // S = Q . K^T: [16 rows][32 keys] per warp, fp32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
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
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + 8 * nt + 2 * t + j < p.Skv;
        s[nt][j] = valid ? s[nt][j] * scale_log2 : NEG_INF;
        s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : NEG_INF;
      }

    if (step < n_tiles) {
      // pass 1: running row max and row sum
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          sum += exp2f(s[nt][2 * i] - m_new) + exp2f(s[nt][2 * i + 1] - m_new);
        l[i] = l[i] * exp2f(m[i] - m_new) + quad_sum(sum);
        m[i] = m_new;
      }
    } else {
      if (step == n_tiles) inv_l[0] = 1.f / l[0], inv_l[1] = 1.f / l[1];
      // pass 2: O += P . V with P normalized, rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float pr[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pr[h][j] = exp2f(s[2 * kk + h][j] - m[j >> 1]) * inv_l[j >> 1];
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
        const __nv_bfloat16* vrow = vs_tile + (16 * kk + (lane & 15)) * LDK + 8 * (lane >> 4);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + 8 * nd);
          mma_bf16(o[nd], pa, vb[0], vb[1]);
          mma_bf16(o[nd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!sl.live) return;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + sl.off_o;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = sl.q0 + g + 8 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
            __floats2bfloat162_rn(o[nd][2 * i], o[nd][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one pass, three-pass TF32 on the tensor cores
// ---------------------------------------------------------------------------
//
// A warp owns 16 query rows of one pair; they are copied once to shared
// memory, the A operand of S = Q K^T (one float2 load per row and 8-column
// chunk, split as it is read), so the registers hold the output, S and P
// only. Both products take k in the order (2t, 2t+1) for lane t's mma slots
// (t, t+4), so a lane's S accumulator of 8 keys is already the A fragment of
// P . V for those keys: P never leaves the registers. K and V tiles of 32
// keys stream through a ring of up to 2 stages of 16-byte cp.async copies
// per pair group; a window of up to 2 tiles (64 keys) is loaded once. Q and
// K rows are DP or DP + 8 floats apart (= 8 mod 16: a half-warp's float2
// reads of 4 rows x 4 lanes hit 32 distinct banks), V rows DP + 4 (= 4 mod
// 16: the scalar reads of rows 2t and 2t + 1 do too).

constexpr int F_KT = 32;         // keys per kv tile
constexpr int F_MAX_STAGES = 2;  // kv tiles in flight per pair group

__host__ __device__ constexpr int ldk_f32(int dp) { return dp % 16 == 8 ? dp : dp + 8; }
__host__ __device__ constexpr int ldv_f32(int dp) { return dp + 4; }

// stages and rows per stage of a pair group's ring, for Skv keys
__host__ __device__ inline int f32_stages(int Skv) {
  const int n_tiles = (Skv + F_KT - 1) / F_KT;
  return n_tiles < F_MAX_STAGES ? n_tiles : F_MAX_STAGES;
}
__host__ __device__ inline int f32_stage_rows(int Skv) {
  return Skv < F_KT ? (Skv + 7) / 8 * 8 : F_KT;
}

template <int DP>
int smem_f32(int ppc, int Skv) {  // {K, V} ring per pair group + Q per warp
  return (ppc * f32_stages(Skv) * f32_stage_rows(Skv) * (ldk_f32(DP) + ldv_f32(DP)) +
          WARPS * ROWS * ldk_f32(DP)) *
         static_cast<int>(sizeof(float));
}

// all but the newest `pending` (0 or 1) copy groups have landed
__device__ __forceinline__ void cp_async_wait_stages(int pending) {
  if (pending == 1)
    cp_async_wait_newest_pending();
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 4) window_attn_f32_kernel(const Params p) {
  constexpr int LDK = ldk_f32(DP), LDV = ldv_f32(DP);
  constexpr int KC = DP / 8;     // 8-wide chunks of the head dim
  constexpr int NT = F_KT / 8;   // 8-key chunks of a kv tile
  constexpr int C4 = DP / 4;     // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem_f[];

  const Slot sl = slot_of(p);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  const int n_tiles = (p.Skv + F_KT - 1) / F_KT;
  const int R = f32_stages(p.Skv), KR = f32_stage_rows(p.Skv);
  const int stage_floats = KR * (LDK + LDV);
  float* group = smem_f + sl.grp * R * stage_floats;  // [R][K: KR x LDK | V: KR x LDV]
  float* qs = smem_f + (WARPS / p.wpp) * R * stage_floats + (threadIdx.x >> 5) * ROWS * LDK;
  const float* qg = static_cast<const float*>(p.q) + sl.off_q;
  const float* kg = static_cast<const float*>(p.k) + sl.off_k;
  const float* vg = static_cast<const float*>(p.v) + sl.off_v;

  // keys past Skv are zero-filled, so their p (0) meets finite v
  auto load = [&](int tile, int stage) {
    float* ks = group + stage * stage_floats;
    float* vs = ks + KR * LDK;
    for (int idx = sl.gtid; idx < KR * C4; idx += sl.gthreads) {
      const int r = idx / C4, c = (idx % C4) * 4;
      const int key = tile * F_KT + r;
      const bool in = sl.live && key < p.Skv;
      const long long row = in ? key : 0;
      cp_async_16(ks + r * LDK + c, kg + row * p.k_ss + c, in);
      cp_async_16(vs + r * LDV + c, vg + row * p.v_ss + c, in);
    }
  };
  // this warp's 16 query rows (zero past Sq), in the first copy group
  for (int idx = lane; idx < ROWS * C4; idx += 32) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const bool in = sl.live && sl.q0 + r < p.Sq;
    cp_async_16(qs + r * LDK + c, qg + (in ? sl.q0 + r : 0) * p.q_ss + c, in);
  }
  for (int st = 0; st < R - 1; ++st) {
    load(st, st);
    cp_async_commit();
  }

  // online softmax in the log2 domain: running max m and (per-lane) sum l
  const float scale_log2 = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[KC][4];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) o[kk][0] = o[kk][1] = o[kk][2] = o[kk][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + R - 1 < n_tiles) load(tile + R - 1, (tile + R - 1) % R);
    cp_async_commit();  // possibly empty: keeps "all but the R - 1 newest groups" = this tile
    cp_async_wait_stages(R - 1);
    __syncthreads();
    const float* ks = group + (tile % R) * stage_floats;
    const float* vs = ks + KR * LDK;
    const int k0 = tile * F_KT;

    // S = Q . K^T: [16 rows][32 keys], chunks past Skv skipped
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      // rows g and g + 8, columns 8kk + 2t and + 1
      const float2 q0 = *reinterpret_cast<const float2*>(qs + g * LDK + 8 * kk + 2 * t);
      const float2 q1 = *reinterpret_cast<const float2*>(qs + (g + 8) * LDK + 8 * kk + 2 * t);
      uint32_t ahi[4], alo[4];
      split_tf32_int(q0.x, ahi[0], alo[0]);
      split_tf32_int(q1.x, ahi[1], alo[1]);
      split_tf32_int(q0.y, ahi[2], alo[2]);
      split_tf32_int(q1.y, ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (k0 + 8 * n < p.Skv) {
          const float2 kb =
              *reinterpret_cast<const float2*>(ks + (8 * n + g) * LDK + 8 * kk + 2 * t);
          mma_3xtf32_int(s[n], ahi, alo, kb.x, kb.y);
        }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = k0 + 8 * n + 2 * t + (e & 1) < p.Skv ? s[n][e] * scale_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    // P as the A fragment of P . V, split: slots (t, t + 4) hold keys (2t, 2t + 1)
    uint32_t phi[NT][4], plo[NT][4];
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = exp2f(s[n][e] - m[e >> 1]);
        row_sum[e >> 1] += pr[e];
      }
      split_tf32_int(pr[0], phi[n][0], plo[n][0]);
      split_tf32_int(pr[2], phi[n][1], plo[n][1]);
      split_tf32_int(pr[1], phi[n][2], plo[n][2]);
      split_tf32_int(pr[3], phi[n][3], plo[n][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_sum[i];

    // O = O * alpha + P . V: each 8-column chunk's products go into a zeroed
    // partial added in fp32 (the tensor cores' accumulation does not round
    // to nearest; see flash_attention_bwd.cu)
#pragma unroll
    for (int nd = 0; nd < KC; ++nd) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (k0 + 8 * n < p.Skv) {
          const float* vrow = vs + (8 * n + 2 * t) * LDV + 8 * nd + g;
          mma_3xtf32_int(part, phi[n], plo[n], vrow[0], vrow[LDV]);
        }
      o[nd][0] = fmaf(o[nd][0], alpha[0], part[0]);
      o[nd][1] = fmaf(o[nd][1], alpha[0], part[1]);
      o[nd][2] = fmaf(o[nd][2], alpha[1], part[2]);
      o[nd][3] = fmaf(o[nd][3], alpha[1], part[3]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!sl.live) return;
  float* og = static_cast<float*>(p.o) + sl.off_o;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = sl.q0 + g + 8 * i;
    const float inv_l = 1.f / quad_sum(l[i]);  // every row sees at least one key
    if (row >= p.Sq) continue;
#pragma unroll
    for (int nd = 0; nd < KC; ++nd)
      *reinterpret_cast<float2*>(og + row * p.o_ss + 8 * nd + 2 * t) =
          make_float2(o[nd][2 * i] * inv_l, o[nd][2 * i + 1] * inv_l);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ppc = WARPS / p.wpp;
  const long long pairs = static_cast<long long>(p.N) * p.H;
  const int row_blocks = (p.Sq + ROWS - 1) / ROWS;
  const dim3 grid(static_cast<unsigned>((pairs + ppc - 1) / ppc), (row_blocks + p.wpp - 1) / p.wpp);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  return launch(window_attn_bf16_kernel<DP>, smem_bf16<DP>(WARPS / p.wpp), p, stream);
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  return launch(window_attn_f32_kernel<DP>, smem_f32<DP>(WARPS / p.wpp, p.Skv), p, stream);
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_bf16<16>(p, stream);
    case 2: return launch_bf16<32>(p, stream);
    case 3: return launch_bf16<48>(p, stream);
    case 4: return launch_bf16<64>(p, stream);
    case 5: return launch_bf16<80>(p, stream);
    case 6: return launch_bf16<96>(p, stream);
    case 7: return launch_bf16<112>(p, stream);
    case 8: return launch_bf16<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 runs at the head dim itself (a multiple of 8): no padded k-steps
cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  switch (p.D / 8) {
    case 1: return launch_f32<8>(p, stream);
    case 2: return launch_f32<16>(p, stream);
    case 3: return launch_f32<24>(p, stream);
    case 4: return launch_f32<32>(p, stream);
    case 5: return launch_f32<40>(p, stream);
    case 6: return launch_f32<48>(p, stream);
    case 7: return launch_f32<56>(p, stream);
    case 8: return launch_f32<64>(p, stream);
    case 9: return launch_f32<72>(p, stream);
    case 10: return launch_f32<80>(p, stream);
    case 11: return launch_f32<88>(p, stream);
    case 12: return launch_f32<96>(p, stream);
    case 13: return launch_f32<104>(p, stream);
    case 14: return launch_f32<112>(p, stream);
    case 15: return launch_f32<120>(p, stream);
    case 16: return launch_f32<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = cudaSuccess). dtype: 0 fp32,
// 1 bf16. N windows x H heads, each Sq query rows over Skv keys (1 to 1024
// each), D a multiple of 8 up to 128; strides in elements for the window,
// head and row axes of q, k, v and out (unit stride along D; rows 16-byte
// aligned, which the wrapper checks). The caller allocates out.
extern "C" int sam2_window_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int N, int H, int Sq,
    int Skv, int D,
    long long q_sn, long long q_sh, long long q_ss,
    long long k_sn, long long k_sh, long long k_ss,
    long long v_sn, long long v_sh, long long v_ss,
    long long o_sn, long long o_sh, long long o_ss,
    float scale, void* stream) {
  if (N <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || Sq > 1024 || Skv > 1024 || D <= 0 ||
      D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.N = N; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sn = q_sn; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sn = k_sn; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sn = v_sn; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sn = o_sn; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  const int row_blocks = (Sq + ROWS - 1) / ROWS;
  p.wpp = row_blocks >= 3 ? 4 : row_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? dispatch_bf16(p, st) : dispatch_f32(p, st));
}
