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
// does, so the row max and sum over every key come before any P . V. In fp32
// that rounding is the identity, so fp32 makes one pass with an online
// softmax (O rescaled as the row max moves, one division at the end): the
// same function up to the order of fp32 roundings.
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
//  - bf16, windows of more than 64 rows over up to 256 keys (stage 3): a
//    wgmma kernel fed by TMA, one CTA per (window, head) pair with the whole
//    window resident in shared memory, so K and V leave L2 once per pair,
//    and S for every key kept in registers, so each logit is formed once and
//    exponentiated once (its section below). Stage 3 runs in ~0.021 ms
//    against SDPA's ~0.023 from CUDA graph replays (the two-pass mma.sync
//    kernel this replaced: 0.036), on an H100 80GB HBM3 at 700 W
//    (chip_smoke.py);
//  - bf16, other windows: mma.sync m16n8k16 (fp32 accumulation), Q fragments
//    straight from device memory, a warp per 16 query rows; windows of up
//    to 16 rows (stage 2's thousands) packed 4 pairs to a CTA, of 17-32
//    rows 2, fewer where their windows do not fit. A pair group's whole
//    window of K and V sits in shared memory where it fits (every such
//    hiera-L stage: K in the first copy group, V in the second, so pass 1
//    (max and sum) runs while V lands, and pass 2 (the logits again, P
//    normalized and rounded in registers, P . V) reads both from shared
//    memory); a longer window streams through two stages of 128 keys.
//    Stages 1, 2 and 4 on the same card: 0.044 / 0.028 / 0.0135 ms, each
//    faster than the kernel this replaced and than SDPA;
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
// fp32 stays on mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::ex2;
using hopper::fence_regs;
using hopper::make_map;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mma_3xtf32_int;
using hopper::mma_tf32;
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
using hopper::wgmma_ss_n64;
using hopper::wgmma_wait;

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;  // the fp32 kernel's CTA
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;  // query rows per m16 block
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
  int wpp;  // warps per (window, head) pair in a CTA (mma.sync kernels)
  int ppc;  // pairs per CTA (mma.sync kernels)
  // the mma.sync bf16 kernel: kr keys a stage, n_tiles kv tiles of kr keys,
  // stages (1: the window is resident); the wgmma kernel: blocks of 64 query
  // rows a CTA
  int kr, n_tiles, stages, blocks;
};

// Which pair and rows a warp owns: CTA x packs ppc pairs of wpp warps each,
// y walks the query rows in steps of wpp * 16.
struct Slot {
  int grp, gtid, gthreads, q0;
  bool live;
  long long off_q, off_k, off_v, off_o;
};

__device__ __forceinline__ Slot slot_of(const Params& p) {
  const int warp = threadIdx.x >> 5;
  Slot s;
  s.grp = warp / p.wpp;
  s.gthreads = p.wpp * 32;
  s.gtid = threadIdx.x - s.grp * s.gthreads;
  s.q0 = (blockIdx.y * p.wpp + warp % p.wpp) * ROWS;
  const long long pair = static_cast<long long>(blockIdx.x) * p.ppc + s.grp;
  s.live = pair < static_cast<long long>(p.N) * p.H;
  const long long n = s.live ? pair / p.H : 0, h = s.live ? pair % p.H : 0;
  s.off_q = n * p.q_sn + h * p.q_sh;
  s.off_k = n * p.k_sn + h * p.k_sh;
  s.off_v = n * p.v_sn + h * p.v_sh;
  s.off_o = n * p.o_sn + h * p.o_sh;
  return s;
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync: windows of up to 64 rows, and windows of more than 256
// keys
// ---------------------------------------------------------------------------
//
// A warp owns 16 query rows of one pair (up to 16 warps a pair, 8 above
// D = 96, for the registers); a pair's warps share its K and V. Where the pair group's
// whole window fits (up to 200 KB a CTA: 512 keys at D = 72), K and V arrive
// in one burst of 16-byte cp.async copies, K in the first copy group and V
// in the second, so pass 1 (the row max and sum over every key) starts on K
// while V is still landing, and pass 2 (the logits again, P normalized and
// rounded to bf16, P . V) reads both from shared memory: each byte of K and
// V leaves L2 once per pair, and the CTA waits on two copy groups in all. A
// longer window streams through a ring of two stages of 128 keys (K alone in
// pass 1, K and V in pass 2). Within a stage the warps walk the keys 32 at a
// time: S = Q . K^T on mma.sync m16n8k16 (fp32 accumulators) with Q's
// fragments in registers for the CTA's life and K's through ldmatrix, S kept
// in registers and re-packed as P . V's A operand, V through ldmatrix.trans.

__host__ __device__ constexpr int ld_bf16(int dp) { return dp + 8; }  // odd multiple of 16 B
constexpr int B_STREAM_KEYS = 128;        // keys per stage of a streamed window
constexpr int B_RESIDENT_BYTES = 200 * 1024;  // the most a CTA's windows take
static_assert(2 * B_STREAM_KEYS * 2 * ld_bf16(128) * 2 <= B_RESIDENT_BYTES,
              "one pair's two streamed stages must fit at D = 128");

// warps a CTA may have (the kernel's launch bound, 512 or 256 threads): 128
// registers a thread at 16 warps suffice up to D = 96, above it 8 warps take
// up to 255
constexpr int bf16_max_warps(int dp) { return dp <= 96 ? 16 : 8; }

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
__global__ void __launch_bounds__(DP <= 96 ? 512 : 256) window_attn_bf16_kernel(const Params p) {
  constexpr int LDK = ld_bf16(DP);
  constexpr int KS = DP / 16;  // k-steps of Q . K^T
  constexpr int ND = DP / 8;   // 8-column slices of the output
  constexpr int NT = KT / 8;   // 8-key slices of S
  extern __shared__ __align__(16) __nv_bfloat16 smem_b[];

  const Slot sl = slot_of(p);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  const int region = p.kr * LDK;          // one K or V buffer of a stage
  __nv_bfloat16* group = smem_b + sl.grp * p.stages * 2 * region;  // [stage][K, V][kr][LDK]
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + sl.off_q;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + sl.off_k;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + sl.off_v;

  // the padded head-dim columns [D, DP) stay zero: the copies never write them
  if (p.D < DP) {
    const int pad = (DP - p.D) / 8, rows = p.ppc * p.stages * 2 * p.kr;
    for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
      *reinterpret_cast<uint4*>(smem_b + (i / pad) * LDK + p.D + 8 * (i % pad)) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // step s < n_tiles is pass 1 over kv tile s, step n_tiles + s pass 2 over
  // it; a resident window (one tile) keeps its K for pass 2 and loads V once
  const int n_tiles = p.n_tiles, steps = 2 * n_tiles;
  const int chunks = p.D / 8;  // 16-byte chunks per row
  auto load = [&](int step) {
    const int k0 = (step % n_tiles) * p.kr;
    const bool with_k = step < n_tiles || n_tiles > 1, with_v = step >= n_tiles;
    __nv_bfloat16* ks = group + (p.stages == 1 ? 0 : step & 1) * 2 * region;
    for (int idx = sl.gtid; idx < p.kr * chunks; idx += sl.gthreads) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      const bool in = sl.live && k0 + r < p.Skv;  // rows past Skv are zero-filled
      const long long row = in ? k0 + r : 0;
      if (with_k) cp_async_16(ks + r * LDK + c, kg + row * p.k_ss + c, in);
      if (with_v) cp_async_16(ks + region + r * LDK + c, vg + row * p.v_ss + c, in);
    }
  };
  load(0);
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

  // rows g and g + 8 of the warp's tile; logits in the log2 domain
  const float scale_log2 = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this step
    cp_async_wait_newest_pending();
    __syncthreads();
    const bool pass2 = step >= n_tiles;
    if (step == n_tiles) inv_l[0] = 1.f / l[0], inv_l[1] = 1.f / l[1];
    const __nv_bfloat16* ks_tile = group + (p.stages == 1 ? 0 : step & 1) * 2 * region;
    const int k_base = (step % n_tiles) * p.kr;
    const int n_sub = (min(p.kr, p.Skv - k_base) + KT - 1) / KT;

#pragma unroll 1
    for (int sub = 0; sub < n_sub; ++sub) {
      const int k0 = k_base + sub * KT;
      const __nv_bfloat16* kt = ks_tile + sub * KT * LDK;
      // S = Q . K^T: [16 rows][32 keys], fp32
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kfrag =
          kt + ((lane & 7) + 8 * (lane >> 4)) * LDK + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kfrag + 8 * nt * LDK + 16 * ks);
          mma_bf16(s[nt], qa[ks], kb[0], kb[1]);
          mma_bf16(s[nt + 1], qa[ks], kb[2], kb[3]);
        }
      const bool full = k0 + KT <= p.Skv;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool valid = full || k0 + 8 * nt + 2 * t + j < p.Skv;
          s[nt][j] = valid ? s[nt][j] * scale_log2 : NEG_INF;
          s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : NEG_INF;
        }

      if (!pass2) {
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
            sum += ex2(s[nt][2 * i] - m_new) + ex2(s[nt][2 * i + 1] - m_new);
          l[i] = l[i] * ex2(m[i] - m_new) + quad_sum(sum);
          m[i] = m_new;
        }
      } else {
        // pass 2: O += P . V with P normalized, rounded to bf16 in registers
        const __nv_bfloat16* vt = kt + region;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          float pr[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pr[h][j] = ex2(s[2 * kk + h][j] - m[j >> 1]) * inv_l[j >> 1];
          const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                  pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
          const __nv_bfloat16* vrow = vt + (16 * kk + (lane & 15)) * LDK + 8 * (lane >> 4);
#pragma unroll
          for (int nd = 0; nd < ND; nd += 2) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vrow + 8 * nd);
            mma_bf16(o[nd], pa, vb[0], vb[1]);
            mma_bf16(o[nd + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
    if (p.stages == 2) __syncthreads();  // every warp is done with this stage before it is refilled
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
// bf16 on wgmma, fed by TMA: windows of more than 64 rows over up to 256 keys
// ---------------------------------------------------------------------------
//
// A CTA owns one (window, head) pair and up to 4 blocks of 64 query rows
// (Params.blocks); its two warpgroups take the blocks in turn (w, w + 2).
// One thread issues every load at the start, as TMA boxes of 64 rows x 64
// head-dim columns with
// 128-byte swizzle (columns past D and rows past the window are zeros): each
// block of Q rows and each 64-key chunk of K and of V on an mbarrier of its
// own, so the first products start while the rest lands. The whole window
// stays resident: 256 keys x 128 bytes x 2 boxes is 64 KB for each of Q, K
// and V at hiera-L stage 3 (D = 72), read from L2 once per pair. Per
// warpgroup and block of 64 rows:
//   S = Q K^T   wgmma m64n64k16 per 64-key chunk, both operands K-major from
//               shared memory, over the head dim padded to 16 (72 -> 80): S
//               for every key of the window stays in registers (128 fp32 a
//               thread at 256 keys), so the logits are formed once;
//   softmax     the row max over the window, then e = 2^(s - max) once per
//               logit and the row sum: P = e / sum, normalized before it is
//               rounded to bf16, as the reference rounds it, with one
//               exponential per logit;
//   O = P V     wgmma m64nDk16 per chunk, P from registers (the accumulator
//               fragment rounded to bf16 is the A fragment), V the MN-major
//               B operand; a chunk's P is formed while the previous chunk's
//               product runs.
// While one warpgroup forms its exponentials, the other's products run.

constexpr int WG_ROW = 128;  // bytes of one swizzled box row: 64 bf16 columns
constexpr int WG_MAX_KEYS = 256;
constexpr int WG_THREADS = 256;  // two warpgroups
constexpr int WG_BLOCKS = 4;     // 64-row blocks of Q a CTA

template <int DV>
struct WinWg {
  static constexpr int DP = (DV + 15) / 16 * 16;  // depth of Q . K^T
  static constexpr int NB = (DP + 63) / 64;       // 64-column boxes of a row
  static constexpr int KSTEPS = DP / 16;
  static constexpr int PF = DV <= 96 ? 2 : 1;     // P fragment buffers (registers allowing)
};

// bytes of the CTA's shared memory: Q (64 rows a block), K and V (64 * nc
// rows each), NB boxes of each; then the mbarriers (Q per block, K and V per
// chunk); 1024-byte alignment slack
constexpr int WG_BARS = WG_BLOCKS + 2 * WG_MAX_KEYS / 64;

template <int DV>
int wgmma_smem(int blocks, int nc) {
  return WinWg<DV>::NB * 64 * (blocks + 2 * nc) * WG_ROW + 1024 + 8 * WG_BARS;
}

template <int DV, int NC>
__global__ void __launch_bounds__(WG_THREADS, 1)
    window_attn_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using W = WinWg<DV>;
  constexpr int NB = W::NB, BOX = 64 * WG_ROW;  // one 64-row box
  extern __shared__ uint8_t wg_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int blocks = p.blocks;  // 64-row blocks of this CTA
  const int q_box = blocks * BOX, kv_box = NC * BOX;
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + NB * q_box;
  uint8_t* Vs = Ks + NB * kv_box;
  const int n_chunks = (p.Skv + 63) / 64;  // chunks with keys (<= NC)
  // mbarriers: Q block b at b, K chunk c at WG_BLOCKS + c, V chunk c after the K ones
  const uint32_t bars = smem_u32(Vs + NB * kv_box);
  const auto bar_q = [&](int b) { return bars + 8 * b; };
  const auto bar_k = [&](int c) { return bars + 8 * (WG_BLOCKS + c); };
  const auto bar_v = [&](int c) { return bars + 8 * (WG_BLOCKS + WG_MAX_KEYS / 64 + c); };
  const int n = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * blocks * 64;

  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_BARS; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int b = 0; b < blocks && q0 + 64 * b < p.Sq; ++b) {
      mbar_expect_tx(bar_q(b), NB * BOX);
      for (int cb = 0; cb < NB; ++cb)
        tma_load_4d(smem_u32(Qs + cb * q_box + b * BOX), &tm_q, bar_q(b), 64 * cb, q0 + 64 * b, h,
                    n);
    }
    for (int c = 0; c < n_chunks; ++c) {
      mbar_expect_tx(bar_k(c), NB * BOX);
      for (int cb = 0; cb < NB; ++cb)
        tma_load_4d(smem_u32(Ks + cb * kv_box + c * BOX), &tm_k, bar_k(c), 64 * cb, 64 * c, h, n);
    }
    for (int c = 0; c < n_chunks; ++c) {
      mbar_expect_tx(bar_v(c), NB * BOX);
      for (int cb = 0; cb < NB; ++cb)
        tma_load_4d(smem_u32(Vs + cb * kv_box + c * BOX), &tm_v, bar_v(c), 64 * cb, 64 * c, h, n);
    }
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = p.scale * LOG2E;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + n * p.o_sn + h * p.o_sh;

  float x[NC][32];  // S, then e: chunk c, n8 slice i: rows g, g + 8 x keys 64c + 8i + 2t, +1
  float o[DV / 2];
  uint32_t pf[W::PF][4][4];  // P rounded to bf16: the A fragments of one chunk's P . V

  // where both warpgroups have rows, warpgroup 1 starts once warpgroup 0's
  // first S is done, so one's exponentials tend to run beside the other's
  // products
  const bool two = blocks > 1 && q0 + 64 < p.Sq;
  if (wg == 1 && two) named_sync(1);
  for (int b = wg; b < blocks && q0 + 64 * b < p.Sq; b += 2) {
    const uint32_t qa = smem_u32(Qs) + b * BOX;
    mbar_wait(bar_q(b), 0);
    // S for every chunk (a chunk past Skv runs on whatever its buffer holds
    // and is masked below; its K is never waited for)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n_chunks) mbar_wait(bar_k(c), 0);
      const uint32_t kb = smem_u32(Ks) + c * BOX;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < W::KSTEPS; ++j)
        wgmma_ss_n64(x[c], smem_desc(qa + (j / 4) * q_box) + 2 * (j % 4),
                     smem_desc(kb + (j / 4) * kv_box) + 2 * (j % 4), j > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    if (wg == 0 && b == 0 && two) named_arrive(1);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_regs(x[c]);
      if ((c + 1) * 64 <= p.Skv) {
#pragma unroll
        for (int e = 0; e < 32; ++e) x[c][e] *= scale_log2;
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          x[c][e] = 64 * c + 8 * (e / 4) + 2 * t + (e & 1) < p.Skv ? x[c][e] * scale_log2 : NEG_INF;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x[c][e]);
    }
    float m[2], sum[2] = {0.f, 0.f}, inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(mx[r]);  // every row sees a key
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[c][e] = ex2(x[c][e] - m[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += x[c][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(sum[r]);

    // O = P . V, chunk by chunk; P of chunk c is formed while chunk c - 1's
    // product runs (with two P buffers)
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= n_chunks) break;
      uint32_t(&a)[4][4] = pf[c % W::PF];
      if (c >= W::PF) {  // the product that read this buffer is done
        wgmma_wait<W::PF - 1>();
        fence_regs(a);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) x[c][e] *= inv_l[(e >> 1) & 1];
      to_a_frag<4>(a, x[c]);
      mbar_wait(bar_v(c), 0);
      const uint32_t vb = smem_u32(Vs) + c * BOX;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs_tb<DV>(o, a[j], smem_desc_mn_atoms(vb + j * 16 * WG_ROW, kv_box));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 64 * b + 16 * warp + g + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int i8 = 0; i8 < DV / 8; ++i8) {
        const int col = 8 * i8 + 2 * t;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
              __floats2bfloat162_rn(o[4 * i8 + 2 * r], o[4 * i8 + 2 * r + 1]);
      }
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
  float* qs = smem_f + p.ppc * R * stage_floats + (threadIdx.x >> 5) * ROWS * LDK;
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
  const long long pairs = static_cast<long long>(p.N) * p.H;
  const int warps_needed = (p.Sq + ROWS - 1) / ROWS;
  const dim3 grid(static_cast<unsigned>((pairs + p.ppc - 1) / p.ppc),
                  (warps_needed + p.wpp - 1) / p.wpp);
  kernel<<<grid, p.wpp * p.ppc * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// The mma.sync bf16 kernel's geometry: warps a pair (one per 16 rows),
// pairs a CTA (windows of up to 32 rows are packed 4 or 2 to a CTA of 4
// warps, as the fp32 kernel packs them), and the window resident in one
// stage where the CTA's pairs fit in B_RESIDENT_BYTES, else two stages of
// 128 keys. Packed pairs whose windows do not fit are halved, down to one
// pair a CTA, until the resident window fits; where one pair's does not,
// the window streams, in as many of the pairs as two stages fit (at D = 128
// one pair's two stages take 136 KB).
template <int DP>
cudaError_t launch_bf16(Params p, cudaStream_t stream) {
  const int warps_needed = (p.Sq + ROWS - 1) / ROWS;  // a warp per 16 rows
  const int max_warps = bf16_max_warps(DP);
  if (warps_needed <= 2) {
    p.wpp = warps_needed;
    p.ppc = 4 / warps_needed;
  } else {
    p.wpp = warps_needed < max_warps ? warps_needed : max_warps;
    p.ppc = 1;
  }
  const int key_bytes = 2 * ld_bf16(DP) * static_cast<int>(sizeof(__nv_bfloat16));  // K and V
  const int resident_keys = (p.Skv + KT - 1) / KT * KT;
  int ppc = p.ppc;
  while (ppc > 1 && ppc * resident_keys * key_bytes > B_RESIDENT_BYTES) ppc /= 2;
  if (ppc * resident_keys * key_bytes <= B_RESIDENT_BYTES) {
    p.ppc = ppc, p.kr = resident_keys, p.n_tiles = 1, p.stages = 1;
  } else {
    while (p.ppc > 1 && p.ppc * 2 * B_STREAM_KEYS * key_bytes > B_RESIDENT_BYTES) p.ppc /= 2;
    p.kr = B_STREAM_KEYS, p.n_tiles = (p.Skv + B_STREAM_KEYS - 1) / B_STREAM_KEYS, p.stages = 2;
  }
  return launch(window_attn_bf16_kernel<DP>, p.ppc * p.stages * p.kr * key_bytes, p, stream);
}

template <int DP>
cudaError_t launch_f32(Params p, cudaStream_t stream) {
  const int row_blocks = (p.Sq + ROWS - 1) / ROWS;
  p.wpp = row_blocks >= 3 ? 4 : row_blocks;
  p.ppc = WARPS / p.wpp;
  return launch(window_attn_f32_kernel<DP>, smem_f32<DP>(p.ppc, p.Skv), p, stream);
}

// The wgmma kernel: one CTA per pair and up to 4 blocks of 64 rows, the
// window's Q rows, K and V loaded by TMA from strides; 2 or 4 chunks of 64
// keys resident.
template <int DV, int NC>
cudaError_t launch_bf16_wgmma_nc(Params p, cudaStream_t stream) {
  const int row_blocks = (p.Sq + 63) / 64;
  p.blocks = row_blocks < WG_BLOCKS ? row_blocks : WG_BLOCKS;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, p.q, p.N, p.H, p.Sq, p.D, p.q_sn, p.q_sh, p.q_ss, 64) ||
      !make_map(&mk, p.k, p.N, p.H, p.Skv, p.D, p.k_sn, p.k_sh, p.k_ss, 64) ||
      !make_map(&mv, p.v, p.N, p.H, p.Skv, p.D, p.v_sn, p.v_sh, p.v_ss, 64))
    return cudaErrorInvalidValue;
  constexpr auto kernel = &window_attn_bf16_wgmma_kernel<DV, NC>;
  const int smem = wgmma_smem<DV>(p.blocks, NC);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(p.N) * p.H;
  if (pairs > 2147483647ll) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(pairs), (row_blocks + p.blocks - 1) / p.blocks);
  kernel<<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int DV>
cudaError_t launch_bf16_wgmma(const Params& p, cudaStream_t stream) {
  return p.Skv <= 128 ? launch_bf16_wgmma_nc<DV, 2>(p, stream)
                      : launch_bf16_wgmma_nc<DV, 4>(p, stream);
}

// bf16 windows of more than 64 query rows over at most 256 keys (hiera-L
// stage 3) take the wgmma kernel; windows of 64 rows and fewer (stages 1, 2
// and 4) the mma.sync kernel, which packs the small ones four or two to a
// CTA, and windows of more than 256 keys, which it streams
cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  const bool wgmma = p.Sq > 64 && p.Skv <= WG_MAX_KEYS;
  switch ((p.D + 15) / 16) {
    case 1: return wgmma ? launch_bf16_wgmma<16>(p, stream) : launch_bf16<16>(p, stream);
    case 2: return wgmma ? launch_bf16_wgmma<32>(p, stream) : launch_bf16<32>(p, stream);
    case 3: return wgmma ? launch_bf16_wgmma<48>(p, stream) : launch_bf16<48>(p, stream);
    case 4:
      if (p.D == 56) return wgmma ? launch_bf16_wgmma<56>(p, stream) : launch_bf16<64>(p, stream);
      return wgmma ? launch_bf16_wgmma<64>(p, stream) : launch_bf16<64>(p, stream);
    case 5:
      if (p.D == 72) return wgmma ? launch_bf16_wgmma<72>(p, stream) : launch_bf16<80>(p, stream);
      return wgmma ? launch_bf16_wgmma<80>(p, stream) : launch_bf16<80>(p, stream);
    case 6: return wgmma ? launch_bf16_wgmma<96>(p, stream) : launch_bf16<96>(p, stream);
    case 7: return wgmma ? launch_bf16_wgmma<112>(p, stream) : launch_bf16<112>(p, stream);
    case 8: return wgmma ? launch_bf16_wgmma<128>(p, stream) : launch_bf16<128>(p, stream);
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
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.N = N; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sn = q_sn; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sn = k_sn; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sn = v_sn; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sn = o_sn; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? dispatch_bf16(p, st) : dispatch_f32(p, st));
}
