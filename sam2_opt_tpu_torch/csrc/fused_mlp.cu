// Fused two-layer GELU MLP for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel sam2_opt_tpu/kernels/fused_mlp.py::_kernel
// (K8), the Hiera block MLP under SAM2_TPU_FUSED_MLP=1, with its fast_act
// numerics:
//   h   = fp32(x . W1^T) + fp32(b1)
//   g   = gelu_tanh(bf16(h)), computed in fp32 and rounded to bf16
//   out = bf16(fp32(g . W2^T) + fp32(b2))
// Weights stay in nn.Linear's [out, in] layout: W1 [Hd, C], W2 [Cout, Hd],
// which is the column-major B operand mma.sync wants, so no transposed copy
// is made. x is [N, C] with a row stride; out [N, Cout] contiguous.
//
// Bound. The two products do 4*N*C*Hd operations (Hd = 4C at Hiera's
// blocks: 16*N*C^2 = 21.7 GFLOP at every hiera-L stage) on N*(C + Cout)
// bf16 activations and 2*C*Hd weights: 22 us at 989 TFLOP/s, against 6 us
// of bytes at stage 4, so the kernel is bound by operations. The unfused
// graph also writes and reads the [N, Hd] hidden tensor (151 MB at stage 1,
// 45 us), which here never leaves the SM.
//
// Design. A CTA of 8 warps owns BT = 16*MT tokens and walks the hidden dim
// in panels of 64 units:
//  1. the 8 warps form h for all BT tokens, each for its own 8 hidden units
//     of the panel (mma.sync m16n8k16, fp32 accumulation; x from shared
//     memory, where the CTA's token tile stays for the whole run);
//  2. each adds b1, rounds, applies tanh-GELU and writes its part of the
//     bf16 panel g to shared memory;
//  3. each adds g . W2^T into the fp32 accumulators of its own output
//     columns (8-column tiles w, w + 8, w + 16, ...);
//  4. at the end adds b2, rounds and stores.
// Both weights reach the tensor cores as 64 x 64 tiles (W1[panel, 64 input
// columns], W2[64 output columns, panel]) through a 4-stage cp.async ring in
// shared memory: 16-byte coalesced copies, three tiles in flight while one
// is multiplied, one barrier per tile, and ldmatrix for the B operands.
// The trouble is the accumulator: a token tile's fp32 sums span the whole
// output width, 295 KB for 64 tokens at Cout = 1152, more than a block's
// shared memory and the register file. The output columns are split over
// the 8 warps and the token tile shrinks at wide layers, so each thread
// keeps at most 72 fp32 sums in registers: BT = 64 tokens up to Cout = 256
// (hiera-L stage 1: 144), 48 up to 384 (stage 2: 288), 32 up to 576
// (stage 3), 16 up to 1152 (stage 4). The price is weight traffic: each
// CTA streams all of W1 and W2 from L2, and at stage 4 the 1024 tokens make
// only 64 CTAs. Splitting the hidden dim over CTAs with a reduction,
// TMA-multicast weight tiles across a cluster and wgmma are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HP = 64;      // hidden units per panel: one 8-unit tile per warp
constexpr int TW = 64;      // weight tiles are 64 x 64
constexpr int LDT = TW + 8; // row stride of a weight tile and of the g panel (odd multiple of 16 B)
constexpr int STAGES = 4;   // weight tiles in the ring

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1;
  const __nv_bfloat16* b1;
  const __nv_bfloat16* w2;
  const __nv_bfloat16* b2;
  __nv_bfloat16* out;
  int N, C, Hd, Cout;
  long long x_s, w1_s, w2_s, out_s;
};

__host__ __device__ constexpr int ceil_to(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int smem_bytes(int mt, int c) {  // x tile, g panel, ring
  return (16 * mt * (ceil_to(c, TW) + 8) + 16 * mt * LDT + STAGES * TW * LDT) *
         static_cast<int>(sizeof(__nv_bfloat16));
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

// all but the newest STAGES - 2 groups have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// tanh-GELU in fp32 (torch's approximate="tanh")
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  return 0.5f * x * (1.f + tanhf(k0 * (x + k1 * x * x * x)));
}

template <int MT, int NTW>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_kernel(const Params p) {
  constexpr int BT = 16 * MT;  // tokens per CTA
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int cp = ceil_to(p.C, TW);
  const int ldx = cp + 8;  // odd multiple of 16 B
  __nv_bfloat16* Xs = smem;                // [BT][ldx]
  __nv_bfloat16* Gs = Xs + BT * ldx;       // [BT][LDT]
  __nv_bfloat16* ring = Gs + BT * LDT;     // [STAGES][TW][LDT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in the quad
  const long long n0 = static_cast<long long>(blockIdx.x) * BT;

  // the token tile, zero past N and in the padded columns [C, cp)
  const int chunks = cp / 8;
  for (int idx = threadIdx.x; idx < BT * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const bool in = n0 + r < p.N && c < p.C;
    *reinterpret_cast<uint4*>(Xs + r * ldx + c) =
        in ? *reinterpret_cast<const uint4*>(p.x + (n0 + r) * p.x_s + c) : make_uint4(0u, 0u, 0u, 0u);
  }

  // The CTA's weight tiles in order: per hidden panel, t1 tiles of W1
  // (64 hidden rows x 64 input columns) then t2 tiles of W2 (64 output rows
  // x the panel's 64 hidden columns); zero past the edges.
  const int t1 = cp / TW, t2 = (p.Cout + TW - 1) / TW, per_panel = t1 + t2;
  const int steps = (p.Hd + HP - 1) / HP * per_panel;
  auto load = [&](int step) {
    const int p0 = step / per_panel * HP, r = step % per_panel;
    __nv_bfloat16* tile = ring + (step % STAGES) * TW * LDT;
    for (int idx = threadIdx.x; idx < TW * (TW / 8); idx += THREADS) {
      const int i = idx / (TW / 8), c = (idx % (TW / 8)) * 8;
      const __nv_bfloat16* src;
      bool in;
      if (r < t1) {
        in = p0 + i < p.Hd && TW * r + c < p.C;
        src = p.w1 + (in ? (p0 + i) * p.w1_s + TW * r + c : 0);
      } else {
        const int row = TW * (r - t1) + i;
        in = row < p.Cout && p0 + c < p.Hd;
        src = p.w2 + (in ? row * p.w2_s + p0 + c : 0);
      }
      cp_async_16(tile + i * LDT + c, src, in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  float acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  float h[MT][4];
  // ldmatrix rows of an A operand (rows 0..15 of an m-tile, columns +0 / +8)
  // and of a B operand pair (this warp's 8 tile rows, k columns +0/+8/+16/+24)
  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  const int b_off = (8 * warp + (lane & 7)) * LDT + 8 * (lane >> 3);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait_ring();
    __syncthreads();  // this step's tile landed; every warp is done with the previous step
    if (step + STAGES - 1 < steps) load(step + STAGES - 1);
    cp_async_commit();  // possibly empty: keeps the group count per step fixed
    const __nv_bfloat16* tile = ring + (step % STAGES) * TW * LDT;
    const int p0 = step / per_panel * HP, r = step % per_panel;

    if (r < t1) {
      // 1: h += x[:, 64r : 64r + 64] . W1[panel rows 8w..8w+7]^T
      if (r == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) h[mt][0] = h[mt][1] = h[mt][2] = h[mt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < TW / 16; kk += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, tile + b_off + 16 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, Xs + (16 * mt + a_row) * ldx + TW * r + 16 * kk + a_col);
          mma_bf16(h[mt], a, b[0], b[1]);
          ldmatrix_x4(a, Xs + (16 * mt + a_row) * ldx + TW * r + 16 * kk + 16 + a_col);
          mma_bf16(h[mt], a, b[2], b[3]);
        }
      }
      if (r == t1 - 1) {
        // 2: + b1, round, tanh-GELU, round; this warp's 8 columns of g
        const int hb = p0 + 8 * warp;
        const bool live = hb < p.Hd;  // Hd is a multiple of 8
        const float bias0 = live ? __bfloat162float(p.b1[hb + 2 * t]) : 0.f;
        const float bias1 = live ? __bfloat162float(p.b1[hb + 2 * t + 1]) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
            if (live)
              v = __floats2bfloat162_rn(gelu_tanh(bf16_round(h[mt][2 * i] + bias0)),
                                        gelu_tanh(bf16_round(h[mt][2 * i + 1] + bias1)));
            *reinterpret_cast<__nv_bfloat162*>(Gs + (16 * mt + g + 8 * i) * LDT + 8 * warp + 2 * t) = v;
          }
      }
    } else {
      // 3: acc[j] += g . W2[64j + 8w .. +7, panel]^T, j = r - t1 (output tile 8j + w)
      const int j = r - t1;
      if (TW * j + 8 * warp < p.Cout) {
#pragma unroll
        for (int kk = 0; kk < HP / 16; kk += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, tile + b_off + 16 * kk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a0[4], a1[4];
            ldmatrix_x4(a0, Gs + (16 * mt + a_row) * LDT + 16 * kk + a_col);
            ldmatrix_x4(a1, Gs + (16 * mt + a_row) * LDT + 16 * kk + 16 + a_col);
#pragma unroll
            for (int jj = 0; jj < NTW; ++jj)
              if (jj == j) {  // registers need a compile-time index
                mma_bf16(acc[mt][jj], a0, b[0], b[1]);
                mma_bf16(acc[mt][jj], a1, b[2], b[3]);
              }
          }
        }
      }
    }
  }

  // 4: + b2, rounded to bf16
  const int n_tiles = p.Cout / 8;  // 8-column output tiles; warp w owns w, w + 8, ...
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = warp + WARPS * j;
    if (nt >= n_tiles) continue;
    const int col = 8 * nt + 2 * t;
    const float c0 = __bfloat162float(p.b2[col]), c1 = __bfloat162float(p.b2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long row = n0 + 16 * mt + g + 8 * i;
        if (row < p.N)
          *reinterpret_cast<__nv_bfloat162*>(p.out + row * p.out_s + col) =
              __floats2bfloat162_rn(acc[mt][j][2 * i] + c0, acc[mt][j][2 * i + 1] + c1);
      }
  }
}

template <int MT, int NTW>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes(MT, p.C);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<MT, NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.N + 16 * MT - 1) / (16 * MT));
  fused_mlp_kernel<MT, NTW><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tokens per CTA / 16 for an output width: the most (up to 64 tokens) that
// keep each thread's fp32 accumulators at 72 or fewer (MT m-tiles x NTW
// 8-column tiles x 4). 0 for Cout > 1152.
int m_tiles(int Cout) {
  const int ntw = (Cout / 8 + WARPS - 1) / WARPS;
  return ntw <= 4 ? 4 : ntw <= 6 ? 3 : ntw <= 9 ? 2 : ntw <= 18 ? 1 : 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = cudaSuccess). bf16 only. x
// [N, C] (row stride x_s, rows 16-byte aligned), w1 [Hd, C], w2 [Cout, Hd]
// (row strides w1_s, w2_s), b1 [Hd], b2 [Cout], out [N, Cout] (row stride
// out_s); C, Hd and Cout multiples of 8, Cout up to 1152. The caller
// allocates out.
extern "C" int sam2_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int N, int C, int Hd, int Cout,
                                  long long x_s, long long w1_s, long long w2_s, long long out_s,
                                  void* stream) {
  if (N <= 0 || C <= 0 || Hd <= 0 || Cout <= 0 || C % 8 || Hd % 8 || Cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = N; p.C = C; p.Hd = Hd; p.Cout = Cout;
  p.x_s = x_s; p.w1_s = w1_s; p.w2_s = w2_s; p.out_s = out_s;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m_tiles(Cout)) {
    case 4: return static_cast<int>(launch<4, 4>(p, st));
    case 3: return static_cast<int>(launch<3, 6>(p, st));
    case 2: return static_cast<int>(launch<2, 9>(p, st));
    case 1: return static_cast<int>(launch<1, 18>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
