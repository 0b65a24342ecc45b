// Fused two-layer GELU MLP for Hopper (sm_90a), bf16: warp-specialised
// wgmma with TMA.
//
// Replaces the Pallas TPU kernel sam2_opt_tpu/kernels/fused_mlp.py::_kernel
// (K8, `pallas_call` at :90), the Hiera block MLP under SAM2_TPU_FUSED_MLP=1,
// with its fast_act numerics:
//   h   = fp32(x . W1^T) + fp32(b1)
//   g   = gelu_tanh(bf16(h)), computed in fp32 and rounded to bf16
//   out = bf16(fp32(g . W2^T) + fp32(b2))
// Weights stay in nn.Linear's [out, in] layout: W1 [Hd, C], W2 [Cout, Hd],
// which is the K-major B operand wgmma wants, so no transposed copy is made.
// x is [N, C] with a row stride; out [N, Cout] with a row stride.
//
// Bound. The two products do 2*N*Hd*(C + Cout) operations (Hd = 4C, Cout
// = C at Hiera's blocks: 16*N*C^2 = 21.7 GFLOP at every hiera-L stage, 22 us
// at 989 TFLOP/s) on N*(C + Cout) bf16 activations and 2*C*Hd weights (6 us
// of bytes at stage 4, less elsewhere), so the kernel is bound by
// operations. The unfused graph also writes and reads the [N, Hd] hidden
// tensor (151 MB at stage 1, 45 us), which here never leaves the SM. The
// split below adds work at hiera-L stages 3 and 4 (GEMM1 runs once per
// output-column tile): 1.5x there (32.6 GFLOP, 33 us) and 2.5x at stage 4
// (54.4 GFLOP, 55 us); zero padding adds nothing at hiera-L's widths
// (chip_smoke.py's `k8_executed_flops` mirrors this tiling to print the
// executed-work bound: change it with the split). The
// GELU costs N*Hd evaluations (37.7 M per launch, times the column tiles),
// each two MUFU operations (ex2, rcp) and ~8 FMAs beside the tensor cores:
// ~20 us at 16 MUFU operations per clock per SM, 2x and 4x at stages 3-4,
// hidden only where wgmma work is in flight beside it (below).
//
// Design. A CTA of three warpgroups owns 128 tokens and one tile of NT
// output columns (NT = 144 or 288) and walks its share of the hidden dim in
// panels of 64 units:
//  - warpgroup 0, the producer, drops to 40 registers (setmaxnreg); one
//    thread keeps TMA loads in flight: per panel, ceil(C/64) boxes of x
//    (128 x 64) with the panel's W1 box (64 x 64), into a ring of 24 KB
//    stages, then the panel's W2 tile (NT rows x 64) into a second ring.
//    All tiles are 128-byte swizzled; mbarrier full/empty pairs per stage;
//    TMA's out-of-bounds zero fill pads C (112, 144: not multiples of 64),
//    Hd, Cout and a ragged N. x is re-read from L2 for each panel (it stays
//    there: at most 19 MB), so shared memory holds no whole token tile and
//    any C up to the contract's works;
//  - warpgroups 1 and 2, the consumers (232 registers), each own 64 of the
//    tokens. Per panel: GEMM1 (wgmma m64n64k16, x and W1 from shared
//    memory) into 32 fp32 registers; + b1, round, GELU in fp32 (as
//    x * sigmoid(2u), u = sqrt(2/pi) (x + 0.044715 x^3): the tanh form
//    without its cancellation for negative x), round; the fp32 accumulator
//    fragment of m64n64 is the bf16 A fragment of four k16 steps, so g
//    feeds GEMM2 (wgmma m64n144k16, A from registers) without leaving the
//    registers; GEMM2 adds into NT/2 fp32 registers a thread and runs on
//    while the next panel's GEMM1 is issued. No barrier spans the CTA
//    inside the loop: each warpgroup waits on the stage's full barrier and
//    releases it through the empty barrier. Both warpgroups read the same
//    boxes, so they tend to run in step, and the GELU overlaps the tensor
//    cores less than a ping-pong schedule would;
//  - the output width is budgeted: NT = 144 (72 registers) for Cout <= 144,
//    else 288 (144 registers), so hiera-L stages 1-2 keep their whole width
//    (144, 288) and stages 3-4 split their columns over 2 and 4 CTAs,
//    recomputing GEMM1 per column tile (the work counted above);
//  - where the tiles would not fill the card (hiera-L stages 3-4: 64 and 32
//    tiles), the hidden dim is split over a thread-block cluster of 2-4
//    CTAs on one tile: each writes its fp32 partial sums to its own shared
//    memory (the emptied rings), and after a cluster barrier each reduces
//    its slice of the rows over the cluster's shared memory (DSMEM), adds
//    b2 and stores. Otherwise the consumers add b2 and store from registers.
// One CTA per SM (up to 222 KB of shared memory); the launch allocates
// nothing and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;         // tokens per CTA: two consumer warpgroups of 64
constexpr int BK = 64;          // bf16 columns of a 128-byte swizzled box row
constexpr int HP = 64;          // hidden units per panel
constexpr int WN = 144;         // output columns of one GEMM2 wgmma
constexpr int THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int X_BYTES = BM * BK * 2;      // 16 KB x box
constexpr int W1_BYTES = HP * BK * 2;     // 8 KB W1 box
constexpr int A_STAGE = X_BYTES + W1_BYTES;
constexpr int W2_SUB = WN * BK * 2;       // 18 KB W2 box of 144 rows
constexpr int B_STAGES = 2;
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int a_stages(int nsub) {
  return (SMEM_LIMIT - 2048 - B_STAGES * nsub * W2_SUB) / A_STAGE;
}
__host__ __device__ constexpr int red_stride(int nsub) { return nsub * WN + 4; }  // floats
__host__ __device__ constexpr int ring_bytes(int nsub) {
  return a_stages(nsub) * A_STAGE + B_STAGES * nsub * W2_SUB;
}
__host__ __device__ constexpr int smem_bytes(int nsub) {  // + 1 KB for alignment, + barriers
  return ring_bytes(nsub) + 1024 + 256;
}
static_assert(BM * red_stride(2) * 4 <= ring_bytes(2), "partial sums must fit the rings");
static_assert(BM * red_stride(1) * 4 <= ring_bytes(1), "partial sums must fit the rings");
static_assert(smem_bytes(2) <= SMEM_LIMIT && smem_bytes(1) <= SMEM_LIMIT, "shared memory");

struct Params {
  const __nv_bfloat16* b1;
  const __nv_bfloat16* b2;
  __nv_bfloat16* out;
  int N, C, Hd, Cout;
  long long out_s;
  int col_tiles, hsplit, panels;
};

// tanh-GELU in fp32 (torch's approximate="tanh"), written as
// x * sigmoid(2u) = 0.5 x (1 + tanh(u)): exact identity, no cancellation
__device__ __forceinline__ float gelu_tanh(float x) {
  const float t = x * (1.5957691216057308f + 0.0713548162726009f * x * x);  // 2u
  return __fdividef(x, 1.f + __expf(-t));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// d[0:72] += A[64 x 16] . B[144 x 16]^T, A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory
__device__ __forceinline__ void wgmma_rs_n144(float (&d)[72], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NSUB>
__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w1,
                     const __grid_constant__ CUtensorMap tm_w2, const Params p) {
  constexpr int AS = a_stages(NSUB);
  constexpr int NT = NSUB * WN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring_a = smem;                   // [AS][x box 128 x 64 | W1 box 64 x 64]
  uint8_t* ring_b = smem + AS * A_STAGE;    // [B_STAGES][NSUB W2 boxes 144 x 64]
  const uint32_t full_a = smem_u32(smem + ring_bytes(NSUB));
  const uint32_t empty_a = full_a + 8 * AS;
  const uint32_t full_b = empty_a + 8 * AS;
  const uint32_t empty_b = full_b + 8 * B_STAGES;

  const int tile = blockIdx.x / p.hsplit, rank = blockIdx.x % p.hsplit;
  const int m0 = tile / p.col_tiles * BM, n0 = tile % p.col_tiles * NT;
  const int pan0 = rank * p.panels / p.hsplit, pan1 = (rank + 1) * p.panels / p.hsplit;
  const int kb_n = (p.C + BK - 1) / BK, k16_n = (p.C + 15) / 16;

  if (threadIdx.x == 0) {
    for (int s = 0; s < AS; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 2);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int ia = 0, ib = 0;
      for (int pn = pan0; pn < pan1; ++pn) {
        for (int kb = 0; kb < kb_n; ++kb, ++ia) {
          const int s = ia % AS;
          mbar_wait(empty_a + 8 * s, ((ia / AS) & 1) ^ 1);
          mbar_expect_tx(full_a + 8 * s, A_STAGE);
          const uint32_t dst = smem_u32(ring_a + s * A_STAGE);
          tma_load(dst, &tm_x, full_a + 8 * s, kb * BK, m0);
          tma_load(dst + X_BYTES, &tm_w1, full_a + 8 * s, kb * BK, pn * HP);
        }
        const int s = ib % B_STAGES;
        mbar_wait(empty_b + 8 * s, ((ib / B_STAGES) & 1) ^ 1);
        mbar_expect_tx(full_b + 8 * s, NSUB * W2_SUB);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          tma_load(smem_u32(ring_b + (s * NSUB + j) * W2_SUB), &tm_w2, full_b + 8 * s, pn * HP,
                   n0 + j * WN);
        ++ib;
      }
    }
    if (p.hsplit > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumer warpgroups 1 and 2: tokens m0 + 64c .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  float acc[NSUB][WN / 2];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[j][i] = 0.f;
  float h[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;
  uint32_t a[4][4];  // g of the panel: the A fragments of its four k16 steps
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k][0] = a[k][1] = a[k][2] = a[k][3] = 0u;

  int ia = 0, ib = 0, pending_b = -1;
  for (int pn = pan0; pn < pan1; ++pn) {
    // GEMM1: h = x . W1[panel]^T, one wgmma group per 64-column box; the
    // previous box's stage is released once its group is done. The panel
    // before's GEMM2 may still run: groups complete in order.
    for (int kb = 0; kb < kb_n; ++kb, ++ia) {
      const int s = ia % AS;
      mbar_wait(full_a + 8 * s, (ia / AS) & 1);
      const uint32_t base = smem_u32(ring_a + s * A_STAGE);
      const uint64_t dx = smem_desc(base + c * (X_BYTES / 2)), dw = smem_desc(base + X_BYTES);
      const int nk = min(4, k16_n - 4 * kb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) wgmma_ss_n64(h, dx + 2 * kk, dw + 2 * kk, (kb | kk) != 0);
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();
        if (t == 0) mbar_arrive(empty_a + 8 * ((ia - 1) % AS));
      }
    }
    wgmma_wait<0>();
    fence_regs(h);
    fence_regs(a);
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
    if (t == 0) {
      mbar_arrive(empty_a + 8 * ((ia - 1) % AS));
      if (pending_b >= 0) mbar_arrive(empty_b + 8 * pending_b);
    }

    // + b1, round, GELU, round: the accumulator's n8 chunk i (rows g and
    // g + 8, columns 8i + 2q, +1) is half i % 2 of k16 step i / 2's A fragment
    const int hid = pn * HP + 2 * q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float bb0 = 0.f, bb1 = 0.f;
      if (hid + 8 * i < p.Hd) {  // Hd is a multiple of 8; past it h = 0 and g = 0
        bb0 = __bfloat162float(p.b1[hid + 8 * i]);
        bb1 = __bfloat162float(p.b1[hid + 8 * i + 1]);
      }
      a[i / 2][2 * (i % 2)] = pack_bf16(gelu_tanh(bf16_round(h[4 * i] + bb0)),
                                        gelu_tanh(bf16_round(h[4 * i + 1] + bb1)));
      a[i / 2][2 * (i % 2) + 1] = pack_bf16(gelu_tanh(bf16_round(h[4 * i + 2] + bb0)),
                                            gelu_tanh(bf16_round(h[4 * i + 3] + bb1)));
    }

    // GEMM2: acc += g . W2[column tile, panel]^T, left running while the
    // next panel's GEMM1 is issued
    const int s = ib % B_STAGES;
    mbar_wait(full_b + 8 * s, (ib / B_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      const uint64_t dw = smem_desc(smem_u32(ring_b + (s * NSUB + j) * W2_SUB));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n144(acc[j], a[kk], dw + 2 * kk);
    }
    wgmma_commit();
    pending_b = s;
    ++ib;
  }
  wgmma_wait<0>();
  fence_regs(a);
#pragma unroll
  for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
  if (t == 0 && pending_b >= 0) mbar_arrive(empty_b + 8 * pending_b);

  const int row = m0 + 64 * c + 16 * warp + g;  // and row + 8
  if (p.hsplit == 1) {
    // + b2, rounded, from registers
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < WN / 8; ++i) {
        const int col = n0 + j * WN + 8 * i + 2 * q;
        if (col >= p.Cout) continue;
        const float c0 = __bfloat162float(p.b2[col]), c1 = __bfloat162float(p.b2[col + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row + 8 * r < p.N)
            *reinterpret_cast<uint32_t*>(p.out + (row + 8 * r) * p.out_s + col) =
                pack_bf16(acc[j][4 * i + 2 * r] + c0, acc[j][4 * i + 2 * r + 1] + c1);
      }
    return;
  }

  // hidden split over the cluster: partial sums to this CTA's shared memory
  // (the rings, once both consumer warpgroups are done with them), then each
  // CTA reduces rows [rank * BM / hsplit, ...) over the cluster
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* red = reinterpret_cast<float*>(smem);
  constexpr int RS = red_stride(NSUB);
  const int lr = 64 * c + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < WN / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(red + (lr + 8 * r) * RS + j * WN + 8 * i + 2 * q) =
            make_float2(acc[j][4 * i + 2 * r], acc[j][4 * i + 2 * r + 1]);
  cluster_sync();
  const int rows = BM / p.hsplit, r0 = rank * rows;
  for (int idx = threadIdx.x - 128; idx < rows * (NT / 4); idx += 256) {
    const int r = r0 + idx / (NT / 4), cc = 4 * (idx % (NT / 4));
    const int col = n0 + cc;
    if (m0 + r >= p.N || col >= p.Cout) continue;  // Cout is a multiple of 8
    const uint32_t local = smem_u32(red + r * RS + cc);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < p.hsplit; ++src) {
      uint32_t remote;
      float4 v;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(src));
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "r"(remote)
                   : "memory");
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    uint2 o;
    o.x = pack_bf16(sum.x + __bfloat162float(p.b2[col]), sum.y + __bfloat162float(p.b2[col + 1]));
    o.y = pack_bf16(sum.z + __bfloat162float(p.b2[col + 2]),
                    sum.w + __bfloat162float(p.b2[col + 3]));
    *reinterpret_cast<uint2*>(p.out + (m0 + r) * p.out_s + col) = o;
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory
}

// a bf16 [rows, cols] matrix with row stride `stride` elements, read in
// 128-byte swizzled boxes of box_rows x 64; zeros past its edges
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long stride,
              int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int NSUB>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw1, const CUtensorMap& mw2,
                   const Params& p, int tiles, cudaStream_t stream) {
  const int smem = smem_bytes(NSUB);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<NSUB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.hsplit);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * p.hsplit));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mlp_kernel<NSUB>, mx, mw1, mw2, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = cudaSuccess). bf16 only. x
// [N, C] (row stride x_s), w1 [Hd, C], w2 [Cout, Hd] (row strides w1_s,
// w2_s), b1 [Hd], b2 [Cout], out [N, Cout] (row stride out_s); C, Hd, Cout
// and the four strides multiples of 8, the matrices 16-byte aligned, Cout up
// to 1152. The caller allocates out.
extern "C" int sam2_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int N, int C, int Hd, int Cout,
                                  long long x_s, long long w1_s, long long w2_s, long long out_s,
                                  void* stream) {
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (N <= 0 || C <= 0 || Hd <= 0 || Cout <= 0 || C % 8 || Hd % 8 || Cout % 8 || Cout > 1152 ||
      x_s % 8 || w1_s % 8 || w2_s % 8 || out_s % 8 || x_s < C || w1_s < C || w2_s < Hd ||
      out_s < Cout || !aligned(x) || !aligned(w1) || !aligned(w2) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsub = Cout <= WN ? 1 : 2;
  CUtensorMap mx, mw1, mw2;
  if (!make_map(&mx, x, N, C, x_s, BM) || !make_map(&mw1, w1, Hd, C, w1_s, HP) ||
      !make_map(&mw2, w2, Cout, Hd, w2_s, WN))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = N; p.C = C; p.Hd = Hd; p.Cout = Cout;
  p.out_s = out_s;
  p.col_tiles = (Cout + nsub * WN - 1) / (nsub * WN);
  p.panels = (Hd + HP - 1) / HP;
  const int tiles = (N + BM - 1) / BM * p.col_tiles;
  // split the hidden dim over a cluster of up to 4 CTAs while the tiles
  // alone would leave most of the 132 SMs idle
  p.hsplit = 1;
  while (p.hsplit < 4 && tiles * p.hsplit < 100 && 2 * p.hsplit <= p.panels) p.hsplit *= 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nsub == 1 ? launch<1>(mx, mw1, mw2, p, tiles, st)
                                    : launch<2>(mx, mw1, mw2, p, tiles, st));
}
