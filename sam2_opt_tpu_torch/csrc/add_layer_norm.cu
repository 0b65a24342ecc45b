// Residual add + LayerNorm of the Hiera block in one pass, bf16, with the
// window partition and unpartition folded into its row indexing.
//
// Replaces no Pallas kernel. The JAX package leaves this chain (the
// window unpartition, the residual add, the bf16 one-pass LayerNorm, the
// window partition of the next block) to XLA, which fuses it into one pass
// over the activation. PyTorch runs it eagerly as some ten full-size
// passes: an fp32 copy of x, two fp32 means, x*x, the broadcast scale and
// shift, the (un)partition's permuted copies and the add, about 37 bytes of
// traffic for every byte of the block's activation against 6 here.
//
// Per row of C channels (one token), with the JAX package's bf16 roundings
// (`ops.common.layer_norm`):
//   sum    = bf16(residual + delta)                 (raster order)
//   mean   = sum_c x / C, ex2 = sum_c x^2 / C       (fp32)
//   rstd   = 1 / sqrt(max(ex2 - mean^2, 0) + eps)
//   scale  = bf16(rstd * w), shift = bf16(b - mean * rstd * w)
//   normed = bf16(bf16(x * scale) + shift)
// Every operation is written with its rounding (__fmul_rn, __fadd_rn, ...)
// so that nvcc contracts none of them into an FMA: the kernel differs from
// the plain version only in the order of the two fp32 sums.
//
// Layouts. residual, sum: [B, H, W, C] in raster order. delta: raster, or in
// window order [B * nW, ws, ws, C] over an (Hp, Wp) grid padded up to
// multiples of ws (the windowed attention's output, before
// `window_unpartition`): the kernel gathers a row's delta from its window
// and never reads the padded rows, which is the unpartition's crop. normed:
// raster, or in window order (what `window_partition` gives), its padded
// rows written as zeros (what `F.pad` after the norm gives). A window
// permutes whole rows only, so every row stays one contiguous C-wide vector
// and the fold costs no coalescing.
//
// Bound. About 2 operations a byte, far under the card's ~295, so the
// kernel is bound by bytes: 2 bytes a channel read from residual and
// delta, 2 written to sum and normed. Design: one warp per output row,
// 16-byte vector loads and stores (8 channels a lane, up to 5 vectors a
// lane, so C <= 1280, a multiple of 8: Hiera's widest stage is 1152); the
// row stays in registers between the reduction (fp32 sum and sum of squares
// per lane, then warp shuffles) and the normalisation, so device memory is
// read once; 8 rows a CTA, so hiera-L stage 4 (1024 rows) still puts 128
// CTAs on the 132 SMs and stage 1 (65536) 8192. (Warps of 2-4 rows with all
// their loads issued first, and weight and bias loaded once for them, ran
// slower at stages 1-3.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;    // rows per CTA, one warp each
constexpr int MAX_VPL = 5;  // 16-byte vectors per lane: C <= 8 * 32 * MAX_VPL

struct Geometry {
  int H, W, C;
  int d_ws, d_Hp, d_Wp;  // delta's windows (d_ws 0: raster)
  int o_ws, o_Hp, o_Wp;  // normed's windows (o_ws 0: raster)
  long long rows_out;    // rows of normed
};

__device__ __forceinline__ void unpack(const uint4 v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(p[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// row of (b, h, w) in window order over an (Hp, Wp) grid of ws x ws windows
__device__ __forceinline__ long long window_row(int b, int h, int w, int ws, int Hp, int Wp) {
  const int nww = Wp / ws;
  return static_cast<long long>(b) * Hp * Wp +
         static_cast<long long>((h / ws) * nww + w / ws) * ws * ws + (h % ws) * ws + (w % ws);
}

// the raster position (b, h, w) of output row o; false for a padded row
__device__ __forceinline__ bool position(const Geometry& g, long long o, int& b, int& h, int& w) {
  if (g.o_ws) {
    const long long per_image = static_cast<long long>(g.o_Hp) * g.o_Wp;
    b = static_cast<int>(o / per_image);
    const int rem = static_cast<int>(o - b * per_image);
    const int area = g.o_ws * g.o_ws;
    const int win = rem / area, t = rem - win * area;
    const int nww = g.o_Wp / g.o_ws;
    h = (win / nww) * g.o_ws + t / g.o_ws;
    w = (win % nww) * g.o_ws + t % g.o_ws;
    return h < g.H && w < g.W;
  }
  const long long per_image = static_cast<long long>(g.H) * g.W;
  b = static_cast<int>(o / per_image);
  const int rem = static_cast<int>(o - b * per_image);
  h = rem / g.W;
  w = rem - h * g.W;
  return true;
}

template <int VPL>
__global__ void __launch_bounds__(WARPS * 32)
    add_layer_norm_kernel(const uint4* __restrict__ residual, const uint4* __restrict__ delta,
                          const uint4* __restrict__ weight, const uint4* __restrict__ bias,
                          uint4* __restrict__ sum_out, uint4* __restrict__ normed,
                          const Geometry g, const float eps) {
  const int lane = threadIdx.x & 31;
  const long long o = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (o >= g.rows_out) return;
  const int vecs = g.C / 8;
  int b, h, w;
  uint4* out_row = normed + o * vecs;
  if (!position(g, o, b, h, w)) {  // a padded row of a window
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v < vecs) out_row[v] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const long long r = (static_cast<long long>(b) * g.H + h) * g.W + w;

  float x[VPL][8];
  const uint4* res_row = residual + r * vecs;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v < vecs) unpack(res_row[v], x[i]);
  }
  if (delta != nullptr) {
    const long long d = g.d_ws ? window_row(b, h, w, g.d_ws, g.d_Hp, g.d_Wp) : r;
    const uint4* delta_row = delta + d * vecs;
    uint4* sum_row = sum_out + r * vecs;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v < vecs) {
        float dv[8];
        unpack(delta_row[v], dv);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[i][j] = round_bf16(__fadd_rn(x[i][j], dv[j]));
        sum_row[v] = pack(x[i]);
      }
    }
  }

  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < vecs) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s = __fadd_rn(s, x[i][j]);
        ss = __fadd_rn(ss, __fmul_rn(x[i][j], x[i][j]));
      }
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, m));
  }
  const float c = static_cast<float>(g.C);
  const float mean = __fdiv_rn(s, c);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, c), __fmul_rn(mean, mean)), 0.f);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float mean_rstd = __fmul_rn(mean, rstd);

#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v < vecs) {
      float wv[8], bv[8], y[8];
      unpack(weight[v], wv);
      unpack(bias[v], bv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float scale = round_bf16(__fmul_rn(rstd, wv[j]));
        const float shift = round_bf16(__fsub_rn(bv[j], __fmul_rn(mean_rstd, wv[j])));
        y[j] = __fadd_rn(round_bf16(__fmul_rn(x[i][j], scale)), shift);
      }
      out_row[v] = pack(y);
    }
  }
}

bool valid_windows(int ws, int Hp, int Wp, int H, int W) {
  if (ws == 0) return true;
  return ws > 0 && Hp % ws == 0 && Wp % ws == 0 && Hp >= H && Wp >= W && Hp - H < ws &&
         Wp - W < ws;
}

}  // namespace

// residual [B, H, W, C], delta (nullable: raster, or window order when d_ws
// > 0), weight [C], bias [C], all bf16, contiguous and 16-byte aligned;
// writes sum [B, H, W, C] where delta is given (sum_out may be null
// otherwise) and normed (raster, or window order when o_ws > 0). Returns a
// cudaError_t.
extern "C" int sam2_add_layer_norm_bf16(const void* residual, const void* delta,
                                        const void* weight, const void* bias, void* sum_out,
                                        void* normed, int B, int H, int W, int C, int d_ws,
                                        int d_Hp, int d_Wp, int o_ws, int o_Hp, int o_Wp,
                                        float eps, void* stream) {
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int vpl = (C / 8 + 31) / 32;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || vpl > MAX_VPL || !aligned(residual) ||
      !aligned(weight) || !aligned(bias) || !aligned(normed) ||
      (delta != nullptr && (!aligned(delta) || sum_out == nullptr || !aligned(sum_out))) ||
      !valid_windows(d_ws, d_Hp, d_Wp, H, W) || !valid_windows(o_ws, o_Hp, o_Wp, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.H = H; g.W = W; g.C = C;
  g.d_ws = d_ws; g.d_Hp = d_Hp; g.d_Wp = d_Wp;
  g.o_ws = o_ws; g.o_Hp = o_Hp; g.o_Wp = o_Wp;
  g.rows_out = static_cast<long long>(B) * (o_ws ? static_cast<long long>(o_Hp) * o_Wp
                                                 : static_cast<long long>(H) * W);
  const unsigned grid = static_cast<unsigned>((g.rows_out + WARPS - 1) / WARPS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* res = static_cast<const uint4*>(residual);
  const auto* del = static_cast<const uint4*>(delta);
  const auto* wt = static_cast<const uint4*>(weight);
  const auto* bs = static_cast<const uint4*>(bias);
  auto* sm = static_cast<uint4*>(sum_out);
  auto* out = static_cast<uint4*>(normed);
  switch (vpl) {
#define SAM2_ALN_CASE(V)                                                                     \
  case V:                                                                                    \
    add_layer_norm_kernel<V><<<grid, WARPS * 32, 0, s>>>(res, del, wt, bs, sm, out, g, eps); \
    break;
    SAM2_ALN_CASE(1)
    SAM2_ALN_CASE(2)
    SAM2_ALN_CASE(3)
    SAM2_ALN_CASE(4)
    SAM2_ALN_CASE(5)
#undef SAM2_ALN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
