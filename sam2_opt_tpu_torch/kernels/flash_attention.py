"""Masked flash attention: CUDA kernel wrappers, their plain versions and
the operators that join them.

- K1, `flash_attention`: the port of
  `sam2_opt_tpu/kernels/flash_attention.py::_kernel`;
- K2, `flash_attention_rope`: the port of `::_kernel_rope`, K1 with K
  rotated in the split layout (axial RoPE): a rotation kernel, once per
  call, then K1's attention body (`rope_rotate` runs the rotation alone);
- K3, `flash_attention_bwd` (K3a `flash_attention_bwd_dkdv`, K3b
  `flash_attention_bwd_dq`): the port of `::_bwd_dkdv_kernel` and
  `::_bwd_dq_kernel`, the backward of K1, K2 and K4;
- K4, `flash_attention_kv_proj`: the port of `::_kernel_rope_kvproj`, K2 with
  the memory cross-attention's K/V projections fused in: a kernel that
  projects the memory and rotates K, once per call, then K1's attention
  body (`kv_proj_rotate` runs the first kernel alone);
- `flash_attention_relpos`: SAM's ViT attention, K1's bf16 body with a
  decomposed relative-position bias added to the logits (no TPU kernel: the
  JAX package has no ViT).

Each wrapper checks its arguments and calls an operator of the same name
in the `sam2_opt_tpu_torch` namespace (`_build.operator`), so `torch.export`
traces it as one node. On a CUDA tensor the operator launches the
hand-written kernel in `csrc/flash_attention.cu` or
`csrc/flash_attention_bwd.cu` (and counts the launch) or raises; on a CPU
tensor it runs the plain version (`flash_attention_ref`,
`flash_attention_rope_ref`, `flash_attention_kv_proj_ref`,
`flash_attention_bwd_ref`), the unfused form of the same math, its outputs
laid out as the kernel's. There is no fallback from one to the other.
`flash_attention`, `flash_attention_rope` and `flash_attention_kv_proj` are
differentiable: each operator's registered backward (the counterparts of
the JAX custom-VJP seams `_attn_core`, `_attn_core_rope` and
`_attn_core_rope_kvproj`) is K3.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch
import torch.nn.functional as F

from sam2_opt_tpu_torch.kernels import _build
from sam2_opt_tpu_torch.ops.posenc import apply_rotary_split

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, kv_mask=None):
    """Plain masked attention with K1's exact semantics.

    q [B,H,Sq,D], k/v [B,H,Skv,D], kv_mask [B,Skv] bool or None. Scores are
    scaled by 1/sqrt(D), masked keys get -1e30, softmax and both products run
    in fp32; the probabilities are rounded to v's dtype before p . v, as K1
    does (`p.astype(v.dtype)`). A row with every key masked outputs 0.
    Returns (out in q's dtype, lse [B,H,Sq] fp32: the row log-sum-exp, -1e30
    for fully masked rows).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    seen_valid = m > NEG_INF * 0.5
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.where(seen_valid, torch.matmul(p.to(v.dtype).float(), v.float()) / l, 0.0)
    lse = torch.where(seen_valid, m + torch.log(l), NEG_INF)
    return out.to(q.dtype), lse[..., 0]


def _check(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if k.shape != (B, H, Skv, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty query or key sequence")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (B, Skv):
            raise ValueError(f"kv_mask must be bool [{B}, {Skv}], got {kv_mask.dtype} "
                             f"{tuple(kv_mask.shape)}")
        if kv_mask.device != q.device:
            raise ValueError("kv_mask must be on q's device")


def _library(symbol, n_ptrs, n_ints):
    """The C entry point: q, k, v, mask, `n_ptrs` more pointers, out, lse,
    dtype, B, H, Sq, Skv, D, `n_ints` more ints, 13 strides, scale, stream."""
    fn = getattr(_build.load("flash_attention"), symbol)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * (6 + n_ptrs) + [i] * (6 + n_ints) + [ll] * 13
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=64)
def _kv_splits(device_index: int, dtype: int, B: int, H: int, Sq: int, Skv: int,
               D: int) -> int:
    """The kv split of K1, and of K2 and K4 (which run K1's body), for a
    shape on a device, as the kernel's library chooses it (from its CTAs'
    occupancy); asked once per shape."""
    fn = _build.load("flash_attention").sam2_flash_attention_splits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        n_split = fn(dtype, B, H, Sq, Skv, D)
    if n_split < 1:
        raise ValueError(f"flash attention: no kv split for D = {D}")
    return n_split


def flash_attention_tiling(dtype, B, H, Sq, Skv, D):
    """K1's (and K2's) launch geometry for a shape on the current device, as
    its library reports it: query rows per CTA, keys per kv tile, kv tiles
    in flight in shared memory, the kv split and the CTAs of the grid (every
    split counted). For logs; a CUDA card builds the library."""
    fn = _build.load("flash_attention").sam2_flash_attention_tiling
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
    out = (ctypes.c_int * 3)()
    fn(_DTYPES[dtype], D, out)
    rows, keys, stages = out
    n_split = _kv_splits(torch.cuda.current_device(), _DTYPES[dtype], B, H, Sq, Skv, D)
    return dict(rows=rows, keys=keys, stages=stages, n_split=n_split,
                ctas=-(-Sq // rows) * B * H * n_split)


def _split_scratch(q, n_split):
    """fp32 part_o [n_split, B*H, Sq, D] and part_lse [n_split, B*H, Sq] for a
    split kv axis; (None, None) without a split."""
    if n_split == 1:
        return None, None
    B, H, Sq, D = q.shape
    return (torch.empty((n_split, B * H, Sq, D), dtype=torch.float32, device=q.device),
            torch.empty((n_split, B * H, Sq), dtype=torch.float32, device=q.device))


def _rows_aligned(t):
    """Unit stride along the last axis and 16-byte aligned rows: the kernels
    copy rows in 16-byte chunks."""
    per_chunk = 16 // t.element_size()
    strides = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(st % per_chunk == 0
                                                                for st in strides)


def _check_cuda(q, k, v, kv_mask, head_dims, what):
    B, H, Sq, D = q.shape
    if D not in head_dims:
        raise ValueError(f"{what}: head dim {D} unsupported on the card ({head_dims})")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along the head dim")
        if not _rows_aligned(t):
            raise ValueError(f"{q.dtype} {name} rows must be 16-byte aligned (strides multiples "
                             f"of {16 // t.element_size()})")
    if kv_mask is not None and kv_mask.stride(-1) != 1:
        raise ValueError("kv_mask must have unit stride along the key axis")


def _launch(fn, q, k, v, kv_mask, extra_ptrs, extra_ints, what):
    """Allocate out/lse, launch on the current stream, raise on a refused
    launch. `out` is a [B,H,Sq,D] view of a [B,Sq,H,D] buffer, so the
    caller's merge of heads back into channels costs no copy."""
    B, H, Sq, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_mask is None else kv_mask.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in extra_ptrs),
                 out.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], B, H, Sq, k.shape[2], D,
                 *extra_ints,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 0 if kv_mask is None else kv_mask.stride(0),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return out, lse


def flash_attention(q, k, v, kv_mask=None):
    """q [B,H,Sq,D], k/v [B,H,Skv,D] (unit stride along D, any other
    strides), kv_mask [B,Skv] bool or None. Returns (out [B,H,Sq,D], lse
    [B,H,Sq] fp32), as `flash_attention_ref`; out is differentiable in q, k
    and v (backward: K3), lse is not. The operator
    `sam2_opt_tpu_torch::flash_attention`.

    CUDA tensors launch the kernel (fp32 or bf16, D a multiple of 8 up to
    128, or 256; rows 16-byte aligned); `out` is a [B,H,Sq,D] view of a
    [B,Sq,H,D] buffer, so the caller's merge of heads back into channels
    costs no copy (the plain version's is laid out alike). Where one CTA per
    128 query rows would leave SMs idle (memory attention at D = 256 with
    the rotation fusion off), the kernel splits the kv axis and a second
    kernel on the same stream merges the splits through their LSEs (fp32
    scratch allocated here).
    """
    _check(q, k, v, kv_mask)
    return _flash_op(q, k, v, kv_mask)


def _heads_last(out):
    """out [B,H,S,D] as a view of a [B,S,H,D] buffer, the kernels' layout."""
    return out.transpose(1, 2).contiguous().transpose(1, 2)


def _attention_fake(q, *_):
    B, H, Sq, D = q.shape
    return (q.new_empty((B, Sq, H, D)).transpose(1, 2),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@_build.operator("flash_attention", "(Tensor q, Tensor k, Tensor v, Tensor? kv_mask) -> "
                                    "(Tensor, Tensor)")
def _flash_op(q, k, v, kv_mask):
    out, lse = flash_attention_ref(q, k, v, kv_mask)
    return _heads_last(out), lse


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, kv_mask):
    _check_cuda(q, k, v, kv_mask, (*range(8, 129, 8), 256), "flash_attention")
    B, H, Sq, D = q.shape
    n_split = _kv_splits(q.device.index, _DTYPES[q.dtype], B, H, Sq, k.shape[2], D)
    out, lse = _launch(_library("sam2_flash_attention_fwd", 2, 1), q, k, v, kv_mask,
                       _split_scratch(q, n_split), (n_split,), "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
_flash_op.register_fake(_attention_fake)


def _save_attention(ctx, inputs, output):
    ctx.save_for_backward(*inputs, *output)
    ctx.mark_non_differentiable(output[1])


def _flash_backward(ctx, dout, _dlse):
    """K3 (the JAX `_attn_core`, :751-776)."""
    q, k, v, kv_mask, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, kv_mask)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


_flash_op.register_autograd(_flash_backward, setup_context=_save_attention)


def flash_attention_rope_ref(q, k, v, cos_k, sin_k, kv_mask=None):
    """Plain K2: K rotated in fp32 from its inputs (split layout, `cos_k`/
    `sin_k` [Skv, D/2]; rows with cos = 1, sin = 0 stay unrotated), rounded
    once to K's dtype, then `flash_attention_ref`. q arrives rotated.
    Returns (out, lse) as `flash_attention_ref`."""
    kr = apply_rotary_split(k.float(), cos_k.float(), sin_k.float()).to(k.dtype)
    return flash_attention_ref(q, kr, v, kv_mask)


def flash_attention_rope(q, k, v, cos_k, sin_k, kv_mask=None):
    """K2: q/k/v [B,H,S,D] (q already rotated, k not), cos_k/sin_k [Skv, D/2]
    in q's dtype, kv_mask [B,Skv] bool or None. Returns (out [B,H,Sq,D], lse
    [B,H,Sq] fp32), as `flash_attention_rope_ref`; out is differentiable in
    q, k and v (backward: K3 on the rotated K, dK rotated back), lse and the
    tables are not.

    CUDA tensors launch the rotation kernel, which writes the rotated K
    once to scratch allocated here, then K1's attention body on it (fp32 or
    bf16, D in 64/128/256, contiguous tables), with K1's kv split and merge;
    `out` is laid out as K1's. One launch on the count per call."""
    _check(q, k, v, kv_mask)
    D, Skv = q.shape[-1], k.shape[2]
    for name, t in (("cos_k", cos_k), ("sin_k", sin_k)):
        if tuple(t.shape) != (Skv, D // 2) or D % 2:
            raise ValueError(f"{name} must be [{Skv}, {D // 2}], got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must have q's dtype and device")
    return _flash_rope_op(q, k, v, cos_k, sin_k, kv_mask)


@_build.operator("flash_attention_rope", "(Tensor q, Tensor k, Tensor v, Tensor cos_k, "
                                         "Tensor sin_k, Tensor? kv_mask) -> (Tensor, Tensor)")
def _flash_rope_op(q, k, v, cos_k, sin_k, kv_mask):
    out, lse = flash_attention_rope_ref(q, k, v, cos_k, sin_k, kv_mask)
    return _heads_last(out), lse


@_flash_rope_op.register_kernel("cuda")
def _flash_rope_cuda(q, k, v, cos_k, sin_k, kv_mask):
    _check_cuda(q, k, v, kv_mask, (64, 128, 256), "flash_attention_rope")
    _check_tables(cos_k, sin_k)
    B, H, Sq, D = q.shape
    n_split = _kv_splits(q.device.index, _DTYPES[q.dtype], B, H, Sq, k.shape[2], D)
    kr = torch.empty(k.shape, dtype=k.dtype, device=k.device)  # the rotated K, contiguous
    out, lse = _launch(_library("sam2_flash_attention_rope_fwd", 5, 1), q, k, v, kv_mask,
                       (cos_k, sin_k, kr, *_split_scratch(q, n_split)), (n_split,),
                       "flash_attention_rope")
    flash_attention_rope.launches += 1
    return out, lse


flash_attention_rope.launches = 0
_flash_rope_op.register_fake(_attention_fake)


def _flash_rope_backward(ctx, dout, _dlse):
    """K3 (the JAX `_attn_core_rope`, :548-585). The rotation is linear, so
    K3 runs on K rotated as the forward rotates it (in fp32, rounded once to
    K's dtype) and dK is dK_rot rotated by -theta in fp32."""
    q, k, v, cos_k, sin_k, kv_mask, out, lse = ctx.saved_tensors
    c32, s32 = cos_k.float(), sin_k.float()
    kr = apply_rotary_split(k.float(), c32, s32).to(k.dtype)
    dq, dkr, dv = flash_attention_bwd(q, kr, v, out, lse, dout, kv_mask)
    dk = apply_rotary_split(dkr, c32, -s32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


_flash_rope_op.register_autograd(_flash_rope_backward, setup_context=_save_attention)


def _check_tables(cos_k, sin_k):
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (cos_k, sin_k)):
        raise ValueError("cos_k and sin_k must be contiguous and 16-byte aligned")


def rope_rotate(k, cos_k, sin_k):
    """K2's rotation alone: k [B,H,Skv,D] rotated in the split layout by
    cos_k/sin_k [Skv, D/2] (k's dtype), in fp32 with one rounding per
    operation and one to k's dtype, as `flash_attention_rope_ref` rotates.
    Returns a contiguous tensor like k. CUDA tensors launch the rotation
    kernel K2 runs before its attention (rows of k 16-byte aligned, D a
    multiple of 16 in bf16 and of 8 in fp32, tables contiguous); CPU tensors
    run `apply_rotary_split`."""
    if k.dim() != 4 or tuple(cos_k.shape) != (k.shape[2], k.shape[3] // 2) or k.shape[3] % 2:
        raise ValueError(f"k must be [B, H, Skv, D] and the tables [Skv, D/2], got "
                         f"{tuple(k.shape)}, {tuple(cos_k.shape)}")
    if sin_k.shape != cos_k.shape or k.dtype not in _DTYPES or any(
            t.dtype != k.dtype or t.device != k.device for t in (cos_k, sin_k)):
        raise ValueError("cos_k and sin_k must match k's dtype (float32 or bfloat16) and device")
    return _rope_rotate_op(k, cos_k, sin_k)


@_build.operator("rope_rotate", "(Tensor k, Tensor cos_k, Tensor sin_k) -> Tensor")
def _rope_rotate_op(k, cos_k, sin_k):
    return apply_rotary_split(k.float(), cos_k.float(), sin_k.float()).to(k.dtype).contiguous()


@_rope_rotate_op.register_kernel("cuda")
def _rope_rotate_cuda(k, cos_k, sin_k):
    if not _rows_aligned(k):
        raise ValueError("k rows must be 16-byte aligned")
    _check_tables(cos_k, sin_k)
    B, H, Skv, D = k.shape
    kr = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    fn = _build.load("flash_attention").sam2_flash_attention_rope_rotate
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 5 + [ll] * 3 + [p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = fn(k.data_ptr(), cos_k.data_ptr(), sin_k.data_ptr(), kr.data_ptr(), _DTYPES[k.dtype],
                 B, H, Skv, D, *k.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"rope_rotate kernel launch failed: cudaError {err}")
    rope_rotate.launches += 1
    return kr


rope_rotate.launches = 0
_rope_rotate_op.register_fake(lambda k, cos_k, sin_k: torch.empty_like(
    k, memory_format=torch.contiguous_format))


# --------------------------------------------------------------------------- #
# K4: K2 with the memory K/V projections fused in
# --------------------------------------------------------------------------- #


def _project(x, w, b, dtype):
    """x . w^T + b with fp32 sums and the bias added in fp32, rounded once to
    `dtype` (the JAX kernel's `dot(..., preferred_element_type=f32) + b`,
    :173-177): [B, S, Dm] -> [B, S, D]."""
    return F.linear(x.float(), w.float(), b.float()).to(dtype)


def kv_proj_rotate_ref(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k):
    """Plain version of K4's first kernel: kp = mem_k . wk^T + bk and vp =
    mem_v . wv^T + bv in fp32, each rounded once to wk's dtype, then kp
    rotated in fp32 from that rounding (split layout, `cos_k`/`sin_k`
    [Skv, D/2]) and rounded once, as `rope_rotate` rotates. mem_k/mem_v
    [B, Skv, Dm], wk/wv [D, Dm], bk/bv [D]. Returns (kr, vp), each
    [B, Skv, D]."""
    kp = _project(mem_k, wk, bk, wk.dtype)
    kr = apply_rotary_split(kp.float(), cos_k.float(), sin_k.float()).to(wk.dtype)
    return kr, _project(mem_v, wv, bv, wv.dtype)


def flash_attention_kv_proj_ref(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask=None):
    """Plain K4: `kv_proj_rotate_ref` (K and V projected in fp32 and rounded
    once to q's dtype, K rotated in fp32 from that rounding and rounded
    once), then `flash_attention_ref`.

    q [B, 1, Sq, D] rotated; mem_k/mem_v [B, Skv, Dm]; wk/wv [D, Dm]
    (`nn.Linear` layout; wk and bk with `split_perm` already applied), bk/bv
    [D]; cos_k/sin_k [Skv, D/2]; kv_mask [B, Skv] bool or None. Returns
    (out [B, 1, Sq, D], lse [B, 1, Sq] fp32)."""
    kr, vp = kv_proj_rotate_ref(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k)
    return flash_attention_ref(q, kr[:, None], vp[:, None], kv_mask)


def _kv_proj_check(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Sq, D] (one head), got {tuple(q.shape)}")
    B, _, Sq, D = q.shape
    if mem_k.dim() != 3 or mem_k.shape[0] != B or mem_v.shape != mem_k.shape:
        raise ValueError(f"mem_k/mem_v must be [{B}, Skv, Dm], got {tuple(mem_k.shape)}, "
                         f"{tuple(mem_v.shape)}")
    Skv, Dm = mem_k.shape[1:]
    if Sq == 0 or Skv == 0 or D % 2:
        raise ValueError("empty query or key sequence, or an odd head dim")
    for name, t, shape in (("wk", wk, (D, Dm)), ("wv", wv, (D, Dm)), ("bk", bk, (D,)),
                           ("bv", bv, (D,)), ("cos_k", cos_k, (Skv, D // 2)),
                           ("sin_k", sin_k, (Skv, D // 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} must be on q's device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (mem_k, mem_v, wk, wv, cos_k, sin_k)):
        raise ValueError("q, mem_k, mem_v, wk, wv and the tables must share one dtype, "
                         "float32 or bfloat16")
    if not (bk.is_floating_point() and bv.is_floating_point()):
        raise ValueError("the biases must be floating point")
    if mem_k.device != q.device or mem_v.device != q.device:
        raise ValueError("mem_k and mem_v must be on q's device")
    if kv_mask is not None and (kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (B, Skv)
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be bool [{B}, {Skv}] on q's device")


def flash_attention_kv_proj(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask=None):
    """K4: memory cross-attention with the K/V projections fused into the
    flash kernel. Arguments as `flash_attention_kv_proj_ref`; returns (out
    [B, 1, Sq, D], lse [B, 1, Sq] fp32). out is differentiable in q, mem_k,
    mem_v and the four projection parameters (backward: K3 on the recomputed
    projections, the projection products in torch), lse and the tables are
    not.

    CUDA tensors launch the kernels (fp32 or bf16, D = 256, Dm in {32, 64};
    the biases are passed in fp32): the first reads the memory Dm wide,
    projects it and rotates K once into [B, Skv, D] scratch allocated here,
    then K1's attention body runs on it, with K1's kv split and merge. One
    launch on the count per call. CPU tensors run the plain version."""
    _kv_proj_check(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask)
    return _kv_proj_op(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask)


def _aligned_rows(t):
    """t if its rows are 16-byte aligned (`_rows_aligned`), else a
    contiguous copy."""
    return t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _proj_operands(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k, what):
    """The projection kernel's operands as it takes them on the card: rows
    16-byte aligned, weights, tables and biases contiguous, the biases in
    fp32; plus empty contiguous kr and vp [B, Skv, D] in the weights'
    dtype."""
    B, Skv, Dm = mem_k.shape
    D = wk.shape[0]
    if D != 256 or Dm not in (32, 64):
        raise ValueError(f"{what}: D = {D}, Dm = {Dm} unsupported on the card (D = 256, Dm 32 "
                         "or 64)")
    mem_k, mem_v = _aligned_rows(mem_k), _aligned_rows(mem_v)
    wk, wv = _aligned_rows(wk.contiguous()), _aligned_rows(wv.contiguous())
    cos_k, sin_k = cos_k.contiguous(), sin_k.contiguous()
    bk, bv = bk.float().contiguous(), bv.float().contiguous()
    kr, vp = (torch.empty((B, Skv, D), dtype=wk.dtype, device=wk.device) for _ in range(2))
    return mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k, kr, vp


def kv_proj_rotate(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k):
    """K4's first kernel alone: (kr, vp) as `kv_proj_rotate_ref` computes
    them, each [B, Skv, D] contiguous. CUDA tensors launch the projection
    kernel K4 runs before its attention (D = 256, Dm 32 or 64, one dtype
    for the memory, weights and tables); CPU tensors run the plain
    version."""
    if mem_k.dim() != 3 or mem_v.shape != mem_k.shape or wk.dim() != 2 or wv.shape != wk.shape:
        raise ValueError(f"mem_k/mem_v must be [B, Skv, Dm] and wk/wv [D, Dm], got "
                         f"{tuple(mem_k.shape)}, {tuple(mem_v.shape)}, {tuple(wk.shape)}, "
                         f"{tuple(wv.shape)}")
    B, Skv, Dm = mem_k.shape
    D = wk.shape[0]
    for name, t, shape in (("wk", wk, (D, Dm)), ("bk", bk, (D,)), ("bv", bv, (D,)),
                           ("cos_k", cos_k, (Skv, D // 2)), ("sin_k", sin_k, (Skv, D // 2))):
        if tuple(t.shape) != shape or t.device != mem_k.device:
            raise ValueError(f"{name} must be {list(shape)} on mem_k's device, got "
                             f"{tuple(t.shape)}")
    if wk.dtype not in _DTYPES or any(t.dtype != wk.dtype
                                      for t in (mem_k, mem_v, wv, cos_k, sin_k)):
        raise ValueError("mem_k, mem_v, wk, wv and the tables must share one dtype, "
                         "float32 or bfloat16")
    if any(t.device != mem_k.device for t in (mem_v, wv)):
        raise ValueError("mem_v and wv must be on mem_k's device")
    return _kv_proj_rotate_op(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k)


@_build.operator("kv_proj_rotate", "(Tensor mem_k, Tensor wk, Tensor bk, Tensor mem_v, "
                                   "Tensor wv, Tensor bv, Tensor cos_k, Tensor sin_k) -> "
                                   "(Tensor, Tensor)")
def _kv_proj_rotate_op(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k):
    return tuple(t.contiguous() for t in kv_proj_rotate_ref(mem_k, wk, bk, mem_v, wv, bv, cos_k,
                                                            sin_k))


@_kv_proj_rotate_op.register_kernel("cuda")
def _kv_proj_rotate_cuda(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k):
    B, Skv, Dm = mem_k.shape
    D = wk.shape[0]
    mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k, kr, vp = _proj_operands(
        mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k, "kv_proj_rotate")
    fn = _build.load("flash_attention").sam2_flash_attention_kvproj_project
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 5 + [ll] * 4 + [p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(mem_k.device):
        stream = torch.cuda.current_stream(mem_k.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kr, vp)),
                 _DTYPES[wk.dtype], B, Skv, D, Dm,
                 mem_k.stride(0), mem_k.stride(1), mem_v.stride(0), mem_v.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"kv_proj_rotate kernel launch failed: cudaError {err}")
    kv_proj_rotate.launches += 1
    return kr, vp


kv_proj_rotate.launches = 0


@_kv_proj_rotate_op.register_fake
def _kv_proj_rotate_fake(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k):
    shape = (*mem_k.shape[:2], wk.shape[0])
    return wk.new_empty(shape), wk.new_empty(shape)


@_build.operator("flash_attention_kv_proj", "(Tensor q, Tensor mem_k, Tensor mem_v, Tensor wk, "
                                            "Tensor bk, Tensor wv, Tensor bv, Tensor cos_k, "
                                            "Tensor sin_k, Tensor? kv_mask) -> (Tensor, Tensor)")
def _kv_proj_op(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask):
    return flash_attention_kv_proj_ref(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask)


@_kv_proj_op.register_kernel("cuda")
def _kv_proj_cuda(q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask):
    B, _, Sq, D = q.shape
    Skv, Dm = mem_k.shape[1:]
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the grid limit 65535")
    mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k, kr, vp = _proj_operands(
        mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k, "flash_attention_kv_proj")
    q = _aligned_rows(q)
    if kv_mask is not None and kv_mask.stride(-1) != 1:
        kv_mask = kv_mask.contiguous()
    dtype = _DTYPES[q.dtype]
    n_split = _kv_splits(q.device.index, dtype, B, 1, Sq, Skv, D)  # K1's: K4 runs K1's body
    part_o, part_lse = _split_scratch(q, n_split)
    out = torch.empty((B, 1, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, 1, Sq), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention").sam2_flash_attention_kvproj_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 16 + [i] * 7 + [ll] * 9 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(ptr(t) for t in (q, mem_k, mem_v, wk, bk, wv, bv, kv_mask, cos_k, sin_k,
                                    kr, vp, part_o, part_lse, out, lse)),
                 dtype, B, Sq, Skv, D, Dm, n_split,
                 q.stride(0), q.stride(2), mem_k.stride(0), mem_k.stride(1),
                 mem_v.stride(0), mem_v.stride(1), out.stride(0), out.stride(2),
                 0 if kv_mask is None else kv_mask.stride(0), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_kv_proj kernel launch failed: cudaError {err}")
    flash_attention_kv_proj.launches += 1
    return out, lse


flash_attention_kv_proj.launches = 0


@_kv_proj_op.register_fake
def _kv_proj_fake(q, *_):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)


def _kv_proj_backward(ctx, dout, _dlse):
    """K3: the JAX `_attn_rope_kvproj_bwd` (:647-685). The projections are
    recomputed at the kernel's precision, K3 runs on (q, rotated K, V), dK
    is rotated back by -theta in fp32, and the cotangents of the
    projections, rounded to the input dtype, go through the four weight and
    input products in torch (XLA computes them in the JAX package, outside
    any Pallas kernel); the bias gradients are sums of the fp32
    cotangents."""
    q, mem_k, mem_v, wk, bk, wv, bv, cos_k, sin_k, kv_mask, out, lse = ctx.saved_tensors
    dt = q.dtype
    c32, s32 = cos_k.float(), sin_k.float()
    kr, vp = kv_proj_rotate_ref(mem_k, wk, bk, mem_v, wv, bv, cos_k, sin_k)
    dq, dkr, dvp = flash_attention_bwd(q, kr[:, None], vp[:, None], out, lse, dout, kv_mask)
    dmk, dwk, dbk = _projection_grads(mem_k, wk, bk, apply_rotary_split(dkr[:, 0], c32, -s32))
    dmv, dwv, dbv = _projection_grads(mem_v, wv, bv, dvp[:, 0])
    return dq.to(dt), dmk, dmv, dwk, dbk, dwv, dbv, None, None, None


_kv_proj_op.register_autograd(_kv_proj_backward, setup_context=_save_attention)


def _projection_grads(x, w, b, g):
    """(dx, dw, db) of x . w^T + b for its fp32 cotangent g [B, S, D]: g
    rounded to the input dtype for the two products (fp32 sums), db summed
    from g in fp32 (the JAX `_attn_rope_kvproj_bwd`, :666-673)."""
    g_l = g.to(x.dtype).float()
    dx = torch.matmul(g_l, w.float())
    dw = torch.matmul(g_l.flatten(0, 1).t(), x.float().flatten(0, 1))
    return dx.to(x.dtype), dw.to(w.dtype), g.sum((0, 1)).to(b.dtype)


# --------------------------------------------------------------------------- #
# K3: the backward
# --------------------------------------------------------------------------- #


def _bwd_probs(q, k, v, do, lse, delta, kv_mask):
    """P and dS of one batch row, as K3 forms them: p = exp(s - lse) where
    the key is valid and lse > -0.5e30, dS = p (dP - delta) rounded to q's
    dtype; fp32 otherwise."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    live = (lse > NEG_INF * 0.5)[..., None]
    if kv_mask is not None:
        live = live & kv_mask[:, None, None, :]
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p, ds, scale


def flash_attention_bwd_dkdv_ref(q, k, v, do, lse, delta, kv_mask=None):
    """Plain K3a: (dK, dV) [B,H,Skv,D] fp32; p rounded to dO's dtype for dV,
    dS to q's dtype for dK, fp32 sums. One batch row at a time, so the
    [H, Sq, Skv] temporaries of one row bound the memory."""
    dk, dv = [], []
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        p, ds, scale = _bwd_probs(q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl],
                                  None if kv_mask is None else kv_mask[sl])
        dv.append(torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do[sl].float()))
        dk.append(torch.matmul(ds.transpose(-1, -2), q[sl].float()) * scale)
    return torch.cat(dk), torch.cat(dv)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, kv_mask=None):
    """Plain K3b: dQ [B,H,Sq,D] fp32 (dS rounded to q's dtype, fp32 sums)."""
    dq = []
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        _, ds, scale = _bwd_probs(q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl],
                                  None if kv_mask is None else kv_mask[sl])
        dq.append(torch.matmul(ds, k[sl].float()) * scale)
    return torch.cat(dq)


def flash_attention_bwd_bf16_bound(q, k, v, do, lse, delta, kv_mask=None):
    """Per-element bounds (dQ, dK, dV) on |K3 - plain K3| for bf16 inputs.
    Both round the same P and dS to bf16, but from fp32 values whose sums
    ran in other orders, so a rounding may land one ulp (2^-7 relative)
    apart, and the logits and dP may differ by the fp32 sum-order error
    (taken as 2^-16 of the sum of |terms|). With
      eP  = p (2^-7 + 2^-16 scale |Q||K|^T)
      edS = 2^-7 |dS| + p (2^-16 scale (|Q||K|^T) |dP - delta| + 2^-16 |dO||V|^T)
    the bounds are eP^T |dO|, scale edS^T |Q| and scale edS |K|, formed one
    batch row at a time."""
    u, n = 2.0 ** -7, 2.0 ** -16
    bq, bk, bv = [], [], []
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        p, ds, scale = _bwd_probs(q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl],
                                  None if kv_mask is None else kv_mask[sl])
        qa, ka, va, da = (x[sl].float().abs() for x in (q, k, v, do))
        qk = torch.matmul(qa, ka.transpose(-1, -2)) * scale
        dp = torch.matmul(do[sl].float(), v[sl].float().transpose(-1, -2)) - delta[sl][..., None]
        ep = p * (u + n * qk)
        eds = u * ds.abs() + p * (n * qk * dp.abs() + n * torch.matmul(da, va.transpose(-1, -2)))
        del qk, dp, ds
        bv.append(torch.matmul(ep.transpose(-1, -2), da))
        bk.append(torch.matmul(eds.transpose(-1, -2), qa) * scale)
        bq.append(torch.matmul(eds, ka) * scale)
        del p, ep, eds
    return torch.cat(bq), torch.cat(bk), torch.cat(bv)


def flash_attention_bwd_delta(out, do):
    """rowsum(dO * O) in fp32 (the JAX package's XLA pass, :488-490)."""
    return (do.float() * out.float()).sum(-1)


def flash_attention_bwd_ref(q, k, v, out, lse, do, kv_mask=None):
    """Plain K3: (dQ, dK, dV) fp32 of `flash_attention_ref`'s output, given
    its out and lse and the output gradient dO (the JAX `_flash_bwd`)."""
    delta = flash_attention_bwd_delta(out, do)
    dk, dv = flash_attention_bwd_dkdv_ref(q, k, v, do, lse, delta, kv_mask)
    return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, kv_mask), dk, dv


def _bwd_library(symbol):
    """The C entry points of K3: q, k, v, mask, dout, lse, delta, dq, dk, dv,
    dtype, B, H, Sq, Skv, D, 13 strides, scale, stream. Where the kernel
    splits its streamed axis, the pointer it does not write (K3a's dq, K3b's
    dk) carries its fp32 scratch."""
    fn = getattr(_build.load("flash_attention_bwd"), symbol)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 6 + [ll] * 13 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_check(q, k, v, do, lse, delta, kv_mask):
    _check(q, k, v, kv_mask)
    B, H, Sq, _ = q.shape
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dout must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be fp32 [{B}, {H}, {Sq}] on q's device")


@lru_cache(maxsize=64)
def bwd_splits(dq: bool, device_index: int, dtype: int, B: int, H: int, Sq: int, Skv: int,
               D: int) -> int:
    """The number of CTAs over which K3a (`dq` False: query tiles) or K3b
    (kv tiles) splits its streamed axis for a shape on a device, as the
    kernel's library chooses it (bf16 only, where the grid alone would leave
    SMs idle); 1 = no split. Asked once per shape."""
    fn = _build.load("flash_attention_bwd").sam2_flash_attention_bwd_splits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        return fn(int(dq), dtype, B, H, Sq, Skv, D)


def bwd_tiling(dq: bool, dtype: torch.dtype, B: int, H: int, Sq: int, Skv: int,
               D: int) -> dict:
    """K3a's (`dq` False) or K3b's launch geometry for a shape on the current
    device, as the kernel's library reports it: rows of the CTA axis per CTA
    (K3a keys, K3b query rows), rows of the streamed axis per step, the
    grid's CTAs over every split, and the split."""
    fn = _build.load("flash_attention_bwd").sam2_flash_attention_bwd_tiling
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
    out = (ctypes.c_int * 4)()
    fn(int(dq), _DTYPES[dtype], B, H, Sq, Skv, D, out)
    return dict(zip(("cta_rows", "step_rows", "ctas", "n_split"), out))


def _bwd_launch(symbol, q, k, v, do, lse, delta, kv_mask, what):
    """Checks, allocates the fp32 gradients (and the split's fp32 partial
    sums) and launches K3a or K3b on the current stream; raises on a
    refused launch."""
    _check_cuda(q, k, v, kv_mask, range(8, 257, 8), what)
    # the kernels copy rows in 16-byte chunks
    q, k, v, do = (_aligned_rows(t) for t in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    is_dq = symbol.endswith("dq")
    n_split = bwd_splits(is_dq, q.device.index, _DTYPES[q.dtype], B, H, Sq, Skv, D)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = dk = dv = None
    if is_dq:
        dq = torch.empty((B, H, Sq, D), **f32)
        if n_split > 1:
            dk = torch.empty((n_split, B * H, Sq, D), **f32)
    else:
        dk = torch.empty((B, H, Skv, D), **f32)
        dv = torch.empty_like(dk)
        if n_split > 1:
            dq = torch.empty((2, n_split, B * H, Skv, D), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_library(symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(None if t is None else t.data_ptr() for t in (dq, dk, dv)),
            _DTYPES[q.dtype], B, H, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            0 if kv_mask is None else kv_mask.stride(0), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return (dq, None, None) if is_dq else (None, dk, dv)


_BWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, "
               "Tensor? kv_mask) -> ")


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kv_mask=None):
    """K3a: (dK, dV) [B,H,Skv,D] fp32 from q/k/v/dO [B,H,S,D] (unit stride
    along D, any other strides), the forward's lse and delta = rowsum(dO*O)
    [B,H,Sq] fp32. CUDA tensors launch the kernel (fp32 or bf16, D a
    multiple of 8 up to 256); CPU tensors run `flash_attention_bwd_dkdv_ref`.
    The operator `sam2_opt_tpu_torch::flash_attention_bwd_dkdv`."""
    _bwd_check(q, k, v, do, lse, delta, kv_mask)
    return _bwd_dkdv_op(q, k, v, do, lse, delta, kv_mask)


@_build.operator("flash_attention_bwd_dkdv", _BWD_SCHEMA + "(Tensor, Tensor)")
def _bwd_dkdv_op(q, k, v, do, lse, delta, kv_mask):
    return flash_attention_bwd_dkdv_ref(q, k, v, do, lse, delta, kv_mask)


@_bwd_dkdv_op.register_kernel("cuda")
def _bwd_dkdv_cuda(q, k, v, do, lse, delta, kv_mask):
    _, dk, dv = _bwd_launch("sam2_flash_attention_bwd_dkdv", q, k, v, do, lse, delta, kv_mask,
                            "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd_dkdv.launches = 0
_bwd_dkdv_op.register_fake(lambda q, k, *_: (k.new_empty(k.shape, dtype=torch.float32),
                                             k.new_empty(k.shape, dtype=torch.float32)))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask=None):
    """K3b: dQ [B,H,Sq,D] fp32; arguments as `flash_attention_bwd_dkdv`.
    CPU tensors run `flash_attention_bwd_dq_ref`. The operator
    `sam2_opt_tpu_torch::flash_attention_bwd_dq`."""
    _bwd_check(q, k, v, do, lse, delta, kv_mask)
    return _bwd_dq_op(q, k, v, do, lse, delta, kv_mask)


@_build.operator("flash_attention_bwd_dq", _BWD_SCHEMA + "Tensor")
def _bwd_dq_op(q, k, v, do, lse, delta, kv_mask):
    return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, kv_mask)


@_bwd_dq_op.register_kernel("cuda")
def _bwd_dq_cuda(q, k, v, do, lse, delta, kv_mask):
    dq, _, _ = _bwd_launch("sam2_flash_attention_bwd_dq", q, k, v, do, lse, delta, kv_mask,
                           "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0
_bwd_dq_op.register_fake(lambda q, *_: q.new_empty(q.shape, dtype=torch.float32))


def flash_attention_bwd(q, k, v, out, lse, do, kv_mask=None):
    """K3: (dQ, dK, dV) fp32 of attention with output `out` and row
    log-sum-exp `lse`, for the output gradient dO: delta = rowsum(dO * O)
    in fp32, then K3a and K3b (on the CPU, their plain versions)."""
    delta = flash_attention_bwd_delta(out, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kv_mask)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask), dk, dv


# --------------------------------------------------------------------------- #
# The relative-position attention of SAM's ViT blocks
# --------------------------------------------------------------------------- #

RELPOS_HEAD_DIMS = (64, 80)  # SAM ViT-B and ViT-L (64), ViT-H (80)
RELPOS_MAX_GRID = 64         # Kh, Kw: the global blocks' 64 x 64 at 1024²
RELPOS_MIN_KW = 8            # Kw: a thread's keys step 8 a chunk, one wrap at most


def relpos_grid(rel_pos_h, rel_pos_w):
    """(Kh, Kw) of tables of 2 Kh - 1 and 2 Kw - 1 rows."""
    return (rel_pos_h.shape[0] + 1) // 2, (rel_pos_w.shape[0] + 1) // 2


def relpos_products(q, rel_pos_h, rel_pos_w):
    """q [B,H,S,D] times both tables' rows: [B,H,S,(2Kh-1)+(2Kw-1)] in q's
    dtype (fp32 sums, one rounding), the kernel's input. One batched
    product over the heads, which reads the ViT's q (a strided view of its
    qkv projection) in place: a [B,H,S,R] view of an [H,B,S,R] buffer."""
    B, H, S, D = q.shape
    tables = torch.cat([rel_pos_h, rel_pos_w]).t()
    out = torch.bmm(q.transpose(0, 1).reshape(H, B * S, D), tables.expand(H, *tables.shape))
    return out.view(H, B, S, -1).transpose(0, 1)


def relpos_terms_from_products(rel, Kh: int, Kw: int):
    """The bias terms rel_h [B,H,S,Kh], rel_w [B,H,S,Kw] gathered from
    `relpos_products` as upstream's `get_rel_pos` indexes its tables: key
    (kh, kw) of query (qh, qw) takes rows qh - kh + Kh - 1 and
    qw - kw + Kw - 1."""
    qh = torch.arange(Kh, device=rel.device).repeat_interleave(Kw)
    qw = torch.arange(Kw, device=rel.device).repeat(Kh)
    ih = qh[:, None] - torch.arange(Kh, device=rel.device)[None, :] + Kh - 1
    iw = qw[:, None] - torch.arange(Kw, device=rel.device)[None, :] + Kw - 1 + 2 * Kh - 1
    S = Kh * Kw
    rows = torch.arange(S, device=rel.device)[:, None]
    return rel[..., rows, ih], rel[..., rows, iw]


def flash_attention_relpos_ref(q, k, v, rel_pos_h, rel_pos_w):
    """Plain version: the bias terms from q's products with the tables
    (fp32 sums rounded once to q's dtype, `relpos_products`), gathered;
    s = q . k^T / sqrt(D) in fp32 plus rel_h[..., j // Kw] + rel_w[..., j %
    Kw] for key j; softmax in fp32; the probabilities rounded to v's dtype
    before p . v, as the kernel does. q/k/v [B,H,S,D] over a Kh x Kw grid,
    rel_pos_h [2Kh-1, D], rel_pos_w [2Kw-1, D]. Returns out [B,H,S,D] in
    q's dtype."""
    B, H, S, D = q.shape
    Kh, Kw = relpos_grid(rel_pos_h, rel_pos_w)
    rel = relpos_products(q.float(), rel_pos_h.float(), rel_pos_w.float()).to(q.dtype)
    rel_h, rel_w = relpos_terms_from_products(rel, Kh, Kw)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(D))
    s = (s.view(B, H, S, Kh, Kw) + rel_h.float()[..., :, None]
         + rel_w.float()[..., None, :]).view(B, H, S, Kh * Kw)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(-1, keepdim=True)
    return out.to(q.dtype)


def flash_attention_relpos(q, k, v, rel_pos_h, rel_pos_w):
    """Self-attention over a Kh x Kw grid with upstream's decomposed
    relative-position bias (SAM's ViT, segment_anything/modeling/
    image_encoder.py `add_decomposed_rel_pos`), as
    `flash_attention_relpos_ref`: q/k/v [B,H,S,D] (unit stride along D),
    S = Kh * Kw in raster order, rel_pos_h [2Kh-1, D] and rel_pos_w [2Kw-1,
    D] in q's dtype. Returns out [B,H,S,D], a view of a [B,S,H,D] buffer as
    K1's. Not differentiable: the ViT takes it only without grad. The
    operator `sam2_opt_tpu_torch::flash_attention_relpos`.

    CUDA tensors (bf16, D in `RELPOS_HEAD_DIMS`, Kh and Kw at most 64, Kw
    even and at least 8, rows 16-byte aligned) take q's products with both tables as one
    cuBLAS product, then launch `flash_relpos_wgmma_kernel`: K1's
    warp-specialised body, each CTA gathering its rows' bias terms from the
    products into shared memory and adding them to S in the softmax, so the
    S x S bias is never formed; one launch on the count per call."""
    _check(q, k, v, None)
    S = q.shape[2]
    Kh, Kw = relpos_grid(rel_pos_h, rel_pos_w)
    if k.shape[2] != S or Kh * Kw != S or any(t.shape[0] % 2 == 0 for t in (rel_pos_h,
                                                                             rel_pos_w)):
        raise ValueError(f"tables of {rel_pos_h.shape[0]} and {rel_pos_w.shape[0]} rows do not "
                         f"make a grid of {S} queries and {k.shape[2]} keys")
    for t in (rel_pos_h, rel_pos_w):
        if t.dim() != 2 or t.shape[1] != q.shape[3] or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("the tables must be [2K - 1, D] in q's dtype and device")
    return _relpos_op(q, k, v, rel_pos_h, rel_pos_w)


@_build.operator("flash_attention_relpos", "(Tensor q, Tensor k, Tensor v, Tensor rel_pos_h, "
                                           "Tensor rel_pos_w) -> Tensor")
def _relpos_op(q, k, v, rel_pos_h, rel_pos_w):
    return _heads_last(flash_attention_relpos_ref(q, k, v, rel_pos_h, rel_pos_w))


@_relpos_op.register_kernel("cuda")
def _relpos_cuda(q, k, v, rel_pos_h, rel_pos_w):
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_relpos: the kernel runs bf16, got {q.dtype}")
    _check_cuda(q, k, v, None, RELPOS_HEAD_DIMS, "flash_attention_relpos")
    B, H, S, D = q.shape
    Kh, Kw = relpos_grid(rel_pos_h, rel_pos_w)
    if max(Kh, Kw) > RELPOS_MAX_GRID or Kw < RELPOS_MIN_KW or Kw % 2:
        raise ValueError(f"flash_attention_relpos: a {Kh} x {Kw} grid (at most "
                         f"{RELPOS_MAX_GRID} each way, Kw even and at least {RELPOS_MIN_KW})")
    rel = relpos_products(q, rel_pos_h, rel_pos_w)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = _build.load("flash_attention").sam2_flash_attention_relpos_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [i] * 7 + [ll] * 15 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
                 B, H, S, S, D, Kh, Kw, *rel.stride()[:3], *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_relpos kernel launch failed: cudaError {err}")
    flash_attention_relpos.launches += 1
    return out


flash_attention_relpos.launches = 0
_relpos_op.register_fake(lambda q, *_: _attention_fake(q)[0])

