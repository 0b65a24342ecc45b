"""Masked flash attention: CUDA kernel wrappers, plain versions and the
autograd Functions that join them.

- K1, `flash_attention`: the port of
  `sam2_opt_tpu/kernels/flash_attention.py::_kernel`;
- K2, `flash_attention_rope`: the port of `::_kernel_rope`, K1 with K
  rotated inside the kernel (split-layout axial RoPE);
- K3, `flash_attention_bwd` (K3a `flash_attention_bwd_dkdv`, K3b
  `flash_attention_bwd_dq`): the port of `::_bwd_dkdv_kernel` and
  `::_bwd_dq_kernel`, the backward of both.

`flash_attention` and `flash_attention_rope` are differentiable: each runs
through a `torch.autograd.Function` (the counterparts of the JAX custom-VJP
seams `_attn_core` and `_attn_core_rope`) that saves q, k, v, out and lse and
whose backward is K3. On a CUDA tensor each wrapper launches its
hand-written kernel in `csrc/flash_attention.cu` or
`csrc/flash_attention_bwd.cu` or raises; on a CPU tensor it runs its plain
version (`flash_attention_ref`, `flash_attention_rope_ref`,
`flash_attention_bwd_ref`), the unfused form of the same math. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

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


def _library(symbol="sam2_flash_attention_fwd", n_ptrs=0, n_ints=0):
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
def _rope_splits(device_index: int, dtype: int, B: int, H: int, Sq: int, Skv: int, D: int) -> int:
    """K2's kv split for a shape on a device, as the kernel's library chooses
    it (from its CTAs' occupancy); asked once per shape."""
    fn = _build.load("flash_attention").sam2_flash_attention_rope_splits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        n_split = fn(dtype, B, H, Sq, Skv, D)
    if n_split < 1:
        raise ValueError(f"flash_attention_rope: no kv split for D = {D}")
    return n_split


def _check_cuda(q, k, v, kv_mask, head_dims, what):
    B, H, Sq, D = q.shape
    if D not in head_dims:
        raise ValueError(f"{what}: head dim {D} unsupported on the card ({head_dims})")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along the head dim")
        # the bf16 kernels copy rows in 16-byte chunks
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(st % 8 for st in strides)):
            raise ValueError(f"bf16 {name} rows must be 16-byte aligned (strides multiples of 8)")
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
    and v (backward: K3), lse is not.

    CUDA tensors launch the kernel (fp32 or bf16, D a multiple of 8 up to
    128; bf16 rows 16-byte aligned); `out` is a [B,H,Sq,D] view of a
    [B,Sq,H,D] buffer, so the caller's merge of heads back into channels
    costs no copy.
    """
    _check(q, k, v, kv_mask)
    return _FlashAttention.apply(q, k, v, kv_mask)


def _flash_forward(q, k, v, kv_mask):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, kv_mask, range(8, 129, 8), "flash_attention")
    out, lse = _launch(_library(), q, k, v, kv_mask, (), (), "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K3 backward (the JAX `_attn_core`, :751-776)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, lse = _flash_forward(q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, kv_mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


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

    CUDA tensors launch the kernel, which rotates each K tile as it arrives
    (fp32 or bf16, D in 64/128/256, contiguous tables); `out` is laid out as
    K1's. Where one CTA per 64 query rows would leave SMs idle, the kernel
    splits the kv axis and a second kernel on the same stream merges the
    splits through their LSEs (fp32 scratch allocated here)."""
    _check(q, k, v, kv_mask)
    D, Skv = q.shape[-1], k.shape[2]
    for name, t in (("cos_k", cos_k), ("sin_k", sin_k)):
        if tuple(t.shape) != (Skv, D // 2) or D % 2:
            raise ValueError(f"{name} must be [{Skv}, {D // 2}], got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must have q's dtype and device")
    return _FlashAttentionRope.apply(q, k, v, cos_k, sin_k, kv_mask)


def _flash_rope_forward(q, k, v, cos_k, sin_k, kv_mask):
    if q.device.type == "cpu":
        return flash_attention_rope_ref(q, k, v, cos_k, sin_k, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, kv_mask, (64, 128, 256), "flash_attention_rope")
    if not (cos_k.is_contiguous() and sin_k.is_contiguous()):
        raise ValueError("cos_k and sin_k must be contiguous")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    n_split = _rope_splits(q.device.index, _DTYPES[q.dtype], B, H, Sq, Skv, D)
    part_o = part_lse = None
    if n_split > 1:
        part_o = torch.empty((n_split, B * H, Sq, D), dtype=torch.float32, device=q.device)
        part_lse = torch.empty((n_split, B * H, Sq), dtype=torch.float32, device=q.device)
    out, lse = _launch(_library("sam2_flash_attention_rope_fwd", 4, 1), q, k, v, kv_mask,
                       (cos_k, sin_k, part_o, part_lse), (n_split,), "flash_attention_rope")
    flash_attention_rope.launches += 1
    return out, lse


flash_attention_rope.launches = 0


class _FlashAttentionRope(torch.autograd.Function):
    """K2 forward, K3 backward (the JAX `_attn_core_rope`, :548-585). The
    rotation is linear, so K3 runs on K rotated as the forward rotates it (in
    fp32, rounded once to K's dtype) and dK is dK_rot rotated by -theta in
    fp32."""

    @staticmethod
    def forward(ctx, q, k, v, cos_k, sin_k, kv_mask):
        out, lse = _flash_rope_forward(q, k, v, cos_k, sin_k, kv_mask)
        ctx.save_for_backward(q, k, v, cos_k, sin_k, out, lse, kv_mask)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, cos_k, sin_k, out, lse, kv_mask = ctx.saved_tensors
        c32, s32 = cos_k.float(), sin_k.float()
        kr = apply_rotary_split(k.float(), c32, s32).to(k.dtype)
        dq, dkr, dv = flash_attention_bwd(q, kr, v, out, lse, dout, kv_mask)
        dk = apply_rotary_split(dkr, c32, -s32)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


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
    dtype, B, H, Sq, Skv, D, 13 strides, scale, stream."""
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


def _bwd_launch(symbol, q, k, v, do, lse, delta, kv_mask, what):
    """Checks, allocates the fp32 gradients and launches K3a or K3b on the
    current stream; raises on a refused launch."""
    _check_cuda(q, k, v, kv_mask, range(8, 257, 8), what)
    aligned = do.stride(-1) == 1 and (q.dtype != torch.bfloat16 or (
        do.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in do.stride()[:3])))
    if not aligned:
        do = do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    dq = dk = dv = None
    if symbol.endswith("dq"):
        dq = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    else:
        dk = torch.empty((B, H, Skv, D), dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
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
    return dq, dk, dv


def _bwd_device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kv_mask=None):
    """K3a: (dK, dV) [B,H,Skv,D] fp32 from q/k/v/dO [B,H,S,D] (unit stride
    along D, any other strides), the forward's lse and delta = rowsum(dO*O)
    [B,H,Sq] fp32. CUDA tensors launch the kernel (fp32 or bf16, D a
    multiple of 8 up to 256); CPU tensors run `flash_attention_bwd_dkdv_ref`."""
    _bwd_check(q, k, v, do, lse, delta, kv_mask)
    if not _bwd_device(q):
        return flash_attention_bwd_dkdv_ref(q, k, v, do, lse, delta, kv_mask)
    _, dk, dv = _bwd_launch("sam2_flash_attention_bwd_dkdv", q, k, v, do, lse, delta, kv_mask,
                            "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd_dkdv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask=None):
    """K3b: dQ [B,H,Sq,D] fp32; arguments as `flash_attention_bwd_dkdv`.
    CPU tensors run `flash_attention_bwd_dq_ref`."""
    _bwd_check(q, k, v, do, lse, delta, kv_mask)
    if not _bwd_device(q):
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, kv_mask)
    dq, _, _ = _bwd_launch("sam2_flash_attention_bwd_dq", q, k, v, do, lse, delta, kv_mask,
                           "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, kv_mask=None):
    """K3: (dQ, dK, dV) fp32 of attention with output `out` and row
    log-sum-exp `lse`, for the output gradient dO: delta = rowsum(dO * O)
    in fp32, then K3a and K3b (on the CPU, their plain versions)."""
    delta = flash_attention_bwd_delta(out, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kv_mask)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask), dk, dv
