"""Masked flash-attention forward (K1): CUDA kernel wrapper and plain version.

`flash_attention` is the port of `sam2_opt_tpu/kernels/flash_attention.py::_kernel`
(the Pallas TPU kernel). On a CUDA tensor it launches the hand-written kernel
in `csrc/flash_attention.cu` or raises; on a CPU tensor it runs
`flash_attention_ref`, the unfused form of the same math. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sam2_opt_tpu_torch.kernels import _build

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


def _library():
    lib = _build.load("flash_attention")
    fn = lib.sam2_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i] + [ll] * 13 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, kv_mask=None):
    """q [B,H,Sq,D], k/v [B,H,Skv,D] (unit stride along D, any other
    strides), kv_mask [B,Skv] bool or None. Returns (out [B,H,Sq,D], lse
    [B,H,Sq] fp32), as `flash_attention_ref`.

    CUDA tensors launch the kernel (fp32 or bf16, D a multiple of 8 up to
    128; bf16 rows 16-byte aligned); `out` is a [B,H,Sq,D] view of a
    [B,Sq,H,D] buffer, so the caller's merge of heads back into channels
    costs no copy.
    """
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"head dim {D} unsupported: must be a multiple of 8 in [8, 128]")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along the head dim")
        # the bf16 kernel copies rows in 16-byte chunks
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(st % 8 for st in strides)):
            raise ValueError(f"bf16 {name} rows must be 16-byte aligned (strides multiples of 8)")
    if kv_mask is not None and kv_mask.stride(-1) != 1:
        raise ValueError("kv_mask must have unit stride along the key axis")
    fn = _library()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_mask is None else kv_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], B, H, Sq, Skv, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 0 if kv_mask is None else kv_mask.stride(0),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
