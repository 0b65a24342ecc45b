"""The four attention switches of the JAX package, read by the PyTorch port
as the JAX package reads them, on the CPU:

- `SAM2_TPU_FAST_SOFTMAX=0`: bf16 inputs keep fp32 logits, in plain
  attention and in a hiera_t block's attention (the split route's plain
  branch under `SAM2_TPU_FLASH=1`, plain attention under "auto");
- `SAM2_TPU_FLASH` at "auto", "0" and "1": the port takes the same kernel
  routes (K1, K2, K4 in memory attention; K5, K6, K7 in the hiera_t trunk)
  as the JAX package, counted on both sides. The JAX side is traced with
  `jax.eval_shape`, which calls every route's wrapper without running it;
- `SAM2_TPU_KERNEL_FAST_EXP=1`: refused on a bf16 route to K1 or K2 (not
  K4's, which the JAX package's switch leaves alone).

`SAM2_TPU_XLA_ATTN_BWD` is not read: the JAX package's XLA backward and
K3 compute the same exact gradient, which the gradients here hold against
JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2_opt_tpu.kernels.flash_attention as jax_fa
import sam2_opt_tpu_torch.kernels.flash_attention as port_fa
import sam2_opt_tpu_torch.kernels.window_attention as port_wa
from sam2_opt_tpu.config import MemoryAttentionConfig as JaxMemoryAttentionConfig
from sam2_opt_tpu.kernels import window_attention as jax_wa
from sam2_opt_tpu.models import hiera as jax_hiera
from sam2_opt_tpu.models import memory_attention as jax_ma
from sam2_opt_tpu.ops import common as jax_ops
from sam2_opt_tpu_torch.config import MemoryAttentionConfig, model_config
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models import hiera as port_hiera
from sam2_opt_tpu_torch.models import memory_attention as port_ma
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.ops import common as port_ops

torch.set_num_threads(2)

SWITCHES = ("SAM2_TPU_FLASH", "SAM2_TPU_FAST_SOFTMAX", "SAM2_TPU_KERNEL_FAST_EXP", "SAM2_TPU_FUSED_ROPE", "SAM2_TPU_FUSED_KV_PROJ",
            "SAM2_TPU_WINDOW_KERNEL", "SAM2_TPU_FLASH_WINDOW_MIN", "SAM2_TPU_PACKED_WINDOW",
            "SAM2_TPU_SPLIT_WINDOW_MIN", "SAM2_TPU_FUSED_MLP")
# The same function on the same bf16 inputs: with fp32 logits on both
# sides only the roundings of p and of the output remain, which land on the
# same bf16 values here (0 measured); the bound is one bf16 ulp at the
# output's scale (2^-8). With bf16 logits on one side the two differ by
# 2.1e-2 (attention) and 2.3e-2 (the block) of max |out|.
FAST_SOFTMAX_OFF_TOL = 2.0 ** -8  # of max |out|


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def port_trunk(tiny128_params):
    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    module = base.SAM2Base(model_config("hiera_t", image_size=128))
    module.load_state_dict(sd, strict=True)
    return copy.deepcopy(module.image_encoder.trunk.eval()).to(torch.bfloat16)


def _counting(counts, key, fn):
    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    return wrapper


# --------------------------------------------------------------------------- #
# SAM2_TPU_FAST_SOFTMAX=0
# --------------------------------------------------------------------------- #


def test_fast_softmax_off_attention_matches_jax(monkeypatch):
    """bf16 plain attention under `SAM2_TPU_FAST_SOFTMAX=0` against the JAX
    package's, logits large enough (q, k ~ 2 N(0, 1), D = 32) that their
    bf16 rounding shows; fp32 inputs are the same under either setting."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 2, 64, 32)).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    monkeypatch.setenv("SAM2_TPU_FAST_SOFTMAX", "0")
    want = np.asarray(jax_ops.scaled_dot_product_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    got = port_ops.scaled_dot_product_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= FAST_SOFTMAX_OFF_TOL * np.abs(want).max(), err
    fp32 = port_ops.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    monkeypatch.setenv("SAM2_TPU_FAST_SOFTMAX", "1")
    assert torch.equal(fp32, port_ops.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v))))


@pytest.mark.parametrize("flash", ["auto", "1"])
def test_fast_softmax_off_trunk_block_matches_jax(tiny128_params, tiny128_cfg, port_trunk,
                                                  monkeypatch, flash):
    """The first hiera_t block's attention (one head, 8 x 8 windows, C = 96)
    in bf16 under `SAM2_TPU_FAST_SOFTMAX=0` against the JAX package's on
    the same weights: under "auto" both run plain attention on the CPU,
    under "1" the split route's plain branch (`hiera.py:203-211`)."""
    spec = tiny128_cfg.trunk.block_plan()[0]
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                tiny128_params["image_encoder"]["trunk"]["blocks"][0]["attn"])
    x = np.random.default_rng(4).standard_normal((4, 8, 8, spec["dim"])).astype(np.float32) * 4
    monkeypatch.setenv("SAM2_TPU_FLASH", flash)
    monkeypatch.setenv("SAM2_TPU_FAST_SOFTMAX", "0")
    want = np.asarray(jax_hiera.multiscale_attention(jp, jnp.asarray(x, jnp.bfloat16),
                                                     spec["num_heads"]), np.float32)
    with torch.no_grad():
        got = port_trunk.blocks[0].attn(torch.from_numpy(x).bfloat16()).float().numpy()
    err = np.abs(got - want).max()
    assert err <= FAST_SOFTMAX_OFF_TOL * np.abs(want).max(), err


# --------------------------------------------------------------------------- #
# SAM2_TPU_FLASH: the same routes on both sides
# --------------------------------------------------------------------------- #

# trunk switches that put a hiera_t window on each of K5, K6 and K7 in bf16
TRUNK_ROUTES = {"SAM2_TPU_WINDOW_KERNEL": "1", "SAM2_TPU_FLASH_WINDOW_MIN": "64",
                "SAM2_TPU_PACKED_WINDOW": "16"}
SIDE, N_PTR = 32, 32  # 1024 queries over 1056 keys: the kernel gate q * kv >= 1024²


def _jax_route_counts(monkeypatch, tiny128_params, tiny128_cfg, mem):
    counts = dict.fromkeys(("K1", "K2", "K4", "K5", "K6", "K7"), 0)

    def flash(*a, **kw):
        counts["K2" if kw.get("rope_cos_k") is not None else "K1"] += 1
        return orig_flash(*a, **kw)

    orig_flash = jax_fa.flash_attention
    monkeypatch.setattr(jax_fa, "flash_attention", flash)
    monkeypatch.setattr(jax_fa, "flash_attention_kv_proj",
                        _counting(counts, "K4", jax_fa.flash_attention_kv_proj))
    monkeypatch.setattr(jax_wa, "window_attention", _counting(counts, "K5", jax_wa.window_attention))
    monkeypatch.setattr(jax_wa, "window_flash_3d", _counting(counts, "K6", jax_wa.window_flash_3d))
    monkeypatch.setattr(jax_wa, "packed_window_attention",
                        _counting(counts, "K7", jax_wa.packed_window_attention))
    trunk = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                   tiny128_params["image_encoder"]["trunk"])
    jax.eval_shape(lambda p, x: jax_hiera.hiera(p, x, tiny128_cfg.trunk), trunk,
                   jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.bfloat16))
    cfg = JaxMemoryAttentionConfig(rope_feat_sizes=(SIDE, SIDE))
    params, q_in, k_in, v_in, m = mem
    jp = {kind: {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in p.items()}
          for kind, p in params.items()}
    args = (jnp.asarray(q_in), jnp.asarray(k_in), jnp.asarray(v_in), jnp.asarray(m))
    jax.eval_shape(lambda q: jax_ma.rope_self_attention(jp["self"], cfg, q, q, q), args[0])
    jax.eval_shape(lambda q, k, v, m: jax_ma.rope_cross_attention(jp["cross"], cfg, q, k, v, m,
                                                                  SIDE * SIDE), *args)
    return counts


def _port_route_counts(monkeypatch, port_trunk, mem):
    counts = dict.fromkeys(("K1", "K2", "K4", "K5", "K6", "K7"), 0)
    for key, names in (("K1", ("flash_attention", "flash_attention_ref")),
                       ("K2", ("flash_attention_rope", "flash_attention_rope_ref")),
                       ("K4", ("flash_attention_kv_proj", "flash_attention_kv_proj_ref"))):
        for name in names:
            monkeypatch.setattr(port_ma, name, _counting(counts, key, getattr(port_ma, name)))
    monkeypatch.setattr(port_fa, "flash_attention", _counting(counts, "K1", port_fa.flash_attention))
    monkeypatch.setattr(port_wa, "window_attention", _counting(counts, "K5", port_wa.window_attention))
    monkeypatch.setattr(port_hiera, "window_flash_3d",
                        _counting(counts, "K6", port_hiera.window_flash_3d))
    monkeypatch.setattr(port_hiera, "packed_window_attention",
                        _counting(counts, "K7", port_hiera.packed_window_attention))
    img = np.random.default_rng(3).standard_normal((1, 3, 128, 128)).astype(np.float32)
    cfg = MemoryAttentionConfig(rope_feat_sizes=(SIDE, SIDE))
    params, q_in, k_in, v_in, m = mem
    attn = {}
    for kind, p in params.items():
        attn[kind] = port_ma.RoPEAttention(cfg.d_model, cfg.num_heads,
                                           kv_in_dim=p["k_proj"]["weight"].shape[0])
        with torch.no_grad():
            for name, d in p.items():
                getattr(attn[kind], name).weight.copy_(torch.from_numpy(d["weight"].T))
                getattr(attn[kind], name).bias.copy_(torch.from_numpy(d["bias"]))
    q, k, v, mask = (torch.from_numpy(a) for a in (q_in, k_in, v_in, m))
    with torch.no_grad():
        out = port_trunk(torch.from_numpy(img).bfloat16())
        assert all(bool(torch.isfinite(o.float()).all()) for o in out)
        port_ma._rope_attention(attn["self"], cfg, q, q, q, None, 1, 0)
        port_ma._rope_attention(attn["cross"], cfg, q, k, v, mask, 1, N_PTR, cross=True)
    return counts


@pytest.fixture(scope="module")
def memory_inputs():
    """Weights ([in, out], the JAX layout) of a self- and a cross-attention
    of memory attention, and fp32 inputs at 1024 queries over 1024 + 32
    keys."""
    cfg = MemoryAttentionConfig()
    rng = np.random.default_rng(23)

    def lin(i, o):
        return {"weight": (rng.standard_normal((i, o)) * 0.05).astype(np.float32),
                "bias": (rng.standard_normal(o) * 0.01).astype(np.float32)}

    dm, dkv, skv = cfg.d_model, cfg.kv_in_dim, SIDE * SIDE + N_PTR
    p = {kind: {"q_proj": lin(dm, dm), "k_proj": lin(d, dm), "v_proj": lin(d, dm),
                "out_proj": lin(dm, dm)} for kind, d in (("self", dm), ("cross", dkv))}
    m = rng.random((1, skv)) > 0.3
    m[:, :8] = True
    return (p, rng.standard_normal((1, SIDE * SIDE, dm)).astype(np.float32),
            rng.standard_normal((1, skv, dkv)).astype(np.float32),
            rng.standard_normal((1, skv, dkv)).astype(np.float32), m)


@pytest.mark.parametrize("memory_route", ["kv_proj", "rope_off"])
@pytest.mark.parametrize("flash", ["auto", "0", "1"])
def test_flash_switch_routes_match_jax(tiny128_params, tiny128_cfg, port_trunk, memory_inputs,
                                       monkeypatch, flash, memory_route):
    """Under `SAM2_TPU_FLASH` = flash, the trunk switches of TRUNK_ROUTES and
    memory attention's `SAM2_TPU_FUSED_KV_PROJ=1` (self K2, cross K4) or
    `SAM2_TPU_FUSED_ROPE=0` (both K1), the port calls K1, K2, K4 (kernel or
    plain version) and K5, K6, K7 as often as the JAX package calls its
    kernels: none under "auto" (off on the CPU in both) or "0"."""
    for name, value in TRUNK_ROUTES.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("SAM2_TPU_FLASH", flash)
    if memory_route == "kv_proj":
        monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")
    else:
        monkeypatch.setenv("SAM2_TPU_FUSED_ROPE", "0")
    with monkeypatch.context() as m:
        want = _jax_route_counts(m, tiny128_params, tiny128_cfg, memory_inputs)
    got = _port_route_counts(monkeypatch, port_trunk, memory_inputs)
    assert got == want, (got, want)
    memory = {"kv_proj": {"K1": 0, "K2": 1, "K4": 1}, "rope_off": {"K1": 2, "K2": 0, "K4": 0}}
    on = flash == "1"
    assert {k: got[k] for k in ("K1", "K2", "K4")} == {
        k: n * on for k, n in memory[memory_route].items()}
    trunk = [got[k] for k in ("K5", "K6", "K7")]
    assert all(trunk) if on else not any(trunk), trunk


def test_flash_switch_parsing_matches_jax(monkeypatch):
    """Unset, "auto", "0", "1" and an unknown value read as JAX reads them on
    its CPU backend (CPU tensors); CUDA tensors read "auto" as on."""
    cpu = torch.zeros(1)
    for value in (None, "auto", "0", "1", "yes"):
        if value is None:
            monkeypatch.delenv("SAM2_TPU_FLASH", raising=False)
        else:
            monkeypatch.setenv("SAM2_TPU_FLASH", value)
        assert port_ops.use_flash_attention(cpu) == jax_ops.use_flash_attention(), value
    for value in (None, "1", "0", "x"):
        if value is None:
            monkeypatch.delenv("SAM2_TPU_FAST_SOFTMAX", raising=False)
        else:
            monkeypatch.setenv("SAM2_TPU_FAST_SOFTMAX", value)
        assert port_ops.use_fast_softmax() == jax_ops.use_fast_softmax(), value

    class Cuda:
        is_cuda = True

    monkeypatch.setenv("SAM2_TPU_FLASH", "auto")
    assert port_ops.use_flash_attention(Cuda())
    monkeypatch.setenv("SAM2_TPU_FLASH", "0")
    assert not port_ops.use_flash_attention(Cuda())


# --------------------------------------------------------------------------- #
# the flash routes' backward; SAM2_TPU_KERNEL_FAST_EXP=1
# --------------------------------------------------------------------------- #


def _attn_inputs(dtype=torch.float32):
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 64)).astype(np.float32) * 0.3)
               .to(dtype).requires_grad_() for _ in range(3))
    mask = torch.from_numpy(np.arange(128) < 100)[None]
    return q, k, v, mask


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_flash_backward_matches_jax(monkeypatch, kernel):
    """The backward of K1 and of K2 (identity rotation) goes through K3's
    wrappers (on CPU tensors their plain versions) and gives JAX's
    gradients of plain masked attention within 1e-5 (fp32, sums in other
    orders)."""
    calls = {"K3a": 0, "K3b": 0}
    monkeypatch.setattr(port_fa, "flash_attention_bwd_dkdv",
                        _counting(calls, "K3a", port_fa.flash_attention_bwd_dkdv))
    monkeypatch.setattr(port_fa, "flash_attention_bwd_dq",
                        _counting(calls, "K3b", port_fa.flash_attention_bwd_dq))
    q, k, v, mask = _attn_inputs()
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(q.shape).astype(np.float32))
    if kernel == "K1":
        out = port_fa.flash_attention(q, k, v, mask)[0]
    else:
        tables = torch.ones(128, 32), torch.zeros(128, 32)  # identity rotation
        out = port_fa.flash_attention_rope(q, k, v, *tables, mask)[0]
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert calls == {"K3a": 1, "K3b": 1}, calls

    def loss(q, k, v):
        out = jax_ops.scaled_dot_product_attention(q, k, v, mask=jnp.asarray(mask)[:, None, None])
        return jnp.sum(out * jnp.asarray(dout.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-5)


def test_kernel_fast_exp_refused(monkeypatch):
    """`SAM2_TPU_KERNEL_FAST_EXP=1` changes the JAX flash kernels' numerics
    for bf16 inputs (not K4's); the port's routes refuse it for bf16 on K1
    (`flash_or_sdpa`) and memory attention's K2 and K1 routes, and take K4's
    and every fp32 route as they are. The kernel wrappers leave the decision
    to the routes."""
    monkeypatch.setenv("SAM2_TPU_KERNEL_FAST_EXP", "1")
    assert jax_fa._use_fast_exp(jnp.bfloat16) and not jax_fa._use_fast_exp(jnp.float32)
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    q, k, v, mask = _attn_inputs(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_ops.flash_or_sdpa(q, k, v, mask, min_seq=128)
    q32, k32, v32, _ = _attn_inputs()
    assert torch.isfinite(port_ops.flash_or_sdpa(q32, k32, v32, mask, min_seq=128)).all()
    assert torch.isfinite(port_fa.flash_attention(q, k, v, mask)[0].float()).all()
    cfg = MemoryAttentionConfig(rope_feat_sizes=(8, 8))
    attn = port_ma.RoPEAttention(cfg.d_model, cfg.num_heads).to(torch.bfloat16)
    cross = port_ma.RoPEAttention(cfg.d_model, cfg.num_heads,
                                  kv_in_dim=cfg.kv_in_dim).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, cfg.d_model, generator=gen).bfloat16()
    mem = torch.randn(1, 64, cfg.kv_in_dim, generator=gen).bfloat16()
    with torch.no_grad():
        monkeypatch.setenv("SAM2_TPU_FLASH", "0")  # plain attention: no flash route
        assert torch.isfinite(port_ma._rope_attention(attn, cfg, x, x, x, None, 1, 0).float()).all()
        monkeypatch.setenv("SAM2_TPU_FLASH", "1")
        for fused_rope in ("1", "0"):  # K2's route, then K1's
            monkeypatch.setenv("SAM2_TPU_FUSED_ROPE", fused_rope)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                port_ma._rope_attention(attn, cfg, x, x, x, None, 1, 0)
        monkeypatch.setenv("SAM2_TPU_FUSED_ROPE", "1")
        monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")  # K4's route
        out = port_ma._rope_attention(cross, cfg, x, mem, mem, None, 1, 0, cross=True)
        assert torch.isfinite(out.float()).all()
