"""The port's seams as `torch.export` programs
(`sam2_opt_tpu_torch/export/export_program.py`, the counterpart of
`sam2_opt_tpu/export/export_stablehlo.py`) and its kernels as registered
operators, on the CPU.

- every kernel wrapper's operator passes `torch.library.opcheck` at small
  shapes (its schema, the fake's shapes and strides against the
  implementation, its autograd registration, AOT dispatch): the CPU
  implementations here, the CUDA ones in the `gpu` copy;
- `export_all` at the tiny config (hiera_t, 128 px), fp32, under
  `SAM2_TPU_FLASH=1`, so CPU tensors take the kernel routes' operators
  (which run the plain versions): the four seams the JAX test names
  (`tests/test_init_structure.py`), the kernel nodes of each program: at
  this size no attention reaches the 1024² of queries times keys from
  which the card runs K1 and K2 (the trunk's global blocks have 64 tokens,
  memory attention 64 queries over at most 512 keys), so their programs
  hold the plain versions as the card's would at this size (`chip_smoke.py`
  phase 26 counts K1 and K2 at hiera-L), and under
  `SAM2_TPU_WINDOW_KERNEL=1` every windowed block's attention is a K5
  node, the switch read while the seam is traced; each
  loaded program equal to the port's eager seam within 1e-6 of its
  scale (the same operators in the same order); `set_image_e2e` and
  `track_step` equal to the JAX functions they export
  (`base.forward_image` + `no_mem_embed`, `vc.track_step_conditioned`)
  within 1e-4, the modules' tolerance (`tests/test_torch_video_modules.py`).

JAX is imported inside the JAX comparisons only, so the `gpu` tests run
where it is not installed:
`python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_export.py`.
"""

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.export import export_program as ex
from sam2_opt_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

# the JAX test's four names (tests/test_init_structure.py:73-75)
SEAMS = ["memory_encoder", "predict_masks", "set_image_e2e", "track_step"]
SEAM_TOL = 1e-6
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #


def _op_cases(device):
    """{operator: args} at small shapes every kernel takes on the card (K2
    at D = 64, K4 at D = 256 over a 64-wide memory), fp32 (K8 bf16 with
    fast_act on the card, the kernel's only form); the differentiable
    operators' float inputs require grad."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, grad=False, dtype=torch.float32):
        t = (torch.randn(*shape, generator=g) * 0.5).to(device, dtype)
        return t.requires_grad_(grad)

    B, H, Sq, Skv, D = 1, 2, 8, 12, 64
    mask = torch.ones(B, Skv, dtype=torch.bool, device=device)
    mask[:, -3:] = False
    cos, sin = torch.cos(r(Skv, D // 2)), torch.sin(r(Skv, D // 2))
    q, k, v = (r(B, H, S, D, grad=True) for S in (Sq, Skv, Skv))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    lse = fa.flash_attention_ref(qd, kd, vd, mask)[1]
    do, delta = r(B, H, Sq, D), r(B, H, Sq)
    c256, s256 = torch.cos(r(Skv, 128)), torch.sin(r(Skv, 128))
    proj = [r(B, Skv, 64, grad=True), r(B, Skv, 64, grad=True), r(256, 64, grad=True),
            r(256, grad=True), r(256, 64, grad=True), r(256, grad=True)]
    mk, mv, wk, bk, wv, bv = proj
    nshd = [r(3, 16, 2, 8, grad=True) for _ in range(3)]
    mlp_dtype = torch.bfloat16 if device == "cuda" else torch.float32
    mlp = [r(*s, grad=True, dtype=mlp_dtype) for s in ((5, 16), (32, 16), (32,), (16, 32), (16,))]
    # SAM ViT's attention over a 2 x 8 grid (bf16 on the card, its kernel's only form)
    relpos = [r(*s, dtype=mlp_dtype) for s in ((1, 2, 16, 64),) * 3 + ((3, 64), (15, 64))]
    return {
        "flash_attention": (q, k, v, mask),
        "flash_attention_rope": (q, k, v, cos, sin, mask),
        "rope_rotate": (kd, cos, sin),
        "flash_attention_kv_proj": (r(B, 1, Sq, 256, grad=True), mk, mv, wk, bk, wv, bv, c256,
                                    s256, mask),
        "kv_proj_rotate": tuple(t.detach() for t in (mk, wk, bk, mv, wv, bv)) + (c256, s256),
        "flash_attention_bwd_dkdv": (qd, kd, vd, do, lse, delta, mask),
        "flash_attention_bwd_dq": (qd, kd, vd, do, lse, delta, mask),
        "window_attention": tuple(r(6, 16, 8) for _ in range(3)),
        "window_flash_3d": tuple(nshd),
        "packed_window_attention": (nshd[0], r(3, 24, 2, 8, grad=True), r(3, 24, 2, 8, grad=True)),
        "window_attention_heads": tuple(t.detach() for t in nshd),
        "window_attention_3d": tuple(t.detach() for t in nshd),
        "fused_mlp": (*mlp, True),
        "add_layer_norm": (r(2, 5, 6, 16, dtype=torch.bfloat16), r(8, 4, 4, 16, dtype=torch.bfloat16),
                           r(16, dtype=torch.bfloat16), r(16, dtype=torch.bfloat16), 1e-6,
                           [4, 8, 8], [4, 8, 8]),
        "flash_attention_relpos": tuple(relpos),
    }


OPS = sorted(_op_cases("cpu"))


def test_every_kernel_wrapper_is_an_operator():
    """The 13 launch wrappers of K1-K10 (K2's rotation and K4's projection
    included), the trunk's `add_layer_norm` and SAM ViT's relative-position
    attention are operators of one namespace, each with its plain version on
    the CPU and its kernel on the card."""
    assert len(OPS) == 15
    for name in OPS:
        op = getattr(torch.ops.sam2_opt_tpu_torch, name).default
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CPU)
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CUDA)


@pytest.mark.parametrize("name", OPS)
def test_operator_opcheck_cpu(name):
    torch.library.opcheck(getattr(torch.ops.sam2_opt_tpu_torch, name).default,
                          _op_cases("cpu")[name])


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_operator_opcheck_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.library.opcheck(getattr(torch.ops.sam2_opt_tpu_torch, name).default,
                          _op_cases("cuda")[name])


# --------------------------------------------------------------------------- #
# the exported seams
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def flash():
    """SAM2_TPU_FLASH=1 and the default memory routes for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SAM2_TPU_FLASH", "1")
        for name in ("SAM2_TPU_WINDOW_KERNEL", "SAM2_TPU_FUSED_KV_PROJ", "SAM2_TPU_FUSED_ROPE",
                     "SAM2_TPU_PACKED_WINDOW", "SAM2_TPU_FUSED_MLP"):
            mp.delenv(name, raising=False)
        yield


@pytest.fixture(scope="module")
def model(tiny128_params):
    import jax

    from sam2_opt_tpu_torch.io.weights import state_dict_from_params
    from sam2_opt_tpu_torch.models.model import SAM2Model
    from sam2_opt_tpu_torch.models.sam2_base import SAM2Base

    cfg = model_config("hiera_t", image_size=128)
    module = SAM2Base(cfg)
    module.load_state_dict(
        state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params)), strict=True)
    return SAM2Model(module.eval(), cfg)


@pytest.fixture(scope="module")
def exported(flash, model, tmp_path_factory):
    paths = ex.export_all(model, str(tmp_path_factory.mktemp("exported")), dtype=torch.float32)
    return paths, {name: ex.load_exported(path) for name, path in paths.items()}


def _inputs(cfg, seed=3):
    """Numpy inputs of the four seams (NCHW), a memory of 7 slots (3 valid)
    and 16 pointers (10 valid) at batch 1."""
    rng = np.random.default_rng(seed)
    S, g, C = cfg.image_size, cfg.image_embedding_size, cfg.hidden_dim
    n = lambda *shape: (rng.standard_normal(shape) * 0.5).astype(np.float32)  # noqa: E731
    P = cfg.max_obj_ptrs_in_encoder
    feats = (n(1, C // 8, 4 * g, 4 * g), n(1, C // 4, 2 * g, 2 * g), n(1, C, g, g))
    mem = dict(feats=[n(1, cfg.mem_dim, g, g) for _ in range(cfg.num_maskmem)],
               tpos_idx=np.arange(cfg.num_maskmem)[None].astype(np.int32),
               valid=(np.arange(cfg.num_maskmem) < 3)[None],
               ptrs=[n(1, C) for _ in range(P)],
               ptr_pos=(np.arange(P) / P).astype(np.float32)[None],
               ptr_valid=(np.arange(P) < 10)[None])
    return dict(image=rng.random((1, 3, S, S)).astype(np.float32), feats=feats, mem=mem,
                high=n(1, 1, S, S) * 8, score=np.array([[2.0]], np.float32),
                coords=np.array([[[40.0, 60.0]]], np.float32), labels=np.array([[1]], np.int32))


def _torch_args(x):
    t = torch.from_numpy
    m = x["mem"]
    from sam2_opt_tpu_torch.models import video_core as vc

    mem = vc.MemoryInput(feats=tuple(t(f).bfloat16() for f in m["feats"]),
                         tpos_idx=t(m["tpos_idx"]).long(), valid=t(m["valid"]),
                         ptrs=tuple(t(p) for p in m["ptrs"]), ptr_pos=t(m["ptr_pos"]),
                         ptr_valid=t(m["ptr_valid"]))
    f0, f1, f2 = (t(f) for f in x["feats"])
    return {"set_image_e2e": (t(x["image"]),), "track_step": (f0, f1, f2, mem),
            "memory_encoder": (f2, t(x["high"]), t(x["score"])),
            "predict_masks": (f2, f0, f1, t(x["coords"]), t(x["labels"]))}


def test_export_all_writes_four_seams_with_their_kernel_nodes(exported, model, monkeypatch):
    paths, programs = exported
    assert sorted(paths) == SEAMS
    assert all(path.endswith(f"{name}.pt2") for name, path in paths.items())
    nodes = {name: ex.kernel_nodes(p) for name, p in programs.items()}
    assert nodes == dict.fromkeys(SEAMS, {})
    # the switches are read while a seam is traced and baked into its program
    cfg = model.cfg
    monkeypatch.setenv("SAM2_TPU_WINDOW_KERNEL", "1")
    program = ex.export_seam(ex.compute_module(model, torch.float32), cfg, "set_image_e2e",
                             ex.example_inputs(cfg, torch.float32, "cpu")["set_image_e2e"])
    windowed = sum(not b["q_pool"] for b in cfg.trunk.block_plan())
    assert windowed > 0 and ex.kernel_nodes(program) == {"window_attention": windowed}
    x = torch.from_numpy(_inputs(cfg)["image"])
    monkeypatch.delenv("SAM2_TPU_WINDOW_KERNEL")
    with torch.no_grad():
        for got, want in zip(program.module()(x), programs["set_image_e2e"].module()(x)):
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_set_image_program_holds_add_layer_norm_nodes(flash, model):
    """In bf16, `export_all`'s default, the traced seam runs without grad,
    so every Hiera block is two `add_layer_norm` nodes (its LayerNorms,
    residual add and window (un)partition); the program equals the eager
    seam."""
    cfg = model.cfg
    module = ex.compute_module(model, torch.bfloat16)
    x = torch.from_numpy(_inputs(cfg)["image"]).bfloat16()
    program = ex.export_seam(module, cfg, "set_image_e2e", (x,))
    assert ex.kernel_nodes(program) == {"add_layer_norm": 2 * len(cfg.trunk.block_plan())}
    with torch.no_grad():
        got = program.module()(x)
        want = ex.Seam(module, cfg, ex.set_image_e2e)(x)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_loaded_programs_equal_eager_seams(exported, model):
    _, programs = exported
    module = ex.compute_module(model, torch.float32)
    args = _torch_args(_inputs(model.cfg))
    for name in SEAMS:
        with torch.no_grad():
            got = programs[name].module()(*args[name])
            want = ex.Seam(module, model.cfg, getattr(ex, name))(*args[name])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            scale = max(1.0, float(b.float().abs().max()))
            assert float((a.float() - b.float()).abs().max()) <= SEAM_TOL * scale, name


def test_exported_seams_equal_jax(exported, model, tiny128_cfg, tiny128_params):
    import jax
    import jax.numpy as jnp

    from sam2_opt_tpu.models import sam2_base as jax_base
    from sam2_opt_tpu.models import video_core as jax_vc

    _, programs = exported
    cfg = tiny128_cfg
    x = _inputs(model.cfg)
    args = _torch_args(x)
    nhwc = lambda a: np.transpose(a, (0, 2, 3, 1))  # noqa: E731
    nchw = lambda a: np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))  # noqa: E731

    def set_image_e2e(p, img):
        f0, f1, f2 = jax_base.forward_image(p, cfg, jax_base.image_normalize(img))["backbone_fpn"]
        return f0, f1, f2 + p["no_mem_embed"][0, 0].astype(f2.dtype)

    want = jax.jit(set_image_e2e)(tiny128_params, jnp.asarray(nhwc(x["image"])))
    with torch.no_grad():
        got = programs["set_image_e2e"].module()(*args["set_image_e2e"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), nchw(b), **JAX_TOL)

    m = x["mem"]
    mem = jax_vc.MemoryInput(
        feats=tuple(jnp.asarray(nhwc(f), jnp.bfloat16) for f in m["feats"]),
        tpos_idx=m["tpos_idx"], valid=m["valid"], ptrs=tuple(jnp.asarray(p) for p in m["ptrs"]),
        ptr_pos=m["ptr_pos"], ptr_valid=m["ptr_valid"])

    def track_step(p, feats, mem):
        o = jax_vc.track_step_conditioned(p, cfg, feats, mem, multimask_output=True,
                                          run_mem_encoder=True, fill_hole_area=0)
        return o["pred_masks"], o["obj_ptr"], o["object_score_logits"], o["maskmem_features"]

    want = jax.jit(track_step)(tiny128_params, tuple(jnp.asarray(nhwc(f)) for f in x["feats"]),
                               mem)
    with torch.no_grad():
        got = programs["track_step"].module()(*args["track_step"])
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 3:  # the memory, stored in bf16 on both sides: one bf16 ulp
            np.testing.assert_allclose(a.float().numpy(), nchw(b), rtol=2 ** -7, atol=1e-3)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), **JAX_TOL)
