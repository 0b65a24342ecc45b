"""The port's data and tensor parallelism on the CPU: gloo ranks launched
from the test (`tests/_torch_parallel_worker.py`), held against one process
on the same global batch.

- the TP rule shards exactly the parameters the JAX package's
  `param_shardings` shards, on the `tiny128`, hiera-b+ and hiera-L params
  (their shapes from `jax.eval_shape`: nothing allocated), at tp 2 and 4;
- training steps under dp 2, dp 1 x tp 2 and dp 2 x tp 2 (4 ranks), point
  prompts and a correction click drawn from the per-row generators: the loss
  within 1e-5 relative and every reduced gradient within 1e-3 of the
  largest |g| of one process; the global norm a TP rank computes within 1e-5;
- `comms_dtype="bfloat16"` against plain bf16 DP at the JAX test's
  tolerance (loss 1e-3; gradients 5% + 2% of the leaf's max + 1e-4 of the
  global max), and its errors for tp != 1 and grad_accum_steps > 1;
- `train.py --dp 2` under two ranks: each loads its row of the global batch
  one process builds, rank 0 alone writes the checkpoints, and both ranks
  resume to the trained parameters, bit for bit; its step loss and its val
  loss over 3 videos (a ragged last global batch) within 1e-5 of
  `train.py` in one process, whose val loss does not depend on the val
  batch size;
- `SAM2ImagePredictor(mesh=)` at dp 2 and tp 2 and `SAM2VideoPredictor(mesh=)`
  at dp 2 (one object per rank and step): logits within 1e-4 of their scale
  of one process, on every rank;
- a tp 2 model runs its "cuda" backends eagerly, and under
  `SAM2_TPU_FUSED_MLP=1` its bf16 encoder refuses K8.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_worker as w

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3  # of the largest |g|
LOGIT_TOL = 1e-4  # of the logits' scale
TWO_RANK_JOBS = ["dp2", "tp2", "comms_none", "comms_bf16", "comms_raises", "cli", "image_dp2",
                 "image_tp2", "video_dp2", "k8_tp2"]


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    w.make_png_dataset(root)
    return root


@pytest.fixture(scope="module")
def ranks(png_root):
    """{job: [result of each rank]} of the 2-rank jobs, then the 4-rank one."""
    out = w.launch(2, TWO_RANK_JOBS, png_root)
    out.update(w.launch(4, ["dp2tp2"], f"{png_root}/four"))
    return out


@pytest.fixture(scope="module")
def cli_one_process(png_root):
    return w.cli_one_process(png_root)


@pytest.fixture(scope="module")
def one_process():
    """The one-process references of the training layouts."""
    return {"dp2": w.train_grads(None), "tp2": w.train_grads(None, B=1)}


# ------------------------------------------------------------------ #
# the TP rule
# ------------------------------------------------------------------ #


def jax_sharded(params, tp):
    """{dotted name} of the leaves the JAX package's rule shards at `tp`."""
    import jax
    from jax.sharding import PartitionSpec as P

    from sam2_opt_tpu.parallel import mesh as jax_mesh

    mesh = jax_mesh.make_mesh(dp=8 // tp, tp=tp)
    specs = jax_mesh.param_shardings(mesh, params)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    return {".".join(str(k.key) for k in path) for path, sh in flat if sh.spec != P()}, {
        ".".join(str(k.key) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def port_sharded(shapes, tp):
    from sam2_opt_tpu_torch.io.weights import is_transposed_linear
    from sam2_opt_tpu_torch.parallel.mesh import tp_spec_for_param

    out = set()
    for name, shape in shapes.items():
        torch_shape = shape[::-1] if is_transposed_linear(name, len(shape)) else shape
        if tp_spec_for_param(name, torch_shape, tp) is not None:
            out.add(name)
    return out


def param_shapes(cfg):
    """The JAX params tree of `cfg` as shapes (`jax.eval_shape`: nothing
    allocated)."""
    import jax

    from sam2_opt_tpu.models.init import init_params

    return jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_rule_matches_jax_on_tiny128(tiny128_cfg, tp):
    want, shapes = jax_sharded(param_shapes(tiny128_cfg), tp)
    assert want and port_sharded(shapes, tp) == want
    # every selected tensor is a parameter of the port's module, sharded on
    # its output rows by `shard_module`'s selection
    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.models.sam2_base import SAM2Base

    names = {n for n, _ in SAM2Base(model_config("hiera_t", image_size=128)).named_parameters()}
    assert want <= names


@pytest.mark.parametrize("variant", ["hiera_b+", "hiera_l"])
def test_tp_rule_matches_jax_at_full_size(variant):
    from sam2_opt_tpu.config import model_config

    shapes = param_shapes(model_config(variant))
    for tp in (2, 4):
        want, named = jax_sharded(shapes, tp)
        got = port_sharded(named, tp)
        assert len(want) > 10 and got == want, (variant, tp, sorted(got ^ want)[:5])


# ------------------------------------------------------------------ #
# training layouts
# ------------------------------------------------------------------ #


def assert_step_matches(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    gmax = max(g.abs().max().item() for g in want["grads"].values())
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in want["grads"].items():
        err = (got["grads"][name] - g).abs().max().item()
        assert err <= GRAD_TOL * gmax, (name, err, gmax)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-5)


@pytest.mark.parametrize("layout,ref", [("dp2", "dp2"), ("tp2", "tp2"), ("dp2tp2", "dp2")])
def test_layout_matches_one_process(ranks, one_process, layout, ref):
    for got in ranks[layout]:
        assert_step_matches(got, one_process[ref])


def test_clicks_follow_global_rows(one_process):
    """The per-row generators key the clicks by global row: the two videos
    of the batch draw differently, so a rank running row 1 alone must use
    row 1's generator to give one process's step. The val stream draws
    apart from the training stream at the same step and row."""
    from sam2_opt_tpu_torch.training.trainer import VAL_STREAM, row_generators

    draw = lambda g: torch.rand(4, generator=g)  # noqa: E731
    g0, g1 = row_generators(0, 0, [0, 1], "cpu")
    assert not torch.equal(draw(g0), draw(g1))
    again = row_generators(0, 0, [1], "cpu")[0]
    assert torch.equal(draw(again), draw(row_generators(0, 0, [0, 1], "cpu")[1]))
    val = row_generators(0, 0, [1], "cpu", stream=VAL_STREAM)[0]
    assert not torch.equal(draw(val), draw(row_generators(0, 0, [1], "cpu")[0]))


def test_bf16_comms_matches_plain_bf16(ranks):
    for plain, comms in zip(ranks["comms_none"], ranks["comms_bf16"]):
        assert abs(comms["loss"] - plain["loss"]) / max(abs(plain["loss"]), 1e-6) < 1e-3
        gmax = max(g.abs().max().item() for g in plain["grads"].values())
        for name, a in plain["grads"].items():
            np.testing.assert_allclose(comms["grads"][name].numpy(), a.numpy(), rtol=0.05,
                                       atol=0.02 * a.abs().max().item() + 1e-4 * gmax,
                                       err_msg=name)


def test_bf16_comms_raises_where_jax_raises(ranks):
    for got in ranks["comms_raises"]:
        assert "data-parallel mesh" in got["tp"]
        assert "grad_accum_steps" in got["accum"]


# ------------------------------------------------------------------ #
# the CLI under two ranks
# ------------------------------------------------------------------ #


def test_cli_two_ranks_checkpoint_and_resume(ranks, png_root):
    r0, r1 = ranks["cli"]
    # each rank loads its row of the global batch one process builds
    (row0, row1), = w.cli_global_batches(png_root)
    (train0, *val0), (train1, *val1) = r0["loaded"], r1["loaded"]
    assert train0 == [row0] and train1 == [row1] and row0 != row1
    # then the val loop: 3 videos in global batches of 2, the ragged last one
    # padded on rank 1 with a copy of video 2
    assert len(val0) == len(val1) == 2 and val1[1] == val0[1]
    assert len({val0[0][0], val1[0][0], val0[1][0]}) == 3
    assert r0["writes"] and not r1["writes"], "rank 0 alone writes the checkpoints"
    assert r0["losses"] == r1["losses"] and np.isfinite(r0["losses"]).all()
    for got in (r0, r1):
        assert got["resumed"] and got["steps"] == 1
        for name, p in got["params"].items():
            assert torch.equal(got["restored"][name], p), name
            assert torch.equal(p, r0["params"][name]), name


def test_cli_val_loop_one_process(cli_one_process):
    """`train.py` with a val folder runs the val loop after the epoch; the
    val loss is the mean over the videos whatever the val batch size (each
    video draws from its own index's generator)."""
    got = cli_one_process
    assert len(got["losses"]) == 1 and np.isfinite(got["val_loss"])
    np.testing.assert_allclose(got["val_loss_batch2"], got["val_loss"], rtol=LOSS_RTOL)


def test_cli_val_loop_two_ranks_matches_one_process(ranks, cli_one_process):
    """Under --dp 2 the 3 val videos make a global batch of 2 and a ragged
    one of 1 (its padding row counts for nothing): every rank's step and
    val losses are one process's within 1e-5."""
    want = cli_one_process
    for got in ranks["cli"]:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=LOSS_RTOL)


# ------------------------------------------------------------------ #
# the predictors
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("job", ["image_dp2", "image_tp2"])
def test_image_predictor_mesh_matches_one_process(ranks, job):
    want = w.image_predictor(None)
    for got in ranks[job]:
        assert len(got["low"]) == len(want["low"]) == 2
        for key in ("low", "ious"):
            for a, b in zip(got[key], want[key]):
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()
        scale = want["embed"].abs().max().item()
        assert (got["embed"] - want["embed"]).abs().max().item() <= LOGIT_TOL * scale


def test_video_predictor_mesh_matches_one_process(ranks):
    want = w.video_predictor(None)
    assert set(want["objects_per_step"]) == {2}, "one process tracks both objects as a batch"
    for got in ranks["video_dp2"]:
        assert set(got["objects_per_step"]) == {1}, "each rank tracks its own object"
        assert len(got["frames"]) == len(want["frames"]) == 4
        for a, b in zip(got["frames"], want["frames"]):
            assert a.shape == b.shape == (2, 1, w.S, w.S)
            assert (a - b).abs().max().item() <= LOGIT_TOL * b.abs().max().item()


def test_fused_mlp_refused_under_tp(ranks):
    """A sharded model's "cuda" backends run eagerly (a graph cannot capture
    its collectives), and K8, which takes whole weights, refuses its
    sharded block MLPs."""
    for got in ranks["k8_tp2"]:
        assert got["use_graphs"] == [True, False, False]
        assert got["refused"] and "tensor-parallel shards" in got["refused"]
