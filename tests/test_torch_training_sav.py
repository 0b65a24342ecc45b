"""The port's SA-V training readers and the trainer's residue against the
JAX package's, on the CPU:

- the COCO RLE codec: the round trip, and the JAX package's encodings and
  decodings byte for byte;
- each segment loader (palettised PNG, per-object PNG, JSON/RLE with
  `get_valid_obj_frames_ids`): the same object ids and masks;
- `SAVRawDataset` (per-object PNG tree and JSON manifest) through the
  port's `VOSDataset` and `data_loader`, and `TorchTrainMixedDataset` over
  two DAVIS-layout datasets: batches byte-identical to JAX's for the same
  seed and epoch, as `tests/test_training.py` builds them;
- `get_next_point`: the same points and labels for the same masks and seed;
- `names_matching`, `filter_params` and `assert_frozen_unchanged` over the
  port's state_dict and parameters: the same name sets as JAX's on the
  `tiny128` params.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu.training import checkpoints as jax_ckpt
from sam2_opt_tpu.training import data as jax_data
from sam2_opt_tpu.training.sam2_train import get_next_point as jax_get_next_point
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.training import checkpoints as ckpt
from sam2_opt_tpu_torch.training import data
from sam2_opt_tpu_torch.training.sam2_train import get_next_point
from test_training import _make_davis_dataset


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
                assert g[key].tobytes() == w[key].tobytes(), key
            else:
                assert g[key] == w[key], key


def test_coco_rle_codec_matches_jax():
    rng = np.random.default_rng(0)
    masks = [rng.random(shape) > p for shape, p in
             (((7, 5), 0.6), ((64, 48), 0.6), ((33, 33), 0.2), ((300, 200), 0.97))]
    masks += [np.zeros((4, 4), bool), np.ones((4, 4), bool)]
    for mask in masks:
        rle = data.encode_coco_rle(mask)
        assert rle == jax_data.encode_coco_rle(mask)
        assert isinstance(rle["counts"], str)
        out = data.decode_coco_rle(rle)
        assert out.shape == mask.shape and out.dtype == bool and (out == mask).all()
        assert out.tobytes() == jax_data.decode_coco_rle(rle).tobytes()
        counts = data._leb_decode_counts(rle["counts"])
        assert counts == jax_data._leb_decode_counts(rle["counts"].encode("ascii"))
        assert data._leb_encode_counts(counts) == rle["counts"]
    # uncompressed list counts (column-major, background first)
    m = data.decode_coco_rle({"size": [2, 2], "counts": [1, 2, 1]})
    assert (m == np.array([[False, True], [True, False]])).all()


def _obj_mask(obj, t, size=48):
    m = np.zeros((size, size), bool)
    m[8 * (obj + 1):8 * (obj + 2) + t, 4:40] = True
    return m


def _make_sav_tree(root, videos=("sav_000001",), num_frames=8, size=48, json_manifest=False):
    """A synthetic SA-V tree: 24 fps JPEGs and 6 fps annotations (every 4th
    frame) of two objects, as per-object PNG directories or a JSON/RLE
    manifest (`tests/test_training.py::_make_sav_tree` for several videos)."""
    rng = np.random.default_rng(1)
    for name in videos:
        vdir = root / "JPEGImages_24fps" / name
        os.makedirs(vdir)
        for t in range(num_frames):
            img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(vdir / f"{t:05d}.jpg")
        ann_frames = [t for t in range(num_frames) if t % 4 == 0]
        if json_manifest:
            masklet = [[jax_data.encode_coco_rle(_obj_mask(o, t, size)) for o in range(2)]
                       for t in ann_frames]
            masklet[-1][1] = None  # the second object leaves before the end
            with open(root / f"{name}.json", "w") as f:
                json.dump({"masklet": masklet, "fps": 6}, f)
        else:
            for o in range(2):
                for t in ann_frames[:len(ann_frames) - o]:
                    d = root / "Annotations_6fps" / name / f"{o:03d}"
                    os.makedirs(d, exist_ok=True)
                    Image.fromarray(_obj_mask(o, t, size).astype(np.uint8) * 255).save(
                        d / f"{t:05d}.png")
    return str(root)


def _same_segments(got, want):
    assert sorted(got) == sorted(want)
    for oid in want:
        assert got[oid].dtype == want[oid].dtype and got[oid].tobytes() == want[oid].tobytes()


def test_segment_loaders_match_jax(tmp_path):
    # palettised PNG: one PNG per frame, pixel value = object id
    pal = tmp_path / "pal"
    os.makedirs(pal)
    for t in range(2):
        arr = np.zeros((20, 24), np.uint8)
        arr[2:8, 3 + t:9 + t] = 1
        arr[10:18, 12:20] = 3
        img = Image.fromarray(arr, mode="P")
        img.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255] + [0] * 756)
        img.save(pal / f"{t:05d}.png")
    got, want = data.PalettisedPNGSegmentLoader(str(pal)), jax_data.PalettisedPNGSegmentLoader(str(pal))
    for t in range(2):
        _same_segments(got.load(t), want.load(t))
    assert sorted(got.load(0)) == [1, 3]

    png_root = _make_sav_tree(tmp_path / "png")
    got = data.MultiplePNGSegmentLoader(f"{png_root}/Annotations_6fps/sav_000001")
    want = jax_data.MultiplePNGSegmentLoader(f"{png_root}/Annotations_6fps/sav_000001")
    assert (got.H, got.W) == (want.H, want.W) == (48, 48)
    for t in (0, 4):
        _same_segments(got.load(t), want.load(t))
    assert not got.load(4)[2].any()  # object 1 has no PNG at frame 4: an empty mask

    json_root = _make_sav_tree(tmp_path / "json", json_manifest=True)
    path = f"{json_root}/sav_000001.json"
    got, want = data.JSONSegmentLoader(path), jax_data.JSONSegmentLoader(path)
    assert got.ann_every == want.ann_every == 4
    for t in (0, 4):
        _same_segments(got.load(t), want.load(t))
    _same_segments(got.load(0, obj_ids=[1, 5]), want.load(0, obj_ids=[1, 5]))
    assert got.get_valid_obj_frames_ids() == want.get_valid_obj_frames_ids() == {0: [0, 4],
                                                                                  1: [0]}
    assert got.get_valid_obj_frames_ids(2) == want.get_valid_obj_frames_ids(2) == {0: [0, 4]}
    with pytest.raises(ValueError, match="not annotated"):
        got.load(1)


@pytest.mark.parametrize("json_manifest", [False, True], ids=["png_tree", "json_manifest"])
def test_sav_batches_are_byte_identical_to_jax(tmp_path, json_manifest):
    root = _make_sav_tree(tmp_path, videos=("sav_000001", "sav_000002"), num_frames=16,
                          json_manifest=json_manifest)

    def batches(pkg, epoch):
        raw = pkg.SAVRawDataset(root)
        video = raw.get_video(1)
        assert len(raw) == 2 and video.frame_ids == [0, 4, 8, 12] and len(video.frames) == 4
        ds = pkg.VOSDataset(raw, pkg.RandomUniformSampler(num_frames=3), image_size=32,
                            max_num_objects=3, seed=7)
        ds.set_epoch(epoch)
        return list(pkg.data_loader(ds, batch_size=2, seed=3 + epoch, drop_last=False))

    for epoch in (0, 1):
        got, want = batches(data, epoch), batches(jax_data, epoch)
        _same_batches(got, want)
        assert got[0]["masks"].shape == (2, 3, 3, 32, 32) and got[0]["masks"].any()


def test_mixed_dataset_is_byte_identical_to_jax(tmp_path):
    img1, gt1 = _make_davis_dataset(tmp_path / "a", num_videos=4, size=32)
    img2, gt2 = _make_davis_dataset(tmp_path / "b", num_videos=2, size=48)

    def mix(pkg, **kwargs):
        ds1 = pkg.VOSDataset(pkg.PNGRawDataset(img1, gt1), pkg.RandomUniformSampler(2),
                             image_size=32, max_num_objects=1, seed=1)
        ds2 = pkg.VOSDataset(pkg.PNGRawDataset(img2, gt2), pkg.RandomUniformSampler(2),
                             image_size=48, max_num_objects=1, hflip_prob=0.0)
        return pkg.TorchTrainMixedDataset([ds1, ds2], **kwargs)

    got, want = mix(data, batch_sizes=[2, 1]), mix(jax_data, batch_sizes=[2, 1])
    assert got.dataset_prob == want.dataset_prob == [0.5, 0.5] and len(got) == 6
    for epoch in (0, 1):
        _same_batches(list(got.get_loader(epoch, seed=4)), list(want.get_loader(epoch, seed=4)))
    # phase chunking: each epoch covers half of each dataset, in the same order
    got = mix(data, batch_sizes=[1, 1], phases_per_epoch=2, drop_last=False,
              dataset_prob=[0.25, 0.75])
    want = mix(jax_data, batch_sizes=[1, 1], phases_per_epoch=2, drop_last=False,
               dataset_prob=[0.25, 0.75])
    for epoch in (0, 1, 2):
        g = list(got.get_loader(epoch))
        _same_batches(g, list(want.get_loader(epoch)))
        assert len(g) == 3
    with pytest.raises(ValueError, match="sum to 1"):
        mix(data, dataset_prob=[0.5, 0.6])


def test_get_next_point_matches_jax():
    rng = np.random.default_rng(4)
    B, H, W = 5, 24, 20
    gt = np.zeros((B, 1, H, W), bool)
    gt[:, 0, 4:14, 3:12] = True
    pred = gt.copy()
    pred[0, 0, 4:8] = False                        # misses part: positive clicks
    pred[1, 0, 16:20, 14:18] = True                # a false region: negative clicks
    pred[2] = rng.random((1, H, W)) > 0.5          # both
    gt[4] = False                                  # no ground truth, no error: label -1
    pred[4] = False
    for method in ("uniform", "center"):
        for seed in range(3):
            np.random.seed(seed)
            want = jax_get_next_point(gt, pred, method)
            got = get_next_point(gt, pred, method, rng=np.random.RandomState(seed))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
            np.random.seed(seed)
            got = get_next_point(gt, pred, method)  # numpy's global state, as JAX draws
            np.random.seed(seed)
            want = jax_get_next_point(gt, pred, method)
            assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    coords, labels = got
    assert labels[:, 0].tolist()[3:] == [1, -1]  # exact prediction: a positive on the target
    coords, labels = get_next_point(gt, None, rng=np.random.default_rng(0))
    assert (labels[:4] == 1).all() and labels[4, 0] == -1
    ys, xs = coords[:4, 0, 1].astype(int), coords[:4, 0, 0].astype(int)
    assert gt[np.arange(4), 0, ys, xs].all()


PATTERNS = [["image_encoder.*"], ["*.bias"], ["sam_mask_decoder.*", "*pos_embed*"],
            ["memory_attention.layers.0.*"], ["nothing.*"]]


@pytest.mark.parametrize("patterns", PATTERNS, ids=lambda p: ",".join(p))
def test_parameter_patterns_match_jax(tiny128_cfg, tiny128_params, patterns):
    sd = state_dict_from_params(tiny128_params)
    module = build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu").module
    want = jax_ckpt.names_matching(tiny128_params, patterns)
    assert sorted(ckpt.names_matching(module.state_dict(), patterns)) == sorted(want)
    # the module's parameters: the same names, less the buffers (the prompt
    # encoder's gaussian matrix is a parameter in the JAX tree)
    params = ckpt.names_matching(module, patterns)
    buffers = {n for n, _ in module.named_buffers()}
    assert sorted(params) == sorted(n for n in want if n not in buffers)
    got = ckpt.filter_params(module.state_dict(), include=["*"], exclude=patterns)
    jax_kept = jax_ckpt.filter_params(tiny128_params, include=["*"], exclude=patterns)
    assert sorted(got) == sorted(jax_kept)
    for n in list(got)[:5]:
        assert torch.equal(got[n], sd[n])


def test_assert_frozen_unchanged_matches_jax(tiny128_cfg, tiny128_params):
    sd = state_dict_from_params(tiny128_params)
    module = build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu").module
    frozen = ["image_encoder.*"]
    before = {n: v.detach().clone() for n, v in ckpt.filter_params(module, include=frozen).items()}
    ckpt.assert_frozen_unchanged(before, module, frozen)
    jax_before = {n: np.asarray(v) for n, v in
                  jax_ckpt.filter_params(tiny128_params, include=frozen).items()}
    jax_ckpt.assert_frozen_unchanged(jax_before, tiny128_params, frozen)
    # a decoder weight moves: nothing frozen changed, in both packages
    with torch.no_grad():
        module.sam_mask_decoder.iou_token.weight += 1.0
    ckpt.assert_frozen_unchanged(before, module, frozen)
    # an encoder weight moves: both raise, naming it
    name = "image_encoder.trunk.blocks.0.attn.qkv.weight"
    with torch.no_grad():
        module.get_parameter(name)[0, 0] += 1.0
    with pytest.raises(AssertionError, match=name.replace(".", r"\.")):
        ckpt.assert_frozen_unchanged(before, module, frozen)
    moved = jax.tree_util.tree_map(np.array, tiny128_params)
    moved["image_encoder"]["trunk"]["blocks"][0]["attn"]["qkv"]["weight"][0, 0] += 1.0
    with pytest.raises(AssertionError, match=name.replace(".", r"\.")):
        jax_ckpt.assert_frozen_unchanged(jax_before, moved, frozen)
    # numpy copies of the state_dict serve as `before` too
    host = {n: v.numpy() for n, v in ckpt.filter_params(module.state_dict(), frozen).items()}
    ckpt.assert_frozen_unchanged(host, module, frozen)
