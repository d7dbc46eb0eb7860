"""PyTorch port vs JAX package: synthetic occlusion
(`poco_tpu_torch/data/occlusion.py` against `poco_tpu.data.occlusion`).

Every function on the same occluders and the same `RandomState`:

  * `resize_by_factor` (numpy, cv2's INTER_LINEAR up and INTER_AREA down)
    within 1 grey level of cv2's, at the same size;
  * `paste_over`, `erode` (cv2.erode) exact;
  * the three occluders' pastes exact, with the JAX module's
    `resize_by_factor` swapped for the port's (the one place cv2's fixed
    point enters), and every random draw the same (the generators end in
    the same state);
  * `load_coco_occluders` and `load_pascal_occluders` (a small VOC tree
    made here) exact;
  * `synthetic_occluders`: the patches' colours exact; the ellipse, a
    numpy mask of the pixels whose centres lie inside it, differs from
    cv2.ellipse's filled polygon only at the edge: 2717 of the 65269
    alpha pixels inside cv2's 32 ellipses of the default set, every one
    with both values among its 3x3 neighbours;
  * `PocoDataset` with occluders (keypoint-placed, random, COCO
    statistics): `get_batch` equal to JAX's native `get_batch` and to the
    port's per-item path, every key exact.
"""

import xml.etree.ElementTree as ET

import cv2
import joblib
import numpy as np
import pytest
import torch

from poco_tpu.data import occlusion as jax_occlusion
from poco_tpu.data.dataset import PocoDataset as JaxPocoDataset

from poco_tpu_torch.data import occlusion
from poco_tpu_torch.data.dataset import PocoDataset, collate

from .test_torch_data import DATA, SMOKE_NPZ, _assert_items_equal

ELLIPSE_EDGE_PIXELS = 2717  # of 65269 inside cv2's ellipses, synthetic_occluders()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see test_torch_data.py).
    Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def same_resize(monkeypatch):
    """The JAX module resizes with the port's numpy resize: what remains
    of each occlusion function is compared exactly."""
    monkeypatch.setattr(jax_occlusion, "resize_by_factor", occlusion.resize_by_factor)


def _occluders():
    return jax_occlusion.synthetic_occluders(n=12, seed=3)


def _crop_and_keypoints(seed):
    rng = np.random.RandomState(seed)
    crop = rng.uniform(0, 255, (224, 224, 3)).astype(np.float32)
    kp = np.concatenate([rng.uniform(-1, 1, (49, 2)), rng.uniform(0, 1, (49, 1))], 1)
    return crop, kp.astype(np.float32)


@pytest.mark.parametrize("factor", [0.05, 0.2, 0.5, 0.7123, 0.875, 1.0, 1.3, 2.0, 3.7, 9.5])
def test_resize_by_factor_within_one_grey_level_of_cv2(factor):
    rng = np.random.RandomState(int(factor * 100))
    for shape in ((16, 16, 4), (79, 40, 4), (33, 57, 3), (5, 9, 4)):
        im = cv2.GaussianBlur(rng.randint(0, 256, shape, dtype=np.uint8), (5, 5), 1)
        got, ref = occlusion.resize_by_factor(im, factor), jax_occlusion.resize_by_factor(im, factor)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, (shape, factor)


def test_paste_over_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (30, 21, 4), dtype=np.uint8)
    for center in ((0, 0), (10.4, 5.6), (223, 223), (112, 112), (-20, 300), (230, -3)):
        got = rng.uniform(0, 255, (224, 224, 3)).astype(np.float32)
        ref = got.copy()
        occlusion.paste_over(src, got, center)
        jax_occlusion.paste_over(src, ref, center)
        np.testing.assert_array_equal(got, ref)


def test_erode_matches_cv2():
    rng = np.random.RandomState(1)
    for shape in ((40, 50), (7, 5), (64, 64)):
        mask = (rng.rand(*shape) > 0.3).astype(np.uint8) * 255
        mask[1:-1, 2:-2] = 255
        np.testing.assert_array_equal(occlusion.erode(mask),
                                      cv2.erode(mask, np.ones((8, 8), np.uint8)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occlude_with_objects_kp_matches_jax(same_resize, seed):
    crop, kp = _crop_and_keypoints(seed)
    rng, ref_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    got = occlusion.occlude_with_objects_kp(crop, kp, 1.3, _occluders(), rng)
    ref = jax_occlusion.occlude_with_objects_kp(crop, kp, 1.3, _occluders(), ref_rng)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, crop)
    assert rng.randint(1 << 30) == ref_rng.randint(1 << 30)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occlude_with_objects_matches_jax(same_resize, seed):
    crop, _ = _crop_and_keypoints(seed)
    rng, ref_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    got = occlusion.occlude_with_objects(crop, _occluders(), rng)
    np.testing.assert_array_equal(got, jax_occlusion.occlude_with_objects(crop, _occluders(),
                                                                          ref_rng))
    assert rng.randint(1 << 30) == ref_rng.randint(1 << 30)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_occlude_with_coco_objects_matches_jax(same_resize, seed):
    crop, kp = _crop_and_keypoints(seed)
    occ = jax_occlusion.synthetic_coco_occluders(n=8, seed=seed)
    rng, ref_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    got = occlusion.occlude_with_coco_objects(crop, kp, occ, rng)
    np.testing.assert_array_equal(got, jax_occlusion.occlude_with_coco_objects(crop, kp, occ,
                                                                               ref_rng))
    assert rng.randint(1 << 30) == ref_rng.randint(1 << 30)


def test_load_coco_occluders_matches_jax(tmp_path):
    occ = jax_occlusion.synthetic_coco_occluders(n=6, seed=4)
    del occ["joint_occ_freq"]
    occ["stats"].pop("rankle")
    occ["stats"]["not_a_joint"] = [("class_1", 64, 2.0)]
    path = tmp_path / "coco.pkl"
    joblib.dump(occ, path)
    got, ref = occlusion.load_coco_occluders(str(path)), jax_occlusion.load_coco_occluders(str(path))
    np.testing.assert_array_equal(got["joint_occ_freq"], ref["joint_occ_freq"])
    assert got["joint_occ_freq"][0] == 0.0
    joblib.dump({**occ, "stats": {"elsewhere": [("class_0", 64, 2.0)]}}, path)
    np.testing.assert_array_equal(occlusion.load_coco_occluders(str(path))["joint_occ_freq"],
                                  np.full(24, 1 / 24))


def test_synthetic_coco_occluders_match_jax_but_the_ellipse_edge():
    got, ref = occlusion.synthetic_coco_occluders(), jax_occlusion.synthetic_coco_occluders()
    assert got["stats"] == ref["stats"]
    np.testing.assert_array_equal(got["obj_class"], ref["obj_class"])
    np.testing.assert_array_equal(got["joint_occ_freq"], ref["joint_occ_freq"])
    for a, b in zip(got["object_with_mask"], ref["object_with_mask"]):
        np.testing.assert_array_equal(a[..., :3], b[..., :3])


def test_synthetic_occluders_match_jax_but_the_ellipse_edge():
    got, ref = occlusion.synthetic_occluders(), jax_occlusion.synthetic_occluders()
    assert len(got) == len(ref) == 32
    differ = inside = 0
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a[..., :3], b[..., :3])
        diff = a[..., 3] != b[..., 3]
        # an edge pixel has 0 and 255 among its 3x3 neighbours in cv2's mask
        # (outside the patch counts as 0)
        padded = np.pad(b[..., 3], 1)
        windows = np.lib.stride_tricks.sliding_window_view(padded, (3, 3))
        edge = (windows.min(axis=(2, 3)) == 0) & (windows.max(axis=(2, 3)) == 255)
        assert not (diff & ~edge).any()
        differ += int(diff.sum())
        inside += int((b[..., 3] > 0).sum())
    assert (differ, inside) == (ELLIPSE_EDGE_PIXELS, 65269)


def _voc_tree(root, rng):
    """A two-image VOC2012 layout: grey object-index PNGs, JPEG images,
    annotations with a person, a difficult object and a thin one."""
    for sub in ("Annotations", "SegmentationObject", "JPEGImages"):
        (root / sub).mkdir()
    for stem, segmented in (("a", "1"), ("b", "1"), ("c", "0")):
        img = cv2.GaussianBlur(rng.randint(0, 256, (60, 80, 3), dtype=np.uint8), (5, 5), 1)
        cv2.imwrite(str(root / "JPEGImages" / f"{stem}.jpg"), img)
        seg = np.zeros((60, 80), np.uint8)
        seg[5:40, 5:45] = 1    # object 0: a car
        seg[10:50, 50:75] = 2  # object 1: a person
        seg[45:58, 2:70] = 3   # object 2: difficult
        seg[2:4, 50:79] = 4    # object 3: thin, its box all object
        seg[20:55, 30:60][rng.rand(35, 30) > 0.5] = 5  # object 4: noisy
        cv2.imwrite(str(root / "SegmentationObject" / f"{stem}.png"), seg)
        ann = ET.Element("annotation")
        ET.SubElement(ann, "segmented").text = segmented
        boxes = [("car", 0, (5, 5, 45, 40)), ("person", 0, (50, 10, 75, 50)),
                 ("dog", 1, (2, 45, 70, 58)), ("bottle", 0, (50, 2, 79, 4)),
                 ("cat", 0, (30, 20, 60, 55))]
        for name, difficult, (x0, y0, x1, y1) in boxes:
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = str(difficult)
            bb = ET.SubElement(obj, "bndbox")
            for tag, v in zip(("xmin", "ymin", "xmax", "ymax"), (x0, y0, x1, y1)):
                ET.SubElement(bb, tag).text = str(v)
        ET.ElementTree(ann).write(root / "Annotations" / f"{stem}.xml")


def test_load_pascal_occluders_matches_jax(tmp_path):
    _voc_tree(tmp_path, np.random.RandomState(5))
    got = occlusion.load_pascal_occluders(str(tmp_path))
    ref = jax_occlusion.load_pascal_occluders(str(tmp_path))
    # the car and the bottle of a and b (the bottle's box is all object, so
    # the erosion, which ignores what lies outside the box, keeps it); c is
    # not segmented, the person and the difficult dog are skipped, the
    # noisy cat erodes away
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["pascal", "pascal_random", "coco"])
def test_dataset_occlusion_matches_jax(monkeypatch, same_resize, kind):
    """Training items with synthetic occlusion: the port's `get_batch`
    against JAX's native `get_batch` and the port's per-item path, every
    key exact (the occlusion draws come from `occ_rng`, after the
    augmentation of the whole batch)."""
    monkeypatch.setenv("POCO_TPU_NATIVE_LOADER", "1")
    occluders = (jax_occlusion.synthetic_coco_occluders(n=8, seed=2) if kind == "coco"
                 else _occluders())
    kwargs = {"img_dir": str(DATA), "is_train": True, "seed": 9, "occluders": occluders,
              "options": {"USE_SYNTHETIC_OCCLUSION": True, "OCC_AUG_DATASET": kind}}
    rows = list(range(8))
    batch = PocoDataset(str(SMOKE_NPZ), **kwargs).get_batch(rows)
    ref = JaxPocoDataset(str(SMOKE_NPZ), **kwargs).get_batch(rows)
    per_item = PocoDataset(str(SMOKE_NPZ), **kwargs)
    items = collate([per_item[i] for i in rows])
    _assert_items_equal(batch, ref)
    _assert_items_equal(batch, items)
    plain = PocoDataset(str(SMOKE_NPZ), **{**kwargs, "occluders": None}).get_batch(rows)
    assert not np.array_equal(batch["img"], plain["img"])
