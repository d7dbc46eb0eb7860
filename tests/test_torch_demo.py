"""PyTorch port vs JAX package: the demo (`poco_tpu_torch/demo/`,
`utils/{demo_utils,smooth_bbox,one_euro,smooth_pose,kp_utils}.py`,
`data/inference.py`, `viz/renderer.py`, `runtime/{raster,image_write}.py`,
`cli/demo.py`).

The same seeded numpy inputs go through both packages on the CPU; the
tolerances are stated beside each check:
  * tracking: `nms_cxcywh`, `IouTracker` and `run_tracking` give the same
    indices and tracklets exactly; `resize_area`'s weights are cv2's
    INTER_AREA weights (float images within 1e-5) and its uint8 output
    equals cv2's at a full-HD frame, an odd size and an exact halving;
  * smoothing: `one_euro_track` and `get_smooth_bbox_params` within 1e-6;
    `smooth_pose` on a 96-vertex synthetic SMPL within 1e-5 (vertices
    and joints, fp32 SMPL on both sides);
  * conversions and tables: `convert_crop_cam_to_orig_img`,
    `split_into_chunks`, `prepare_rendering_results`, `convert_kps`,
    `get_perm_idxs`, `get_smpl_skeleton`: exact;
  * data: `InferenceDataset.load_all` exact (the same native loader code
    on both sides) and `__getitem__` within 1 grey level of the JAX
    package's cv2 warp (`tests/test_torch_loader.py`'s crop bar);
  * rendering: the rasterizer exactly equal to the JAX package's on the
    JAX package's own uv, depths and colours; `Renderer.render` end to end
    with at most 0.1% of the frame more than 2 levels off; the vertex
    colours exact; OBJ text equal; PNGs decoded by cv2 exactly equal;
  * the tester, tiny-cliff on both sides (the JAX `_tiny_tester`
    configuration of tests/test_demo.py, weights carried to the port by
    `state_dict_from_jax`): head outputs within 2e-3, fp16-rounded
    vertices and joints within 1 fp16 ulp, cameras within 2e-3 relative,
    rendered frames at the bar above, the uncertainty log's values within
    1e-3; folder mode with sideview, render_crop and skip_frame, video
    mode with and without smoothing, the refine and uncert detectors;
  * the CLI: folder and video modes with `--device cpu`, and every
    refused flag's error names its ROADMAP.md item (the drawing flags and
    pose tracking run: tests/test_torch_drawing.py,
    tests/test_torch_pose_tracker.py).
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

import poco_tpu.data.inference as jax_inference
import poco_tpu.demo.tracker as jax_tracker
import poco_tpu.runtime.raster as jax_raster
import poco_tpu.utils.demo_utils as jax_demo_utils
import poco_tpu.utils.kp_utils as jax_kp_utils
import poco_tpu.viz.renderer as jax_renderer
from poco_tpu.config import get_hparams_defaults as jax_hparams_defaults
from poco_tpu.demo.tester import PocoTester as JaxTester
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu.utils.one_euro import one_euro_track as jax_one_euro_track
from poco_tpu.utils.smooth_bbox import get_smooth_bbox_params as jax_smooth_bbox
from poco_tpu.utils.smooth_pose import smooth_pose as jax_smooth_pose

from poco_tpu_torch.cli import demo as cli_demo
from poco_tpu_torch.config import get_hparams_defaults, model_config_from_hparams
from poco_tpu_torch.data.inference import InferenceDataset, images_in_folder
from poco_tpu_torch.demo import tracker
from poco_tpu_torch.demo.tester import PocoTester
from poco_tpu_torch.models.poco import POCO
from poco_tpu_torch.runtime import raster
from poco_tpu_torch.runtime.image_write import encode_png, write_image, write_png
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.utils import demo_utils, kp_utils
from poco_tpu_torch.utils.one_euro import one_euro_track
from poco_tpu_torch.utils.smooth_bbox import get_smooth_bbox_params
from poco_tpu_torch.utils.smooth_pose import smooth_pose
from poco_tpu_torch.utils.weights import state_dict_from_jax
from poco_tpu_torch.viz import renderer

REPO = Path(__file__).resolve().parents[1]
HEAD_TOL = 2e-3          # head outputs (tests/test_fullwidth_parity.py:50-57)
RENDER_LEVELS, RENDER_SHARE = 2, 1e-3   # >2 grey levels off on at most 0.1% of pixels
CROP_TOL = 1.0           # port crop vs the JAX package's cv2 warp (test_torch_loader.py)
FRAME_HW = (120, 160)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed: int, hw=(240, 320)) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return cv2.GaussianBlur(rng.randint(0, 255, (*hw, 3), dtype=np.uint8), (9, 9), 3)


@pytest.fixture(scope="module")
def frame_folder(tmp_path_factory) -> str:
    """Four same-size PNG frames cut from one scene by shifting crops, so
    that a tracker follows motion."""
    root = tmp_path_factory.mktemp("frames")
    scene = _scene(0)
    for i in range(4):
        y, x = 20 + 4 * i, 30 + 6 * i
        cv2.imwrite(str(root / f"{i:06d}.png"),
                    scene[y:y + FRAME_HW[0], x:x + FRAME_HW[1], ::-1])
    return str(root)


# --------------------------------------------------------------------------
# tracking
# --------------------------------------------------------------------------

def _random_boxes(rng, n, hw=(480, 640)):
    c = rng.rand(n, 2) * [hw[1], hw[0]]
    s = 40 + rng.rand(n, 2) * 200
    return np.concatenate([c, s], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jax(seed):
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(rng, 40)
    scores = rng.rand(40).astype(np.float32)
    for thr in (0.3, 0.45, 0.7):
        np.testing.assert_array_equal(tracker.nms_cxcywh(boxes, scores, thr),
                                      jax_tracker.nms_cxcywh(boxes, scores, thr))


def _seeded_detections(seed: int, frames: int = 30):
    """Three people walking, one leaving for a while, spurious boxes."""
    rng = np.random.RandomState(seed)
    starts = _random_boxes(rng, 3)
    dets = []
    for t in range(frames):
        boxes = starts + [3.0 * t, 1.5 * t, 0, 0] + rng.randn(3, 4) * 2
        if 10 <= t < 16:
            boxes = boxes[:2]
        if rng.rand() < 0.2:
            boxes = np.concatenate([boxes, _random_boxes(rng, 1)])
        dets.append(boxes[rng.permutation(len(boxes))].astype(np.float32))
    return dets


@pytest.mark.parametrize("seed,max_age", [(0, 10), (1, 3), (2, 20)])
def test_iou_tracker_matches_jax(seed, max_age):
    dets = _seeded_detections(seed)
    got = tracker.IouTracker(max_age=max_age).track(dets)
    ref = jax_tracker.IouTracker(max_age=max_age).track(dets)
    assert got.keys() == ref.keys()
    for tid in ref:
        np.testing.assert_array_equal(got[tid]["frames"], ref[tid]["frames"])
        np.testing.assert_array_equal(got[tid]["bbox"], ref[tid]["bbox"])


def test_run_tracking_matches_jax(frame_folder):
    files = images_in_folder(frame_folder)
    assert files == jax_inference.images_in_folder(frame_folder)
    got = tracker.run_tracking(files, tracker.full_frame_detector)
    ref = jax_tracker.run_tracking(files, jax_tracker.full_frame_detector)
    assert got.keys() == ref.keys() and len(got) == 1
    for tid in ref:
        np.testing.assert_array_equal(got[tid]["frames"], ref[tid]["frames"])
        np.testing.assert_array_equal(got[tid]["bbox"], ref[tid]["bbox"])


def test_proposals_match_jax():
    img = np.zeros((480, 640, 3), np.uint8)
    np.testing.assert_array_equal(tracker.tiled_window_proposals(img),
                                  jax_tracker.tiled_window_proposals(img))
    np.testing.assert_array_equal(tracker.full_frame_detector(img),
                                  jax_tracker.full_frame_detector(img))
    # the JAX package's HOG detector is the full frame on a cv2 without HOG
    np.testing.assert_array_equal(tracker.hog_person_detector(img),
                                  tracker.full_frame_detector(img))
    kp = np.random.RandomState(0).rand(49, 2) * 300
    np.testing.assert_array_equal(tracker.bbox_from_kp2d(kp), jax_tracker.bbox_from_kp2d(kp))


@pytest.mark.parametrize("src,dst", [((1080, 1920), (288, 512)), ((701, 333), (512, 243)),
                                     ((1024, 512), (512, 256))])
def test_resize_area_is_cv2_inter_area(src, dst):
    """The written-out weights against cv2 on float images (no rounding),
    then the uint8 resize against cv2's, exactly."""
    rng = np.random.RandomState(src[1])
    xf = rng.rand(*src, 3).astype(np.float32)
    wy, wx = tracker.area_weights(src[0], dst[0]), tracker.area_weights(src[1], dst[1])
    got = np.tensordot(wx, np.tensordot(wy, xf.astype(np.float64), axes=(1, 0)),
                       axes=(1, 1)).transpose(1, 0, 2)
    ref = cv2.resize(xf, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    xu = _scene(src[0], src)
    np.testing.assert_array_equal(
        tracker.resize_area(xu, *dst), cv2.resize(xu, (dst[1], dst[0]), interpolation=cv2.INTER_AREA))


def test_maskrcnn_is_refused(monkeypatch, tmp_path):
    """`make_maskrcnn_detector` is None, as the JAX package's is, where
    torchvision or its weights cannot be had: here torchvision is not
    installed (and is hidden where it is), and a weights file that is not
    there gives None too, with nothing downloaded."""
    monkeypatch.setitem(sys.modules, "torchvision", None)
    assert tracker.make_maskrcnn_detector() is None
    assert jax_tracker.make_maskrcnn_detector() is None
    monkeypatch.setenv("POCO_TPU_MASKRCNN_WEIGHTS", str(tmp_path / "absent.pth"))
    assert tracker.make_maskrcnn_detector() is None


# --------------------------------------------------------------------------
# smoothing, conversions, tables
# --------------------------------------------------------------------------

def test_one_euro_track_matches_jax():
    rng = np.random.RandomState(0)
    xs = np.cumsum(rng.randn(40, 24, 3, 3), axis=0).astype(np.float32)
    for kw in ({}, {"min_cutoff": 0.004, "beta": 0.7}, {"min_cutoff": 0.5, "d_cutoff": 2.0}):
        np.testing.assert_allclose(one_euro_track(xs, **kw), jax_one_euro_track(xs, **kw),
                                   atol=1e-6, rtol=0)


def test_smooth_bbox_matches_jax():
    rng = np.random.RandomState(1)
    kps = []
    for t in range(30):
        kp = np.concatenate([rng.rand(14, 2) * 100 + t, rng.rand(14, 1)], axis=1)
        kps.append(None if t in (0, 1, 7, 8, 9, 29) else kp)
    got = get_smooth_bbox_params(kps, vis_thresh=0.3)
    ref = jax_smooth_bbox(kps, vis_thresh=0.3)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0)
    assert got[1:] == ref[1:]


def test_smooth_pose_matches_jax():
    rng = np.random.RandomState(2)
    from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat

    aa = torch.from_numpy(np.cumsum(0.05 * rng.randn(12, 24, 3), axis=0).astype(np.float32))
    pose = axis_angle_to_rotmat(aa.reshape(-1, 3)).reshape(12, 24, 3, 3).numpy()
    betas = (0.5 * rng.randn(12, 10)).astype(np.float32)
    got = smooth_pose(pose, betas, synthetic_smpl_model(num_verts=96, device="cpu"))
    ref = jax_smooth_pose(pose, betas, jax_synthetic_smpl(num_verts=96))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=0)


def test_conversions_match_jax():
    rng = np.random.RandomState(3)
    cam = np.concatenate([0.5 + rng.rand(6, 1), rng.randn(6, 2) * 0.2], axis=1)
    bbox = np.concatenate([rng.rand(6, 2) * 500, 50 + rng.rand(6, 1) * 300], axis=1)
    np.testing.assert_array_equal(demo_utils.convert_crop_cam_to_orig_img(cam, bbox, 640, 480),
                                  jax_demo_utils.convert_crop_cam_to_orig_img(cam, bbox, 640, 480))
    kp = rng.uniform(-1, 1, (6, 49, 2))
    np.testing.assert_allclose(demo_utils.convert_crop_coords_to_orig_img(bbox, kp, 224),
                               jax_demo_utils.convert_crop_coords_to_orig_img(bbox, kp.copy(), 224),
                               atol=1e-9, rtol=0)
    for n, seqlen, stride in ((3, 5, 2), (17, 5, 3), (16, 8, 8), (0, 4, 1)):
        assert (demo_utils.split_into_chunks(range(n), seqlen, stride)
                == jax_demo_utils.split_into_chunks(range(n), seqlen, stride))


def test_prepare_rendering_results_matches_jax():
    rng = np.random.RandomState(4)
    results = {}
    for pid, frames in ((0, [0, 1, 2, 4]), (3, [1, 2, 3]), (7, [2])):
        n = len(frames)
        results[pid] = {"verts": rng.randn(n, 9, 3), "orig_cam": rng.rand(n, 4),
                        "frame_ids": np.asarray(frames), "smpl_joints2d": rng.rand(n, 49, 2),
                        "var": rng.rand(n, 24) if n > 1 else np.zeros(1),
                        "var_global": rng.rand(n) if n > 1 else np.zeros(1)}
    got = demo_utils.prepare_rendering_results(results, 5)
    ref = jax_demo_utils.prepare_rendering_results(results, 5)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for pid in r:
            for key, value in r[pid].items():
                if value is None:
                    assert g[pid][key] is None
                else:
                    np.testing.assert_array_equal(g[pid][key], value)


def test_kp_utils_match_jax():
    joints = np.random.RandomState(5).rand(2, 49, 3)
    for src, dst in (("spin", "coco"), ("spin", "common"), ("coco", "h36m"), ("smpl", "spin")):
        np.testing.assert_array_equal(kp_utils.convert_kps(joints[:, :len(kp_utils.get_joint_names(src))], src, dst),
                                      jax_kp_utils.convert_kps(joints[:, :len(jax_kp_utils.get_joint_names(src))], src, dst))
        assert kp_utils.get_perm_idxs(src, dst) == jax_kp_utils.get_perm_idxs(src, dst)
    np.testing.assert_array_equal(kp_utils.get_smpl_skeleton(), jax_kp_utils.get_smpl_skeleton())
    assert kp_utils.JOINT_NAME_REGISTRY == jax_kp_utils.JOINT_NAME_REGISTRY


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def _jpeg_folder(root: Path) -> str:
    """Frames of two sizes, as JPEG (the format every loader route reads)."""
    root.mkdir()
    for i, hw in enumerate(((120, 160), (120, 160), (150, 110))):
        cv2.imwrite(str(root / f"{i:06d}.jpg"), _scene(10 + i, hw), [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(root)


def test_inference_dataset_matches_jax(tmp_path):
    folder = _jpeg_folder(tmp_path / "jpg")
    frames = [0, 1, 2]
    bboxes = np.array([[80, 60, 90, 110], [70, 64, 60, 100], [55, 75, 80, 80]], np.float32)
    got = InferenceDataset(folder, frames=frames, bboxes=bboxes)
    ref = jax_inference.InferenceDataset(folder, frames=frames, bboxes=bboxes)
    batch, ref_batch = got.load_all(), ref.load_all()
    assert batch.keys() == ref_batch.keys()
    for k in ref_batch:
        np.testing.assert_array_equal(batch[k], ref_batch[k], err_msg=k)
    for i in range(len(ref)):
        item, ref_item = got[i], ref[i]
        assert item.keys() == ref_item.keys()
        np.testing.assert_allclose(item["img"], ref_item["img"], atol=CROP_TOL, rtol=0)
        for k in ref_item:
            if k != "img":
                np.testing.assert_array_equal(item[k], ref_item[k], err_msg=k)


def test_inference_dataset_from_keypoints_matches_jax(frame_folder):
    rng = np.random.RandomState(6)
    j2d = np.concatenate([40 + rng.rand(4, 14, 2) * 60, rng.rand(4, 14, 1)], axis=2)
    got = InferenceDataset(frame_folder, frames=[0, 1, 2, 3], joints2d=j2d)
    ref = jax_inference.InferenceDataset(frame_folder, frames=[0, 1, 2, 3], joints2d=j2d)
    np.testing.assert_array_equal(got.frames, ref.frames)
    np.testing.assert_allclose(got.bboxes, ref.bboxes, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# rendering and writing
# --------------------------------------------------------------------------

def _mesh(num_verts=300, seed=7):
    """A compact blob of triangles in front of a fixed in-frame camera."""
    rng = np.random.RandomState(seed)
    verts = (0.3 * rng.randn(num_verts, 3)).astype(np.float32)
    faces = np.stack([np.arange(num_verts), (np.arange(num_verts) + 1) % num_verts,
                      rng.randint(0, num_verts, num_verts)], axis=1).astype(np.int64)
    return verts, faces


def test_raster_matches_jax_given_its_inputs():
    verts, faces = _mesh()
    h, w = FRAME_HW
    rng = np.random.RandomState(8)
    uv = (verts[:, :2] * 60 + [w / 2, h / 2]).astype(np.float32)
    face_z = rng.randn(len(faces)).astype(np.float32)
    face_rgb = (rng.rand(len(faces), 3) * 255).astype(np.float32)
    onscreen = rng.rand(len(faces)) > 0.1
    bg = rng.rand(h, w, 3).astype(np.float32) * 255
    assert jax_raster.native_available()
    ref = jax_raster.raster_mesh(bg.copy(), uv, face_z, faces, face_rgb, onscreen)
    got = raster.raster_mesh(bg, uv, face_z, faces, face_rgb, onscreen)
    np.testing.assert_array_equal(got, ref)
    assert raster.library_path().parent.name == "_build"


@pytest.mark.parametrize("sideview", [False, True])
def test_render_matches_jax(sideview):
    verts, faces = _mesh()
    lbs = np.random.RandomState(9).rand(len(verts), 24)
    var = np.random.RandomState(10).rand(24).astype(np.float32)
    colors = renderer.get_vertex_colors(var.copy(), lbs, backbone="tiny-cliff")
    np.testing.assert_array_equal(
        colors, jax_renderer.get_vertex_colors(var.copy(), lbs, backbone="tiny-cliff"))
    img = _scene(11, FRAME_HW)
    cam = np.array([0.8, 1.0, 0.05, -0.1], np.float32)
    kw = dict(vertex_colors=colors, angle=270.0, axis=(0, 1, 0)) if sideview else {}
    got = renderer.Renderer(faces).render(img, verts, cam, **kw)
    ref = jax_renderer.Renderer(faces).render(img, verts, cam, **kw)
    assert (np.abs(ref.astype(int) - img).max(axis=2) > 10).mean() > 0.05   # the mesh shows
    off = np.abs(got.astype(int) - ref).max(axis=2) > RENDER_LEVELS
    assert off.mean() <= RENDER_SHARE


def test_renderer_refuses_cv2_drawing():
    """The renderer draws the wireframe and the caption (held to cv2 and
    the JAX package in tests/test_torch_drawing.py), and refuses nothing
    any more: the cv2 window is the tester's `_display_frame`, as in the
    JAX package (`test_tester_refuses_cv2_drawing`), and `renderer.refuse`
    is gone."""
    verts, faces = _mesh()
    frame = renderer.Renderer(faces).render(None, verts, np.ones(4), wireframe=True)
    assert frame.shape == (224, 224, 3) and frame.any()
    assert renderer.overlay_text(np.zeros((64, 64, 3), np.uint8), "Other View").any()
    assert not hasattr(renderer, "refuse") and not hasattr(jax_renderer, "refuse")


def test_colormap_and_part_ids_match_jax():
    x = np.linspace(-0.2, 1.2, 101)
    np.testing.assert_array_equal(renderer.jet_colormap(x), jax_renderer.jet_colormap(x))
    lbs = np.random.RandomState(12).rand(50, 24)
    np.testing.assert_array_equal(renderer.vertex_part_ids(lbs), jax_renderer.vertex_part_ids(lbs))


def test_save_obj_matches_jax(tmp_path):
    verts, faces = _mesh(20)
    renderer.save_obj(str(tmp_path / "port.obj"), verts, faces)
    jax_renderer.save_obj(str(tmp_path / "jax.obj"), verts, faces)
    assert (tmp_path / "port.obj").read_text() == (tmp_path / "jax.obj").read_text()


@pytest.mark.parametrize("shape", [(37, 53, 3), (1, 1, 3), (64, 31)])
def test_png_writer_decodes_exactly(tmp_path, shape):
    img = np.random.RandomState(13).randint(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    flag = cv2.IMREAD_UNCHANGED
    back = cv2.imread(path, flag)
    np.testing.assert_array_equal(back if img.ndim == 2 else back[:, :, ::-1], img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


# --------------------------------------------------------------------------
# the tester
# --------------------------------------------------------------------------

def _tiny_hparams(defaults):
    """tests/test_demo.py:_tiny_tester's configuration."""
    h = defaults()
    h.METHOD = "poco"
    h.POCO.BACKBONE = "tiny-cliff"
    h.POCO.NUM_NEURONS = "216-"
    h.POCO.SIGMA_DIM = 1
    h.POCO.UNCERT_INP_TYPE = "feat-pose-net"
    h.POCO.COND_NFLOW = True
    h.POCO.CONTEXT_DIM = 64
    h.POCO.NUM_FLOW_LAYERS = 1
    return h


@pytest.fixture(scope="module")
def testers():
    """The JAX `_tiny_tester` (batch 3, so that the video path chunks)
    and the port's twin on the same weights, both on a V=96 synthetic SMPL."""
    ref = JaxTester(_tiny_hparams(jax_hparams_defaults), jax_synthetic_smpl(num_verts=96),
                    batch_size=3)
    model = POCO(model_config_from_hparams(_tiny_hparams(get_hparams_defaults))).eval()
    model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, dict(ref.variables))), strict=True)
    port = PocoTester(model, synthetic_smpl_model(num_verts=96, device="cpu"), batch_size=3,
                      kinematic_uncert=ref.kinematic_uncert)
    return port, ref


def _ulp16(x):
    """One fp16 ulp at |x|."""
    return np.spacing(np.abs(x).astype(np.float16)).astype(np.float32)


def _assert_result_close(got: dict, ref: dict):
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for key, r in ref.items():
        g = got[key]
        if r is None:
            assert g is None, key
            continue
        r = np.asarray(r, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == r.shape, key
        if key in ("verts", "joints3d"):
            assert (np.abs(g - r) <= _ulp16(r) + 1e-7).all(), key
        elif key == "smpl_joints2d":
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=_ulp16(r).max(), err_msg=key)
        elif key in ("orig_cam", "frame_ids", "bboxes"):
            np.testing.assert_allclose(g, r, rtol=HEAD_TOL, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, atol=HEAD_TOL, rtol=0, err_msg=key)


def _assert_frames_close(got_path, ref_path):
    got, ref = cv2.imread(str(got_path)), cv2.imread(str(ref_path))
    assert got.shape == ref.shape
    assert (np.abs(got.astype(int) - ref).max(axis=2) > RENDER_LEVELS).mean() <= RENDER_SHARE


@pytest.mark.parametrize("options", [
    {"sideview": True, "save_obj": True},
    {"render_crop": True, "skip_frame": 2},
])
def test_image_folder_matches_jax(testers, frame_folder, tmp_path, options):
    port, ref = testers
    got = port.run_on_image_folder(frame_folder, str(tmp_path / "port"), **options)
    want = ref.run_on_image_folder(frame_folder, str(tmp_path / "jax"), **options)
    assert len(got) == len(want) == 4 // options.get("skip_frame", 1)
    for g, r in zip(got, want):
        _assert_result_close(g, r)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        if name.endswith(".png"):
            _assert_frames_close(tmp_path / "port" / name, tmp_path / "jax" / name)
    if options.get("sideview"):
        pngs = [n for n in names if n.endswith(".png")]
        assert len(pngs) == 4 and len(names) == 8     # a PNG and an OBJ an image
        assert cv2.imread(str(tmp_path / "port" / pngs[0])).shape[1] == 2 * FRAME_HW[1]


def test_folder_output_is_png_under_the_stem(testers, tmp_path):
    """The folder mode writes each input's own name in its own format, as
    the JAX demo's cv2.imwrite does (tester.py:769-770): JPEG inputs give
    JPEG overlays, which decode to the frame size, and the names equal
    the JAX demo's."""
    port, ref = testers
    folder = _jpeg_folder(tmp_path / "jpg")
    port.run_on_image_folder(folder, str(tmp_path / "out"))
    ref.run_on_image_folder(folder, str(tmp_path / "jax"))
    names = ["000000.jpg", "000001.jpg", "000002.jpg"]
    assert sorted(os.listdir(tmp_path / "out")) == sorted(os.listdir(tmp_path / "jax")) == names
    for name in names:
        data = (tmp_path / "out" / name).read_bytes()
        assert data[:3] == b"\xff\xd8\xff"
        assert cv2.imread(str(tmp_path / "out" / name)).shape == cv2.imread(
            str(Path(folder) / name)).shape


JPEG_PSNR_DB = 0.5   # the port's JPEG against cv2.imwrite's default, PSNR to the frame


@pytest.mark.parametrize("hw", [(120, 160), (151, 97)])
def test_jpeg_writer_matches_cv2_imwrite(tmp_path, hw):
    """`write_image` to .jpg on the libjpeg route: its file decodes (by
    cv2 and the port's loader alike) to within 0.5 dB PSNR of the file
    `cv2.imwrite` writes at its default quality, both against the frame."""
    from poco_tpu_torch.runtime.loader import decode_image, route

    assert route() == "libjpeg"
    frame = _scene(21, hw)
    write_image(str(tmp_path / "port.jpg"), frame)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), frame[:, :, ::-1])

    def psnr(img):
        return 10 * np.log10(255.0**2 / np.mean((img.astype(np.float64) - frame) ** 2))

    ours = decode_image(str(tmp_path / "port.jpg"))
    np.testing.assert_array_equal(ours, cv2.imread(str(tmp_path / "port.jpg"))[:, :, ::-1])
    want = psnr(cv2.imread(str(tmp_path / "cv2.jpg"))[:, :, ::-1])
    assert abs(psnr(ours) - want) <= JPEG_PSNR_DB and want > 30
    write_image(str(tmp_path / "x.JPEG"), frame)
    assert decode_image(str(tmp_path / "x.JPEG")).shape == frame.shape
    write_image(str(tmp_path / "x.png"), frame)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "x.png"))[:, :, ::-1], frame)
    with pytest.raises(ValueError, match="jpg, .jpeg and .png"):
        write_image(str(tmp_path / "x.bmp"), frame)


def test_chip_smoke_jpeg_reference_is_cv2s():
    """chip_smoke.py holds the card's JPEG encoder to FULLHD_CV2_PSNR: the
    PSNR of cv2.imwrite's default-quality re-encode of the full-HD test
    frame, as cv2 decodes it."""
    import chip_smoke

    img = cv2.imread(str(REPO / "tests" / "data" / "torch_fullhd.jpg"))
    ok, buf = cv2.imencode(".jpg", img)
    again = cv2.imdecode(buf, cv2.IMREAD_COLOR).astype(np.float64)
    db = 10 * np.log10(255.0**2 / np.mean((again - img) ** 2))
    assert ok and abs(db - chip_smoke.FULLHD_CV2_PSNR) <= 1e-3


def _assert_video_results_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for pid in want:
        _assert_result_close(got[pid], want[pid])


@pytest.mark.parametrize("smooth", [False, True])
def test_video_matches_jax(testers, frame_folder, tmp_path, smooth):
    port, ref = testers
    tracks = ref.run_tracking(frame_folder)
    assert port.run_tracking(frame_folder).keys() == tracks.keys()
    got = port.run_on_video(frame_folder, tracks=tracks, smooth=smooth)
    want = ref.run_on_video(frame_folder, tracks=tracks, smooth=smooth)
    _assert_video_results_close(got, want)
    if smooth:
        return
    port.render_results(got, frame_folder, str(tmp_path / "port"),
                        uncert_log=str(tmp_path / "port.log"))
    ref.render_results(want, frame_folder, str(tmp_path / "jax"),
                       uncert_log=str(tmp_path / "jax.log"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        _assert_frames_close(tmp_path / "port" / name, tmp_path / "jax" / name)
    got_log = [line.split() for line in (tmp_path / "port.log").read_text().splitlines()]
    ref_log = [line.split() for line in (tmp_path / "jax.log").read_text().splitlines()]
    assert [row[:2] for row in got_log] == [row[:2] for row in ref_log] and ref_log
    np.testing.assert_allclose([float(r[2]) for r in got_log], [float(r[2]) for r in ref_log],
                               atol=1e-3)


def test_tracking_cache(testers, frame_folder, tmp_path):
    port, _ = testers
    cache = str(tmp_path / "tracks.pkl")
    first = port.run_tracking(frame_folder, cache_file=cache)
    assert os.path.exists(cache)
    port.detector = None      # a cached run never detects
    try:
        again = port.run_tracking(frame_folder, cache_file=cache)
    finally:
        port.detector = tracker.full_frame_detector
    assert again.keys() == first.keys()


@pytest.mark.parametrize("kind", ["refine", "uncert"])
def test_model_in_the_loop_detectors_match_jax(testers, frame_folder, kind):
    port, ref = testers
    make = {"refine": lambda t: t.make_refined_detector(tracker.hog_person_detector
                                                        if t is port else None),
            "uncert": lambda t: t.make_uncert_detector()}[kind]
    port_det, ref_det = make(port), make(ref)
    imgs = [cv2.imread(p)[:, :, ::-1].copy() for p in images_in_folder(frame_folder)]
    for got, want in ((port_det.detect_batch(imgs), ref_det.detect_batch(imgs)),
                      ([port_det(imgs[0])], [ref_det(imgs[0])])):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=HEAD_TOL, atol=0.05)


DISPLAY_NOTICE = "--display requested but no GUI backend; skipping"   # the JAX tester's


def _written(folder) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(Path(folder).iterdir()) if p.is_file()}


def test_tester_refuses_cv2_drawing(testers, frame_folder, tmp_path, monkeypatch, capsys):
    """`display` in both modes, as the JAX tester's: each written frame
    goes to `_display_frame`, which, with no GUI backend (no display
    server here; or cv2 not importable), prints JAX's notice once
    and lets the run go on; the written frames are those of a run without
    `display`. The JAX tester, whose `cv2.imshow` raises cv2.error without
    a GUI backend (patched so here: this host's Qt build of cv2 aborts the
    process instead), prints the same notice."""
    port, ref = testers
    monkeypatch.setattr(port, "_display_warned", False, raising=False)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    shown = []
    show = port._display_frame
    monkeypatch.setattr(port, "_display_frame", lambda frame: (shown.append(frame), show(frame)))
    outs = {}
    for display in (False, True):
        folder = tmp_path / f"folder_{display}"
        port.run_on_image_folder(frame_folder, str(folder), display=display)
        port.render_results({}, frame_folder, str(tmp_path / f"video_{display}"),
                            display=display)
        outs[display] = (_written(folder), _written(tmp_path / f"video_{display}"))
    assert outs[True] == outs[False] and len(outs[True][0]) == len(outs[True][1]) == 4
    assert len(shown) == 8
    assert capsys.readouterr().out.count(DISPLAY_NOTICE) == 1

    def no_gui(*args):
        raise cv2.error("The function is not implemented")

    monkeypatch.setattr(cv2, "imshow", no_gui)
    ref._display_warned = False
    for _ in range(2):
        ref._display_frame(np.zeros((4, 4, 3), np.uint8))
    assert capsys.readouterr().out.count(DISPLAY_NOTICE) == 1


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

TINY_YAML = str(REPO / "configs" / "tiny_smoke.yaml")


def test_cli_folder_and_video_on_the_cpu(frame_folder, tmp_path, capsys):
    results = cli_demo.main(["--cfg", TINY_YAML, "--image_folder", frame_folder,
                             "--output_folder", str(tmp_path / "folder"), "--sideview",
                             "--device", "cpu"])
    assert len(results) == 4 and all(r["verts"].shape[0] == 1 for r in results)
    assert len([f for f in os.listdir(tmp_path / "folder") if f.endswith(".png")]) == 4
    results = cli_demo.main(["--cfg", TINY_YAML, "--mode", "video", "--image_folder",
                             frame_folder, "--output_folder", str(tmp_path / "video"),
                             "--smooth", "--device", "cpu"])
    assert len(results) == 1
    assert sorted(os.listdir(tmp_path / "video" / "rendered")) == [f"{i:06d}.png" for i in range(4)]
    assert (tmp_path / "video" / "uncertainty.log").read_text().count("\n") == 3
    assert (tmp_path / "video" / "tracking_results.pkl").exists()
    out = capsys.readouterr().out
    assert "poco FPS" in out and "stage seconds" in out


CAMERA_ERROR = "cannot open video capture"   # the JAX package's VideoCaptureFrameSource
MASKRCNN_NOTICE = ("--detector maskrcnn: torchvision (or its pretrained weights) is unavailable "
                   "in this environment; falling back to --detector yolo (TPU-native).")
YOUTUBE_EXIT = "YouTube download failed (install pytube or yt-dlp, and check the url)"


@pytest.mark.parametrize("flags", [
    ["--mode", "webcam"], ["--display"], ["--mode", "webcam", "--webcam_source", "1"],
    ["--mode", "video", "--display"],
    ["--mode", "webcam", "--webcam_source", "rtsp://127.0.0.1:1/stream"],
    ["--mode", "directory", "--display"],
    ["--detector", "maskrcnn"], ["--mode", "video", "--vid_file", "https://youtu.be/x"],
])
def test_cli_refuses_unported_flags(flags, frame_folder, tmp_path, monkeypatch, capsys):
    """The modes and flags the port once refused behave as `demo.py`'s:
    a camera index (the default source `0`, and `1`) or a stream that
    does not open raises the JAX package's RuntimeError (cv2.VideoCapture
    here; the stream is on loopback, where nothing listens); `--display`
    in each mode completes with JAX's notice (no display server here);
    Mask R-CNN falls back to yolo with JAX's notice (no torchvision), and
    yolo to refine (no weights); a YouTube URL without pytube or yt-dlp
    stops with JAX's SystemExit before anything touches the network."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.delenv("POCO_TPU_YOLO_WEIGHTS", raising=False)
    monkeypatch.delenv("POCO_TPU_MASKRCNN_WEIGHTS", raising=False)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    monkeypatch.setitem(sys.modules, "pytube", None)
    monkeypatch.setattr(demo_utils.shutil, "which", lambda name: None)
    parent = tmp_path / "parent"
    for sub in ("a", "b"):
        (parent / sub).mkdir(parents=True)
        for name in sorted(os.listdir(frame_folder))[:2]:
            (parent / sub / name).write_bytes((Path(frame_folder) / name).read_bytes())
    folder = str(parent if "directory" in flags else frame_folder)
    argv = ["--cfg", TINY_YAML, *flags, "--image_folder", folder, "--output_folder",
            str(tmp_path / "out"), "--max_frames", "2", "--yolo_weights",
            str(tmp_path / "absent.weights"), "--device", "cpu"]
    if flags[:2] == ["--mode", "webcam"]:
        with pytest.raises(RuntimeError, match=CAMERA_ERROR):
            cli_demo.main(argv)
        return
    if "--vid_file" in flags:
        with pytest.raises(SystemExit, match=re.escape(YOUTUBE_EXIT)):
            cli_demo.main(argv)
        return
    results = cli_demo.main(argv)
    out = capsys.readouterr().out
    if "--display" in flags:
        assert out.count(DISPLAY_NOTICE) == 1
    if "maskrcnn" in flags:
        assert MASKRCNN_NOTICE in out and "falling back to --detector refine" in out
    if "directory" in flags:
        assert sorted(results) == ["a", "b"]
        assert all(len(os.listdir(tmp_path / "out" / sub)) == 2 for sub in results)
    else:
        assert len(results) == (1 if "video" in flags else 4)


def test_cli_yolo_without_weights_turns_into_refine(monkeypatch, tmp_path, frame_folder, capsys):
    monkeypatch.delenv("POCO_TPU_YOLO_WEIGHTS", raising=False)
    args = cli_demo.parse_args(["--cfg", TINY_YAML, "--detector", "yolo", "--yolo_weights",
                                str(tmp_path / "absent.weights"), "--device", "cpu"])
    tester = cli_demo.build_tester(args)
    assert args.detector == "refine" and hasattr(tester.detector, "detect_batch")
    assert "falling back to --detector refine" in capsys.readouterr().out


def test_cli_video_file_needs_ffmpeg(monkeypatch, tmp_path, frame_folder):
    """Without ffmpeg and cv2, `video_to_images` raises,
    naming both, for a file that is not a Motion-JPEG AVI, and
    `images_to_video` writes Motion-JPEG to `<stem>.avi` in place of the
    mp4 (tests/test_torch_live_sources.py holds both routes)."""
    monkeypatch.setattr(demo_utils.shutil, "which", lambda name: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    (tmp_path / "x.mp4").write_bytes(b"\0\0\0\x18ftypmp42")
    with pytest.raises(RuntimeError, match="ffmpeg on PATH or cv2"):
        demo_utils.video_to_images(str(tmp_path / "x.mp4"), str(tmp_path / "frames"))
    written = demo_utils.images_to_video(frame_folder, str(tmp_path / "x_poco.mp4"))
    assert written == str(tmp_path / "x_poco.avi") and not (tmp_path / "x_poco.mp4").exists()
    from poco_tpu_torch.utils.mjpeg import read_avi_mjpeg

    assert len(list(read_avi_mjpeg(written))) == 4


def test_cli_needs_a_card_unless_asked_for_the_cpu(frame_folder):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_demo.main(["--cfg", TINY_YAML, "--image_folder", frame_folder])


# --------------------------------------------------------------------------
# what the demo's modules import
# --------------------------------------------------------------------------

DEMO_MODULES = ["demo/tester.py", "demo/tracker.py", "demo/yolo.py", "demo/stream.py",
                "cli/demo.py", "data/inference.py", "viz/renderer.py", "runtime/raster.py",
                "runtime/image_write.py", "utils/demo_utils.py", "utils/mjpeg.py",
                "utils/smooth_bbox.py", "utils/one_euro.py", "utils/smooth_pose.py",
                "utils/kp_utils.py"]


@pytest.mark.parametrize("module", DEMO_MODULES)
def test_demo_module_imports_no_jax_opencv_or_pil(module):
    """No JAX, flax, JAX package or PIL import anywhere in the module; cv2,
    torchvision and pytube only inside the functions that use them (the
    JAX package's optional routes)."""
    tree = ast.parse((REPO / "poco_tpu_torch" / module).read_text())
    in_functions = {id(node) for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for node in ast.walk(fn)}
    for node in ast.walk(tree):
        optional_here = id(node) in in_functions
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "flax", "poco_tpu", "PIL"), name
            if not optional_here:
                assert name.split(".")[0] not in ("cv2", "torchvision", "pytube"), name


def test_demo_imports_with_jax_cv2_and_pil_hidden():
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'cv2', 'PIL', 'poco_tpu', 'torchvision', 'pytube'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import poco_tpu_torch.{m[:-3].replace('/', '.')}\n" for m in DEMO_MODULES))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


# --------------------------------------------------------------------------
# the video fixture of chip_smoke.py phase 4j
# --------------------------------------------------------------------------

VIDEO_DIR = REPO / "tests" / "data" / "torch_video"


def make_video_frames() -> dict[str, bytes]:
    """`tests/data/torch_video/`: 16 same-size 960x540 JPEG frames cut
    from `tests/data/torch_fullhd.jpg` by crops shifting 24 px right and
    8 px down a frame (quality 90), so that a tracker follows motion. The
    card's host has no JPEG encoder, so they are made here and committed."""
    full = cv2.imread(str(REPO / "tests" / "data" / "torch_fullhd.jpg"))
    frames = {}
    for i in range(16):
        y, x = 100 + 8 * i, 200 + 24 * i
        ok, enc = cv2.imencode(".jpg", full[y:y + 540, x:x + 960], [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        frames[f"{i:06d}.jpg"] = enc.tobytes()
    return frames


def test_video_fixture_regenerates_equal():
    made = make_video_frames()
    assert sorted(os.listdir(VIDEO_DIR)) == sorted(made)
    for name, data in made.items():
        assert (VIDEO_DIR / name).read_bytes() == data, name
