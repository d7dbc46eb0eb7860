"""PyTorch port vs cv2 and the JAX package: the demo's cv2 drawing calls,
drawn without OpenCV (`runtime/native/poco_raster.cpp`, `runtime/raster.py`,
`viz/renderer.py`, `demo/tester.py`).

Bars, stated at each test:
  * the wireframe (`cv2.polylines(..., True, colour, 1, LINE_AA)` of each
    face on the float32 overlay) and the keypoints (`cv2.circle(..., 3,
    colour, -1, LINE_AA)` on uint8) equal cv2's pixels exactly, on random
    faces and centres that cross the image's edges, and the port's
    `Renderer.render(wireframe=True)` and `draw_keypoints_2d` equal the
    JAX package's on the same inputs;
  * the caption (`overlay_text`: cv2.getTextSize, a filled rectangle,
    cv2.putText with FONT_HERSHEY_SIMPLEX, which OpenCV 5 draws as its
    TrueType font Rubik; viz/text.py, tools/make_caption_font.py): text
    sizes equal cv2.getTextSize's, the caption's box equals the JAX
    package's, and of the pixels cv2 changes, and of the text's own ink
    pixels in the box, at most 0.5% differ and none by more than one grey
    level (measured: about 1e-4 of them, by one level, from float
    rounding on diagonal edges). Controls that must miss the same bar:
    no text in the right box, another string of the same length, the
    text two pixels to the right;
  * through the tester, the folder mode's `draw_keypoints` frame is the
    plain frame with `draw_keypoints_2d` over it, and the video mode's
    wireframe and captioned side-view frames match the JAX tester's at
    the rendering bar of tests/test_torch_demo.py outside the caption,
    and at the caption's bar inside its box;
  * the caption kept for the card's check (tests/data/torch_caption_cv2.npz,
    written by tools/make_caption_font.py) is the JAX package's.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import poco_tpu.viz.renderer as jax_renderer
from poco_tpu.demo.tester import draw_keypoints_2d as jax_draw_keypoints_2d

from poco_tpu_torch.demo.tester import draw_keypoints_2d
from poco_tpu_torch.runtime import raster
from poco_tpu_torch.viz import renderer, text

from .test_torch_demo import (  # noqa: F401
    RENDER_LEVELS, RENDER_SHARE, _assert_frames_close, _mesh, _scene, frame_folder, testers,
)

FONT = cv2.FONT_HERSHEY_SIMPLEX
CAPTION_HEIGHTS = [120, 240, 480, 540, 720, 1080, 2160]   # frame heights
CAPTION_SHARE = 0.005     # of the pixels compared, at most this share may differ
CAPTION_LEVELS = 1        # and none by more than this many grey levels
CARD_REFERENCE = os.path.join(os.path.dirname(__file__), "data", "torch_caption_cv2.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _changed(after: np.ndarray, before: np.ndarray) -> np.ndarray:
    return (after != before).any(axis=-1)


@pytest.mark.parametrize("seed", range(4))
def test_wireframe_is_cv2_polylines(seed):
    """40 faces of random colour, corners up to 30% outside the image:
    every pixel equals cv2's (LineIterator's clipped 8-connected lines, the
    later face over the earlier)."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(30, 200, 2)
    img = (rng.rand(h, w, 3) * 255).astype(np.float32)
    pts = np.round(rng.uniform(-0.3, 1.3, (40, 3, 2)) * [w, h]).astype(np.int32)
    colors = (rng.rand(40, 3) * 255).astype(np.float32)
    ref = img.copy()
    for tri, color in zip(pts, colors):
        cv2.polylines(ref, [tri], True, color.tolist(), 1, cv2.LINE_AA)
    got = raster.wireframe(img, pts, colors)
    assert _changed(ref, img).sum() > 100
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("radius", [1, 2, 3, 7, 16])
def test_circles_are_cv2_circles(radius):
    """30 filled anti-aliased circles (centres up to 5 px outside the
    image) over a random uint8 image: every pixel equals cv2's."""
    rng = np.random.RandomState(radius)
    h, w = 64, 96
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    centers = np.stack([rng.randint(-5, w + 5, 30), rng.randint(-5, h + 5, 30)], 1)
    ref = img.copy()
    for x, y in centers:
        cv2.circle(ref, (int(x), int(y)), radius, (0, 255, 0), -1, cv2.LINE_AA)
    got = img.copy()
    raster.circles_aa(got, centers, radius, (0, 255, 0))
    assert _changed(ref, img).sum() > 30
    np.testing.assert_array_equal(got, ref)


def test_draw_keypoints_matches_jax():
    """Two people's 49 joints, some off the frame and some not finite: the
    port's frame equals the JAX package's `draw_keypoints_2d` (cv2), and it
    draws in place on a contiguous uint8 frame, as cv2 does."""
    rng = np.random.RandomState(3)
    frame = _scene(4)
    joints = rng.uniform(-20, 340, (2, 49, 2)).astype(np.float32)
    joints[0, 5] = np.nan
    joints[1, 7, 1] = np.inf
    ref = jax_draw_keypoints_2d(frame.copy(), joints)
    got_frame = frame.copy()
    got = draw_keypoints_2d(got_frame, joints)
    assert got is got_frame
    assert _changed(ref, frame).sum() > 500
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("with_colors", [False, True])
def test_wireframe_render_matches_jax(with_colors):
    """`Renderer.render(..., wireframe=True)` on the JAX package's inputs
    (a 300-vertex mesh, a frame, the uncertainty colours or the flat one):
    equal to the JAX renderer's cv2.polylines loop."""
    verts, faces = _mesh()
    colors = None
    if with_colors:
        lbs = np.random.RandomState(9).rand(len(verts), 24)
        var = np.random.RandomState(10).rand(24).astype(np.float32)
        colors = renderer.get_vertex_colors(var.copy(), lbs, backbone="tiny-cliff")
    img = _scene(11)
    cam = np.array([0.8, 1.0, 0.05, -0.1], np.float32)
    got = renderer.Renderer(faces).render(img, verts, cam, vertex_colors=colors, wireframe=True)
    ref = jax_renderer.Renderer(faces).render(img, verts, cam, vertex_colors=colors,
                                              wireframe=True)
    assert _changed(ref, img).sum() > 1000
    np.testing.assert_array_equal(got, ref)


def test_folder_keypoints_are_drawn_over_the_frame(testers, frame_folder, tmp_path):  # noqa: F811
    """Folder mode with `draw_keypoints`: each frame is the plain frame
    with `draw_keypoints_2d` of the result's projected joints over it."""
    port, _ = testers
    plain = port.run_on_image_folder(frame_folder, str(tmp_path / "plain"))
    marked = port.run_on_image_folder(frame_folder, str(tmp_path / "kp"), draw_keypoints=True)
    names = sorted(os.listdir(tmp_path / "kp"))
    assert names == sorted(os.listdir(tmp_path / "plain")) and len(names) == 4
    for name, result in zip(names, marked):
        np.testing.assert_array_equal(result["smpl_joints2d"],
                                      plain[names.index(name)]["smpl_joints2d"])
        want = draw_keypoints_2d(cv2.imread(str(tmp_path / "plain" / name))[:, :, ::-1].copy(),
                                 result["smpl_joints2d"])
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "kp" / name))[:, :, ::-1], want)


@pytest.mark.parametrize("sideview", [False, True])
def test_video_wireframe_matches_jax(testers, frame_folder, tmp_path, sideview):  # noqa: F811
    """The video mode's `render_results(wireframe=True)`, with and without
    the captioned side view (twice the width): the port's frames match the
    JAX tester's at tests/test_torch_demo.py's rendering bar (at most 0.1%
    of the pixels more than 2 grey levels off) outside the caption's box,
    the box itself equal, and inside it at the caption's bar."""
    port, ref = testers
    tracks = ref.run_tracking(frame_folder)
    got = port.run_on_video(frame_folder, tracks=tracks)
    want = ref.run_on_video(frame_folder, tracks=tracks)
    port.render_results(got, frame_folder, str(tmp_path / "port"), wireframe=True,
                        sideview=sideview)
    ref.render_results(want, frame_folder, str(tmp_path / "jax"), wireframe=True,
                       sideview=sideview)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        if not sideview:
            _assert_frames_close(tmp_path / "port" / name, tmp_path / "jax" / name)
            continue
        g = cv2.imread(str(tmp_path / "port" / name))[:, :, ::-1]
        r = cv2.imread(str(tmp_path / "jax" / name))[:, :, ::-1]
        h, w2 = r.shape[:2]
        assert g.shape == r.shape and w2 == 2 * cv2.imread(
            os.path.join(frame_folder, sorted(os.listdir(frame_folder))[0])).shape[1]
        box = _box((r[:, w2 // 2:] == 255).all(-1))   # the caption's white box
        assert np.array_equal(_box((g[:, w2 // 2:] == 255).all(-1)), box)
        x0, x1, y0, y1 = box + [w2 // 2, w2 // 2, 0, 0]
        inside = np.zeros((h, w2), bool)
        inside[y0:y1 + 1, x0:x1 + 1] = True
        off = np.abs(g.astype(int) - r).max(-1)
        assert (off[~inside] > RENDER_LEVELS).mean() <= RENDER_SHARE
        assert (off[inside] > 0).mean() <= CAPTION_SHARE and off[inside].max() <= CAPTION_LEVELS


@pytest.mark.parametrize("height", CAPTION_HEIGHTS)
def test_text_size_near_cv2(height):
    """At the demo's scale and thickness for a frame `height` tall, and at
    40 random scales and thicknesses: (width, height) equal
    cv2.getTextSize's, for the caption, other strings and none."""
    rng = np.random.RandomState(height)
    cases = [(height * 0.0016, max(int(height * 0.005), 1), caption)
             for caption in ("Other View", "POCO 0.25 m", "gjpqy|{}~", "I", "")]
    cases += [(float(rng.uniform(0.05, 4.0)), int(rng.randint(1, 6)),
               "".join(map(chr, rng.randint(32, 127, rng.randint(1, 14))))) for _ in range(40)]
    for scale, thickness, caption in cases:
        want = cv2.getTextSize(caption, FONT, scale, thickness)[0]
        assert text.get_text_size(caption, scale, thickness) == want, (caption, scale, thickness)


@pytest.mark.parametrize("seed", range(4))
def test_put_text_is_cv2s(seed):
    """25 random printable strings, scales (sizes 2-108 px), thicknesses,
    colours and origins (some left of the image) over random images: of
    the pixels cv2.putText changes, at most 0.5% differ from the port's,
    none by more than one grey level."""
    rng = np.random.RandomState(seed)
    changed = off = 0
    for _ in range(25):
        scale, thickness = float(rng.uniform(0.05, 4.0)), int(rng.randint(1, 6))
        caption = "".join(map(chr, rng.randint(32, 127, rng.randint(1, 14))))
        size = text.pixel_size(scale)
        img = (rng.rand(3 * size + 4, 12 * size + 20, 3) * 255).astype(np.uint8)
        org, color = (int(rng.randint(-5, 10)), 2 * size), tuple(map(int, rng.randint(0, 256, 3)))
        ref = cv2.putText(img.copy(), caption, org, FONT, scale, color, thickness)
        got = text.put_text(img.copy(), caption, org, scale, color, thickness)
        diff = np.abs(got.astype(int) - ref).max(-1)
        assert diff.max() <= CAPTION_LEVELS, (caption, scale, thickness)
        changed += _changed(ref, img).sum()
        off += (diff > 0).sum()
    assert changed > 20000 and off <= CAPTION_SHARE * changed


def _box(changed: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(changed)
    if not len(ys):
        return np.full(4, -1)
    return np.asarray([xs.min(), xs.max(), ys.min(), ys.max()])


def _caption_misses(got: np.ndarray, ref: np.ndarray, img: np.ndarray) -> list[str]:
    """What keeps the caption `got` from the caption bar against cv2's
    `ref`, both drawn over `img`: the box of changed pixels, then the
    share of differing pixels among those cv2 changes and among the text's
    ink (the box's pixels cv2 does not leave white), then the largest
    difference."""
    changed = _changed(ref, img)
    misses = []
    if not np.array_equal(_box(_changed(got, img)), _box(changed)):
        misses.append("box")
    x0, x1, y0, y1 = _box(changed)
    ink = np.zeros_like(changed)
    ink[y0:y1 + 1, x0:x1 + 1] = (ref[y0:y1 + 1, x0:x1 + 1] != 255).any(-1)
    diff = np.abs(got.astype(int) - ref).max(-1)
    for name, where in (("changed", changed), ("ink", ink)):
        if (diff[where] > 0).mean() > CAPTION_SHARE:
            misses.append(name)
    if diff.max() > CAPTION_LEVELS:
        misses.append("levels")
    return misses


def _caption_case(height: int) -> tuple[np.ndarray, np.ndarray]:
    """A random frame `height` tall (16:9 or 4:3) and the JAX package's
    caption over it (cv2)."""
    width = height * 16 // 9 if height % 9 == 0 else height * 4 // 3
    img = (np.random.RandomState(height).rand(height, width, 3) * 255).astype(np.uint8)
    return img, jax_renderer.overlay_text(img.copy(), "Other View")


@pytest.mark.parametrize("height", CAPTION_HEIGHTS)
def test_caption_near_jax(height):
    """`overlay_text(frame, "Other View")` against the JAX package's (cv2):
    the same box, and at the caption bar over the pixels cv2 changes and
    over the text's ink."""
    img, ref = _caption_case(height)
    got = renderer.overlay_text(img.copy(), "Other View")
    assert (_changed(ref, img) & (ref != 255).any(-1)).sum() > 20   # the text has ink
    assert _caption_misses(got, ref, img) == []


def _put_caption_text(img: np.ndarray, txt: str, dx: int) -> np.ndarray:
    """The port's caption with `txt` in "Other View"'s box, `dx` px right."""
    h, w = img.shape[:2]
    x, y = int(w * 0.02), int(h * 0.06)
    tw, th = text.get_text_size("Other View", h * 0.0016, max(int(h * 0.005), 1))
    off = int(h * 0.01)
    img[y - th - off:y + off + 1, x:x + tw + off + 1] = 255
    return text.put_text(img, txt, (x + dx, y), h * 0.0016, (255, 0, 0), max(int(h * 0.005), 1))


@pytest.mark.parametrize("height", CAPTION_HEIGHTS)
@pytest.mark.parametrize("control", ["no text", "another string", "shifted 2 px"])
def test_caption_bar_rejects_a_wrong_caption(height, control):
    """The caption bar is not met by a wrong caption in the right box: no
    text, "Otter Vies" (ten characters too), or the text two pixels to
    the right; each misses on the share of changed pixels and of ink.
    The right text in the same way meets it."""
    img, ref = _caption_case(height)
    assert _caption_misses(_put_caption_text(img.copy(), "Other View", 0), ref, img) == []
    txt, dx = {"no text": ("", 0), "another string": ("Otter Vies", 0),
               "shifted 2 px": ("Other View", 2)}[control]
    misses = _caption_misses(_put_caption_text(img.copy(), txt, dx), ref, img)
    assert {"changed", "ink"} <= set(misses), misses


def test_card_caption_reference_is_jaxs():
    """The captions kept for the card's check (phase 4o of chip_smoke.py)
    are the JAX package's `overlay_text` boxes on a black frame, and the
    port's meet the caption bar against them."""
    data = np.load(CARD_REFERENCE)
    for h in (540, 1080):
        blank = np.zeros((h, h * 16 // 9, 3), np.uint8)
        ref = jax_renderer.overlay_text(blank.copy(), "Other View")
        x0, y0, x1, y1 = data[f"box_{h}"]
        assert np.array_equal(_box(_changed(ref, blank)), [x0, x1, y0, y1])
        np.testing.assert_array_equal(data[f"caption_{h}"], ref[y0:y1 + 1, x0:x1 + 1])
        got = renderer.overlay_text(blank.copy(), "Other View")
        assert _caption_misses(got, ref, blank) == []


def test_text_draws_in_place_and_blends_by_coverage():
    """`put_text` draws on the image it is given; interior pixels take the
    colour, and every changed pixel lies between the background and it."""
    img = np.full((60, 200, 3), 40, np.uint8)
    out = text.put_text(img, "Other View", (5, 40), 1.0, (255, 0, 0), 1)
    assert out is img
    changed = _changed(img, np.full_like(img, 40))
    assert changed.sum() > 200 and (img[changed][:, 0] >= 40).all()
    assert (img[changed][:, 1:] <= 40).all() and (img[..., 0] == 255).sum() > 50
