"""PyTorch port vs JAX package: the demo's YOLOv3 detector
(`poco_tpu_torch/demo/yolo.py` against `poco_tpu.demo.yolo`).

One seeded Darknet `.weights` file (width 4, 3 classes, BN statistics
drawn uniformly; written by the port's `save_darknet_weights`) is loaded
by both packages' loaders: the raw maps at 64 px agree within 2e-5, the
bar of `tests/test_yolo.py:227`, and the same holds when the JAX
variables reach the port through `yolo_state_dict_from_jax`. A file of
another width raises in the port's loader. `decode_predictions` agrees
within 1e-5 relative. `letterbox` resizes on the device in float where
cv2's INTER_LINEAR (the JAX side) weighs in 11-bit fixed point: the
canvases agree within one grey level (1/255) everywhere, scale and pads
exactly. `detect_batch` keeps the same boxes (within 1e-3 px) on
identical canvases: images at the network size, which both letterboxes
copy unchanged, and others with the port's letterbox handed JAX's canvas,
so that no resize rounding reaches the threshold or the NMS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.demo.yolo as jax_yolo
from poco_tpu_torch.demo import yolo
from poco_tpu_torch.utils.weights import yolo_state_dict_from_jax

WIDTH, NUM_CLASSES, IMG = 4, 3, 64
MAPS_ATOL = 2e-5        # tests/test_yolo.py:227
GREY = 1.0 / 255.0      # one grey level on the [0, 1] canvas


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_yolo(seed: int = 0, width: int = WIDTH) -> yolo.YoloV3:
    torch.manual_seed(seed)
    model = yolo.YoloV3(width=width, num_classes=NUM_CLASSES).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.startswith("bn"):
                m.running_mean.copy_(torch.rand(m.num_features, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(m.num_features, generator=g))
    return model


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("yolo") / "tiny.weights")
    yolo.save_darknet_weights(seeded_yolo(), path)
    return path


@pytest.fixture(scope="module")
def jax_variables(weights_file):
    model = jax_yolo.YoloV3(width=WIDTH, num_classes=NUM_CLASSES)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    return model, jax_yolo.load_darknet_weights(weights_file, variables)


def _canvases(n: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, IMG, IMG, 3).astype(np.float32)


def _port_maps(model, x):
    with torch.no_grad():
        return [m.numpy().transpose(0, 2, 3, 1) for m in model(torch.from_numpy(x).permute(0, 3, 1, 2))]


def test_raw_maps_match_jax(weights_file, jax_variables):
    fm, variables = jax_variables
    model = yolo.load_darknet_weights(weights_file, yolo.YoloV3(WIDTH, NUM_CLASSES)).eval()
    x = _canvases(2)
    ref = fm.apply(variables, jnp.asarray(x))
    got = _port_maps(model, x)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r), atol=MAPS_ATOL, rtol=0)


def test_weights_bridge_matches_jax(jax_variables):
    fm, variables = jax_variables
    model = yolo.YoloV3(WIDTH, NUM_CLASSES).eval()
    model.load_state_dict(
        yolo_state_dict_from_jax(jax.tree.map(np.asarray, dict(variables))), strict=True)
    x = _canvases(2, seed=2)
    for g, r in zip(_port_maps(model, x), fm.apply(variables, jnp.asarray(x))):
        np.testing.assert_allclose(g, np.asarray(r), atol=MAPS_ATOL, rtol=0)


def test_weights_bridge_refuses_unknown_leaves():
    with pytest.raises(KeyError, match="no place"):
        yolo_state_dict_from_jax({"params": {"head": {"kernel": np.zeros((1, 1, 1, 1))}}})


@pytest.mark.parametrize("width", [8, 2])
def test_loader_rejects_another_width(weights_file, width):
    """A file of width 4 does not fit a model of width 8 (too few floats)
    or 2 (floats left over): the loader raises, as the JAX one does."""
    with pytest.raises(ValueError, match="truncated|mismatch"):
        yolo.load_darknet_weights(weights_file, yolo.YoloV3(width, NUM_CLASSES))


def test_decode_matches_jax():
    rng = np.random.RandomState(3)
    for si, (h, stride) in enumerate(((2, 32), (4, 16), (8, 8))):
        p = (2.0 * rng.randn(2, h, h, 3 * (5 + NUM_CLASSES))).astype(np.float32)
        ref_boxes, ref_scores = jax_yolo.decode_predictions(
            jnp.asarray(p), jax_yolo.YOLO_ANCHORS[si], stride, NUM_CLASSES)
        boxes, scores = yolo.decode_predictions(
            torch.from_numpy(p).permute(0, 3, 1, 2), yolo.YOLO_ANCHORS[si], stride, NUM_CLASSES)
        np.testing.assert_allclose(boxes.numpy(), np.asarray(ref_boxes), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=1e-5, atol=1e-7)


def test_decode_known_cell():
    p = np.full((1, 2, 2, 3, 5 + NUM_CLASSES), -20.0, np.float32)
    p[0, 1, 0, 1, 0:4] = 0.0          # centred, wh = anchor
    p[0, 1, 0, 1, 4:6] = 20.0         # obj and person ~ 1
    boxes, scores = yolo.decode_predictions(
        torch.from_numpy(p.reshape(1, 2, 2, -1)).permute(0, 3, 1, 2),
        yolo.YOLO_ANCHORS[0], 32, NUM_CLASSES)
    i = int(scores[0].argmax())
    anchor = yolo.YOLO_ANCHORS[0][1]
    np.testing.assert_allclose(boxes[0, i].numpy(), [16.0, 48.0, anchor[0], anchor[1]], rtol=1e-6)
    assert float(scores[0].sort().values[-2]) < 1e-6


@pytest.mark.parametrize("hw", [(1080, 1920), (301, 217), (416, 416), (48, 96)])
def test_letterbox_matches_jax(hw):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, (*hw, 3), dtype=np.uint8)
    canvas, scale, px, py = yolo.letterbox(img, 416)
    ref, ref_scale, ref_px, ref_py = jax_yolo.letterbox(img, 416)
    assert (scale, px, py) == (ref_scale, ref_px, ref_py)
    np.testing.assert_allclose(canvas.numpy(), ref, atol=GREY + 1e-6, rtol=0)


def _detectors(weights_file, threshold):
    kwargs = dict(img_size=IMG, conf_threshold=threshold, batch_size=2, width=WIDTH,
                  num_classes=NUM_CLASSES)
    return (yolo.YoloDetector(weights_file, device="cpu", **kwargs),
            jax_yolo.YoloDetector(weights_file, **kwargs))


def _threshold_in_gap(scores: np.ndarray, q: float = 0.8) -> float:
    """A threshold near the q-quantile with no score within 1e-4 of it,
    so that rounding cannot move a row across it."""
    s = np.sort(scores.reshape(-1))
    i = int(q * len(s))
    while s[i + 1] - s[i] < 2e-4:
        i += 1
    return float(0.5 * (s[i] + s[i + 1]))


def _assert_same_boxes(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[0] > 0
        np.testing.assert_allclose(g, r, atol=1e-3, rtol=0)


def test_detect_batch_matches_jax_at_network_size(weights_file):
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(3)]
    port, _ = _detectors(weights_file, 0.0)
    _, scores = port.forward_decode(port.letterbox_batch(imgs)[0])
    port, ref = _detectors(weights_file, _threshold_in_gap(scores.numpy()))
    _assert_same_boxes(port.detect_batch(imgs), ref.detect_batch(imgs))


def test_detect_batch_matches_jax_on_its_canvases(weights_file, monkeypatch):
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (50, 70, 3), dtype=np.uint8) for _ in range(3)]

    def jax_canvas(img, size, fill=0.5, device=None):
        canvas, scale, px, py = jax_yolo.letterbox(img, size, fill)
        return torch.from_numpy(canvas), scale, px, py

    monkeypatch.setattr(yolo, "letterbox", jax_canvas)
    port, _ = _detectors(weights_file, 0.0)
    _, scores = port.forward_decode(port.letterbox_batch(imgs)[0])
    port, ref = _detectors(weights_file, _threshold_in_gap(scores.numpy()))
    _assert_same_boxes(port.detect_batch(imgs), ref.detect_batch(imgs))


def test_make_yolo_detector_looks_in_the_jax_places(weights_file, monkeypatch, tmp_path):
    monkeypatch.delenv("POCO_TPU_YOLO_WEIGHTS", raising=False)
    assert yolo.make_yolo_detector(str(tmp_path / "absent.weights")) is None
    assert jax_yolo.make_yolo_detector(str(tmp_path / "absent.weights")) is None
    monkeypatch.setenv("POCO_TPU_YOLO_WEIGHTS", weights_file)
    det = yolo.make_yolo_detector(None, img_size=IMG, width=WIDTH, num_classes=NUM_CLASSES,
                                  device="cpu")
    assert isinstance(det, yolo.YoloDetector)
    assert yolo.default_weights_candidates()[2].endswith("data/detector/yolov3.weights")


def test_detector_refuses_a_missing_card(weights_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolo.YoloDetector(weights_file, img_size=IMG, width=WIDTH, num_classes=NUM_CLASSES)
