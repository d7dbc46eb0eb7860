"""The port's CUDA kernels on the card (marker `gpu`; skipped without one).

Run on a machine with a CUDA card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The skinning kernel (`skinning`, 3xTF32 tensor cores) and its fp32-FMA
yardstick (`skinning_simt`) are held to their plain torch version on the
same CUDA tensors at atol 1e-4 (fp32 sums of 24 terms in another order;
the 3xTF32 split is within about 1e-6 of fp32), at the main path's shape,
at the edges of the 16-row warp slices and the 128-vertex block tile,
at odd sample counts (a pair with one sample), and at any 4-byte
alignment of the tensors. The main paths (POCO-CLIFF, POCO-PARE, HMR)
launch `skinning` once per SMPL forward and never `skinning_simt`; the
flow head's forward runs on the card. The backward kernel
(`skinning_backward`, 3xTF32 tensor cores) and its fp32-FMA yardstick
(`skinning_backward_simt`) are held to their plain version at every batch
the paths launch them with, at the edges of the warp slices and tiles of
both, and at any 4-byte alignment, within 1e-5 x max |plain| + 1e-7 for
both gradients; they give bit-identical gradients on a second run (no
atomics), and `skinning_backward` carries autograd through `skinning`; skinning weights that need a
gradient raise (the kernel gives them none). The eval step runs on the
card as on the CPU (per-sample metrics within 1e-4 m), launches
`skinning` 5 times a batch (7 with flip-TTA), its Procrustes matches
float64 numpy, and flip-TTA of a flip-equivariant stub is exact. One
full-width POCO-CLIFF train step is finite and launches the forward
kernel twice and the backward kernel once. The image loader on the
card's host (`runtime/loader.py`; nvJPEG where the host has no libjpeg)
decodes the smoke JPEGs within 2 grey levels of cv2's 16x16 thumbnails,
applies EXIF orientation in cv2's layout, and raises on bad files.
`cli.train --dist` and `cli.eval --dist` form an NCCL world of one on the
card and give the runs without --dist (chip_smoke.py phase 4i (a)).
The demo: YOLOv3's maps and decoded boxes on the card within 1e-4 of the
CPU's float64; `PocoTester.run_on_image_folder` of tiny-cliff on the card
as on the CPU (one `skinning` launch a frame); the mesh rasterizer builds
under `_build/` and draws.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.eval.checks import equivariant_case, procrustes_f64
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.eval.metrics import pa_mpjpe, procrustes_align
from poco_tpu_torch.eval.runner import make_gendered_eval_step
from poco_tpu_torch.models.backbones.common import Bottleneck
from poco_tpu_torch.models.backbones.hrnet import HRNet
from poco_tpu_torch.models.backbones.resnet import ResNet
from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops.skinning import (
    skinning,
    skinning_backward,
    skinning_backward_reference,
    skinning_backward_simt,
    skinning_reference,
    skinning_simt,
)
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.smpl.lbs import smpl_forward
from poco_tpu_torch.utils.weights import calibrate_batchnorm, randomize_batchnorm

pytestmark = pytest.mark.gpu

ATOL = 1e-4
KERNELS = {"skinning": skinning, "skinning_simt": skinning_simt}
BACKWARD_KERNELS = {
    "skinning_backward": skinning_backward,
    "skinning_backward_simt": skinning_backward_simt,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(batch, num_verts, seed, device):
    rng = np.random.RandomState(seed)
    w = rng.rand(num_verts, 24).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    tfms = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 24, 4, 4)).copy()
    aa = torch.from_numpy((0.5 * rng.randn(batch * 24, 3)).astype(np.float32))
    tfms[:, :, :3, :3] = axis_angle_to_rotmat(aa).numpy().reshape(batch, 24, 3, 3)
    tfms[:, :, :3, 3] = 0.2 * rng.randn(batch, 24, 3)
    vp = rng.randn(batch, num_verts, 3).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (w, tfms, vp)]


@pytest.mark.parametrize(
    "batch,num_verts", [(128, 6890), (64, 6890), (16, 6890), (8, 6890), (3, 1001), (5, 1), (9, 257)]
)
def test_skinning_kernel_matches_plain(cuda, batch, num_verts):
    args = _inputs(batch, num_verts, seed=batch * num_verts, device=cuda)
    out = skinning(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 2, 31, 33, 128])
@pytest.mark.parametrize("num_verts", [1, 63, 64, 65, 127, 128, 129, 6890])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_match_plain_at_tile_edges(cuda, kernel, num_verts, batch):
    args = _inputs(batch, num_verts, seed=7 * batch + num_verts, device=cuda)
    out = KERNELS[kernel](*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=ATOL)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_take_any_float_alignment(cuda, kernel, offset):
    """Contiguous views that start 4, 8 or 12 bytes past a 16-byte line."""
    args = _inputs(5, 130, seed=offset, device=cuda)
    shifted = []
    for a in args:
        base = torch.empty(a.numel() + 4, device=cuda)
        view = base[offset:offset + a.numel()].view(a.shape)
        view.copy_(a)
        shifted.append(view)
    assert all(v.data_ptr() % 16 == 4 * offset for v in shifted)
    out = KERNELS[kernel](*shifted)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=ATOL)


def test_skinning_refuses_what_the_kernel_does_not_take(cuda):
    w, tfms, vp = _inputs(2, 64, seed=0, device=cuda)
    with pytest.raises(TypeError):
        skinning(w.double(), tfms, vp)
    with pytest.raises(ValueError, match="contiguous"):
        skinning(w, tfms, vp.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="one CUDA device"):
        skinning(w.cpu(), tfms, vp)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_refuse_inputs_that_need_a_gradient(cuda, kernel):
    """A gradient the kernels cannot give is an error, not a silently
    missing gradient: `skinning_simt` has no backward, so any input that
    needs one raises; `skinning` raises for skinning weights that need one
    (its backward covers the transforms and v_posed). Without autograd the
    same call runs."""
    w, tfms, vp = _inputs(2, 64, seed=3, device=cuda)
    (w if kernel == "skinning" else vp).requires_grad_(True)
    before = KERNELS[kernel].launches
    with pytest.raises(RuntimeError, match="no backward"):
        KERNELS[kernel](w, tfms, vp)
    assert KERNELS[kernel].launches == before
    with torch.no_grad():
        out = KERNELS[kernel](w, tfms, vp)
    torch.cuda.synchronize()
    assert KERNELS[kernel].launches == before + 1
    torch.testing.assert_close(
        out, skinning_reference(w.detach(), tfms, vp.detach()), rtol=0, atol=ATOL
    )


def _backward_close(got, ref):
    """Within 1e-5 x max |plain| + 1e-7 (fp32 sums over V in another order)."""
    bar = 1e-5 * float(ref.abs().max()) + 1e-7
    err = float((got - ref).abs().max())
    assert err <= bar, (err, bar)


def _backward_inputs(batch, num_verts, seed, device):
    w, tfms, vp = _inputs(batch, num_verts, seed=seed, device=device)
    g = torch.from_numpy(
        np.random.RandomState(seed + 1).randn(batch, num_verts, 3).astype(np.float32)
    ).to(device)
    return w, tfms, vp, g


def _check_backward(kernel, args, ref_args=None):
    """One launch, both gradients within the bar of the plain version on
    `ref_args` (default `args`), row 3 zero, and a second call
    bit-identical (no atomics)."""
    fn = BACKWARD_KERNELS[kernel]
    before = fn.launches
    gv, ga = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rv, ra = skinning_backward_reference(*(ref_args or args))
    _backward_close(gv, rv)
    _backward_close(ga, ra)
    assert bool((ga[:, :, 3] == 0).all())
    gv2, ga2 = fn(*args)
    assert torch.equal(gv, gv2) and torch.equal(ga, ga2)


# The batches the paths launch the kernels with, and the edges of both
# kernels' tiles: the 16-vertex warp slices and 128-vertex tiles of the
# 3xTF32 kernel, the 256-vertex chunks of the fp32-FMA one, odd sample
# counts (a pair with one sample) and groups of samples at 64 and 128.
BACKWARD_SHAPES = sorted(
    {(128, 6890), (64, 6890), (16, 6890), (8, 6890), (2, 6890), (1, 6890), (3, 1001)}
    | {(b, v) for b in (1, 2, 31, 33, 64, 128)
       for v in (1, 127, 128, 129, 255, 256, 257, 1001, 6890)}
)


@pytest.mark.parametrize("batch,num_verts", BACKWARD_SHAPES)
@pytest.mark.parametrize("kernel", sorted(BACKWARD_KERNELS))
def test_backward_kernel_matches_plain(cuda, kernel, batch, num_verts):
    _check_backward(kernel, _backward_inputs(batch, num_verts, 5 * batch + num_verts, cuda))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("kernel", sorted(BACKWARD_KERNELS))
def test_backward_kernels_take_any_float_alignment(cuda, kernel, offset):
    """Contiguous views that start 4, 8 or 12 bytes past a 16-byte line."""
    args = _backward_inputs(5, 300, seed=offset, device=cuda)
    shifted = []
    for a in args:
        base = torch.empty(a.numel() + 4, device=cuda)
        view = base[offset:offset + a.numel()].view(a.shape)
        view.copy_(a)
        shifted.append(view)
    assert all(v.data_ptr() % 16 == 4 * offset for v in shifted)
    _check_backward(kernel, shifted, ref_args=args)


def test_skinning_autograd_on_the_card_runs_the_backward_kernel(cuda):
    w, tfms, vp = _inputs(4, 6890, seed=11, device=cuda)
    tfms.requires_grad_(True)
    vp.requires_grad_(True)
    g = torch.randn(4, 6890, 3, device=cuda)
    fwd, bwd = skinning.launches, skinning_backward.launches
    bwd_simt = skinning_backward_simt.launches
    out = skinning(w, tfms, vp)
    ga, gv = torch.autograd.grad(out, (tfms, vp), g)
    torch.cuda.synchronize()
    assert (skinning.launches, skinning_backward.launches) == (fwd + 1, bwd + 1)
    assert skinning_backward_simt.launches == bwd_simt
    ra, rv = torch.autograd.grad(
        skinning_reference(w, tfms, vp), (tfms, vp), g
    )
    _backward_close(ga, ra)
    _backward_close(gv, rv)


@pytest.mark.parametrize("kernel", sorted(BACKWARD_KERNELS))
def test_backward_refuses_what_the_kernel_does_not_take(cuda, kernel):
    fn = BACKWARD_KERNELS[kernel]
    w, tfms, vp = _inputs(2, 64, seed=0, device=cuda)
    g = torch.randn(2, 64, 3, device=cuda)
    before = fn.launches
    with pytest.raises(TypeError):
        fn(w, tfms, vp, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        fn(w, tfms, vp, g.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="one CUDA device"):
        fn(w, tfms, vp, g.cpu())
    with pytest.raises(ValueError, match="expected"):
        fn(w, tfms, vp, g[:, :32].contiguous())
    assert fn.launches == before


def test_smpl_forward_launches_the_kernel_once(cuda):
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    rot = axis_angle_to_rotmat(0.3 * torch.randn(4, 24, 3, device=cuda))
    betas = torch.randn(4, 10, device=cuda)
    before = skinning.launches
    out = smpl_forward(smpl, betas, rot)
    torch.cuda.synchronize()
    assert skinning.launches == before + 1
    ref = smpl_forward(smpl.to("cpu"), betas.cpu(), rot.cpu())
    torch.testing.assert_close(out.vertices.cpu(), ref.vertices, rtol=0, atol=ATOL)


def test_main_path_launches_skinning_and_never_the_yardstick(cuda, monkeypatch):
    """`detect_forward` on a narrow POCO-CLIFF (HRNet width 8; every other
    module at full width, V=6890): one `skinning` launch per request, no
    `skinning_simt` launch."""
    monkeypatch.setitem(port_poco.BACKBONES, "hrnet_w48_cls", lambda: HRNet(width=8))
    torch.manual_seed(0)
    model = port_poco.build_poco_cliff(device=cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (240, 320, 3)).astype(np.uint8)
    centers = np.asarray([[160, 120], [40, 200], [300, 30]], np.float32)
    scales = np.asarray([1.1, 0.5, 0.8], np.float32)
    before, before_simt = skinning.launches, skinning_simt.launches
    for _ in range(2):
        out = detect_forward(model, smpl, image, centers, scales)
    torch.cuda.synchronize()
    assert skinning.launches == before + 2
    assert skinning_simt.launches == before_simt
    assert out["smpl_vertices"].shape == (3, 6890, 3)
    assert bool(torch.isfinite(out["smpl_vertices"]).all())


# Narrow backbones (every other module at full width, V=6890), by model
NARROW = {
    "cliff": ("hrnet_w48_cls", lambda: HRNet(width=8), port_poco.build_poco_cliff),
    "pare": (
        "hrnet_w32", lambda: HRNet(width=8, variant="pose"), port_poco.build_poco_pare
    ),
    "hmr": ("resnet50", lambda: ResNet(Bottleneck, (1, 1, 1, 1)), port_poco.build_hmr),
}


def _narrow(monkeypatch, kind, device):
    name, backbone, build = NARROW[kind]
    monkeypatch.setitem(port_poco.BACKBONES, name, backbone)
    torch.manual_seed(0)
    return build(device=device)


@pytest.mark.parametrize("kind", ["pare", "hmr"])
def test_pare_and_hmr_launch_skinning_once_per_request(cuda, monkeypatch, kind):
    model = _narrow(monkeypatch, kind, cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (240, 320, 3)).astype(np.uint8)
    centers = np.asarray([[160, 120], [40, 200]], np.float32)
    scales = np.asarray([1.1, 0.5], np.float32)
    before, before_simt = skinning.launches, skinning_simt.launches
    for _ in range(3):
        out = detect_forward(model, smpl, image, centers, scales)
    torch.cuda.synchronize()
    assert skinning.launches == before + 3
    assert skinning_simt.launches == before_simt
    assert out["smpl_vertices"].shape == (2, 6890, 3)
    assert "pred_fullimg_cam_t" not in out
    for key in ("smpl_vertices", "pred_pose", "pred_cam"):
        assert bool(torch.isfinite(out[key]).all()), key


@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_flow_forward_on_the_card_gives_finite_log_phi(cuda, monkeypatch, kind):
    model = _narrow(monkeypatch, kind, cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    batch = port_poco.make_dummy_batch(model.cfg, 4, include_gt=True, device=cuda)
    rot = axis_angle_to_rotmat(0.3 * torch.randn(4, 24, 3, device=cuda))
    batch.update(gt_pose_rotmat=rot, gt_pose_cond_mask=torch.arange(4, device=cuda) < 2)
    before = skinning.launches
    with torch.no_grad():
        out = model(batch, smpl)
    torch.cuda.synchronize()
    assert skinning.launches == before + 1
    assert out["log_phi"].shape == (4, 24)
    assert bool(torch.isfinite(out["log_phi"]).all())


def test_forward_with_autograd_raises_through_the_kernel_guard(cuda, monkeypatch):
    """Parameters that need a gradient and autograd on: the vertices carry
    the backward kernel (one launch on `backward()`); SMPL skinning
    weights that need a gradient raise at the kernel's guard instead."""
    model = _narrow(monkeypatch, "pare", cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    batch = port_poco.make_dummy_batch(model.cfg, 2, include_gt=False, device=cuda)
    assert all(p.requires_grad for p in model.parameters())
    fwd, bwd = skinning.launches, skinning_backward.launches
    out = model(batch, smpl)
    out["smpl_vertices"].square().sum().backward()
    torch.cuda.synchronize()
    assert (skinning.launches, skinning_backward.launches) == (fwd + 1, bwd + 1)
    assert any(p.grad is not None and bool(p.grad.any()) for p in model.head.parameters())
    smpl.lbs_weights.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        model(batch, smpl)
    assert skinning.launches == fwd + 1


def _eval_batch(seed, n, device):
    """An eval batch: normalized crops, CLIFF conditioning, GT pose and
    betas, every gender."""
    rng = np.random.RandomState(seed)
    center = rng.uniform(150, 450, (n, 2)).astype(np.float32)
    scale = rng.uniform(0.8, 1.6, n).astype(np.float32)
    orig = np.tile(np.asarray([[480.0, 640.0]], np.float32), (n, 1))
    focal = np.full(n, 800.0, np.float32)
    batch = {
        "img": rng.randn(n, 224, 224, 3), "center": center, "scale": scale,
        "orig_shape": orig, "focal_length": focal,
        "bbox_info": np.stack([(center[:, 0] - 320) / focal * 2.8,
                               (center[:, 1] - 240) / focal * 2.8,
                               (scale * 200 - 0.24 * focal) / (0.06 * focal)], 1),
        "pose": rng.uniform(-0.3, 0.3, (n, 72)), "betas": rng.uniform(-0.5, 0.5, (n, 10)),
    }
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}
    batch["gender"] = torch.tensor([-1, 0, 1] * n, dtype=torch.int32)[:n].to(device)
    return batch


@pytest.mark.parametrize("flip_test", [False, True])
def test_eval_step_on_the_card_matches_the_cpu(cuda, monkeypatch, flip_test):
    """The narrow POCO-CLIFF eval step on the card and on the CPU, same
    weights, three SMPLs (V=6890): per-sample mpjpe, pa_mpjpe, v2v within
    1e-4 m, var_pose within 2e-3, pose_dist within 1e-5; 5 skinning
    launches a batch, 7 with flip-TTA, and none of the yardstick."""
    cpu_model = _narrow(monkeypatch, "cliff", "cpu")
    randomize_batchnorm(cpu_model, torch.Generator().manual_seed(1))
    calibrate_batchnorm(
        cpu_model.backbone, torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(2))
    )
    model = _narrow(monkeypatch, "cliff", cuda)
    model.load_state_dict(cpu_model.state_dict())
    smpls = [synthetic_smpl_model(num_verts=6890, seed=s, device="cpu") for s in (0, 1, 2)]
    batch = _eval_batch(1, 4, "cpu")
    before, before_simt = skinning.launches, skinning_simt.launches
    card = make_gendered_eval_step(model, flip_test=flip_test)(
        {k: v.to(cuda) for k, v in batch.items()}, *[s.to(cuda) for s in smpls]
    )
    torch.cuda.synchronize()
    assert skinning.launches == before + (7 if flip_test else 5)
    assert skinning_simt.launches == before_simt
    cpu = make_gendered_eval_step(cpu_model, flip_test=flip_test)(batch, *smpls)
    tols = {"mpjpe": 1e-4, "pa_mpjpe": 1e-4, "v2v": 1e-4, "var_pose": 2e-3, "pose_dist": 1e-5}
    assert set(card) == set(cpu) == set(tols)
    for key, atol in tols.items():
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=0, atol=atol, msg=key)


@pytest.mark.parametrize("case", ["noisy", "reflected", "coplanar"])
def test_procrustes_on_the_card_matches_float64(cuda, case):
    """cuSOLVER's batched SVD gives other signs than LAPACK; the aligned
    joints must not care: within 1e-5 m of float64 numpy, at batch 256."""
    rng = np.random.RandomState(["noisy", "reflected", "coplanar"].index(case))
    gt = rng.randn(256, 14, 3).astype(np.float32)
    pred = gt + 0.1 * rng.randn(256, 14, 3).astype(np.float32)
    if case == "reflected":
        pred[..., 0] *= -1
    if case == "coplanar":
        pred[..., 2] = 0.3
    aligned = procrustes_align(torch.from_numpy(pred).to(cuda), torch.from_numpy(gt).to(cuda))
    np.testing.assert_allclose(aligned.cpu().numpy(), procrustes_f64(pred, gt), atol=1e-5)
    err = pa_mpjpe(torch.from_numpy(pred).to(cuda), torch.from_numpy(gt).to(cuda)).cpu()
    assert err.shape == (256,) and bool(torch.isfinite(err).all())


def test_flip_tta_of_an_equivariant_stub_on_the_card_is_exact(cuda):
    """A model that reports the pose its (possibly mirrored) image depicts
    (`checks.EquivariantStub`): flip-TTA must give the ground truth,
    mpjpe and v2v 0 within 1e-4."""
    stub, batch = equivariant_case(cuda, batch=4)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    m = make_gendered_eval_step(stub, flip_test=True)(batch, smpl, smpl, smpl)
    torch.testing.assert_close(m["mpjpe"].cpu(), torch.zeros(4), rtol=0, atol=1e-4)
    torch.testing.assert_close(m["v2v"].cpu(), torch.zeros(4), rtol=0, atol=1e-4)


def test_full_width_train_step_on_the_card(cuda):
    """One POCO-CLIFF train step at full width (HRNet-W48-cls, V=6890) at
    batch 4: finite loss terms and gradient norm, 2 forward and 1 backward
    skinning launches, and the head's weights moved."""
    from poco_tpu_torch.losses.losses import LossConfig
    from poco_tpu_torch.train.state import ModuleAdam
    from poco_tpu_torch.train.step import make_train_step

    torch.manual_seed(0)
    model = port_poco.build_poco_cliff(device=cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    batch = _eval_batch(5, 4, cuda)
    batch.update(
        has_smpl=torch.ones(4, device=cuda), has_pose_3d=torch.ones(4, device=cuda),
        keypoints_fullimg=torch.rand(4, 49, 3, device=cuda) * 400,
        gt_pose_cond_mask=torch.tensor([True, False, False, False], device=cuda),
    )
    optimizer = ModuleAdam(model, lr=1e-4)
    step = make_train_step(model, optimizer, LossConfig(keypoint2d_noncrop=True))
    before = model.head.fc1.weight.detach().clone()
    fwd, bwd = skinning.launches, skinning_backward.launches
    bwd_simt = skinning_backward_simt.launches
    metrics = step(batch, smpl)
    torch.cuda.synchronize()
    assert (skinning.launches - fwd, skinning_backward.launches - bwd) == (2, 1)
    assert skinning_backward_simt.launches == bwd_simt
    for key, value in metrics.items():
        if not key.startswith("_"):
            assert bool(torch.isfinite(value).all()), key
    assert not torch.equal(before, model.head.fc1.weight)


# --------------------------------------------------------------------------
# the image loader on the card's host (its nvJPEG route where the host has
# no libjpeg; the same checks hold the libjpeg route)
# --------------------------------------------------------------------------

SMOKE_DIR = Path(__file__).resolve().parents[1] / "data" / "dataset_folders" / "smoke"
THUMBS = Path(__file__).resolve().parent / "data" / "torch_smoke_thumbs.npz"

# cv2.imread's EXIF transforms (imgcodecs ExifTransform), as numpy
EXIF_LAYOUT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1],
}


def test_loader_decodes_the_smoke_jpegs_within_cv2s_thumbnails(cuda):
    """Each of the 48 smoke JPEGs against `cv2.imread`'s 16x16 area-mean
    thumbnail (tests/data/torch_smoke_thumbs.npz): within 2 grey levels,
    channel means within 0.5 (phase 4g's bars)."""
    from poco_tpu_torch.runtime import loader

    ref = np.load(THUMBS)
    for name, thumb, mean in zip(ref["names"], ref["thumbs"], ref["means"]):
        img = loader.decode_image(str(SMOKE_DIR / str(name))).astype(np.float64)
        got = img.reshape(16, img.shape[0] // 16, 16, img.shape[1] // 16, 3).mean(axis=(1, 3))
        assert np.abs(got - thumb).max() <= 2.0, name
        assert np.abs(img.mean(axis=(0, 1)) - mean).max() <= 0.5, name


@pytest.mark.parametrize("orientation", sorted(EXIF_LAYOUT))
def test_loader_applies_exif_orientation_on_the_card_host(cuda, tmp_path, orientation):
    """A smoke JPEG with an EXIF orientation tag spliced in decodes as its
    untagged bytes transposed and flipped the way cv2.imread does, in the
    single and the batch path."""
    from poco_tpu_torch.runtime import loader

    plain = (SMOKE_DIR / "test_0003.jpg").read_bytes()
    tiff = (b"II*\x00\x08\x00\x00\x00" + b"\x01\x00"
            + b"\x12\x01\x03\x00\x01\x00\x00\x00" + bytes([orientation, 0, 0, 0])
            + b"\x00\x00\x00\x00")
    payload = b"Exif\x00\x00" + tiff
    tagged = plain[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload + plain[2:]
    path = tmp_path / "tagged.jpg"
    path.write_bytes(tagged)
    got = loader.decode_image(str(path))
    np.testing.assert_array_equal(got, EXIF_LAYOUT[orientation](loader.decode_image(plain)))
    affine = np.array([[[1.0, 0.2, 3.0], [-0.1, 1.0, 5.0]]], np.float32)
    crops, dims = loader.batch_decode_affine([str(path)], affine, np.ones((1, 3)), 32)
    assert tuple(dims[0]) == got.shape[:2]
    np.testing.assert_array_equal(crops[0], loader.affine_warp(got, affine[0], out_res=32))


def test_loader_raises_on_bad_files_on_the_card_host(cuda, tmp_path):
    from poco_tpu_torch.runtime import loader

    truncated = tmp_path / "truncated.jpg"
    truncated.write_bytes((SMOKE_DIR / "test_0000.jpg").read_bytes()[:300])
    with pytest.raises(ValueError, match="truncated.jpg"):
        loader.decode_image(str(truncated))
    with pytest.raises(ValueError, match="unsupported format"):
        loader.decode_image(b"not an image")
    with pytest.raises(ValueError, match=r"missing\.jpg: unreadable file"):
        loader.batch_decode_affine([str(tmp_path / "missing.jpg")], np.zeros((1, 2, 3)),
                                   np.ones((1, 3)), 8)


# --------------------------------------------------------------------------
# export and serving on the card
# --------------------------------------------------------------------------

SERVED_METERS_TOL = 1e-6  # joints and vertices, exported program vs eager, m
SERVED_HEAD_TOL = 1e-5    # every other output, absolute and relative (pixels near 1e3):
                          # the same kernels in the same order


@pytest.fixture(scope="module")
def exported_cliff(tmp_path_factory):
    """The narrow POCO-CLIFF (V=6890) exported on the card with buckets
    (1, 4) and uint8 input, loaded back, and its eager model and SMPL
    (one export for the module: tracing takes tens of seconds)."""
    from poco_tpu_torch.runtime.export import export_poco, load_exported

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with pytest.MonkeyPatch.context() as mp:
        model = _narrow(mp, "cliff", "cuda")
    randomize_batchnorm(model, torch.Generator().manual_seed(1))
    calibrate_batchnorm(model.backbone, torch.randn(4, 3, 224, 224, device="cuda"))
    smpl = synthetic_smpl_model(num_verts=6890, device="cuda")
    out = str(tmp_path_factory.mktemp("exported") / "cliff")
    export_poco(model, smpl, out, batch_sizes=(1, 4), uint8_input=True, device="cuda")
    return model, smpl, load_exported(out)


def _served_batch(n, seed):
    rng = np.random.RandomState(seed)
    return {
        "img": rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8),
        "bbox_info": (0.3 * rng.randn(n, 3)).astype(np.float32),
        "focal_length": rng.uniform(800, 1600, n).astype(np.float32),
        "scale": rng.uniform(0.5, 2.0, n).astype(np.float32),
        "center": rng.uniform(200, 800, (n, 2)).astype(np.float32),
        "orig_shape": np.tile(np.asarray([[1080.0, 1920.0]], np.float32), (n, 1)),
    }


def test_export_on_the_card_calls_the_skinning_op(exported_cliff):
    """The program traced on the card keeps the custom op: the wrapper's
    fake-tensor trace never reached `data_ptr`, and the loaded graph has
    one `poco_tpu_torch.skinning` call and no plain blend."""
    _, _, loaded = exported_cliff
    assert loaded.meta["device"] == "cuda"
    targets = [
        str(node.target)
        for module in loaded._program.modules() if isinstance(module, torch.fx.GraphModule)
        for node in module.graph.nodes if node.op == "call_function"
    ]
    assert targets.count("poco_tpu_torch.skinning.default") == 1


def test_exported_program_launches_skinning_once_per_bucket_dispatch(exported_cliff):
    """3 crops pad into the 4-bucket (one launch); 9 chunk into 4+4+1
    (three launches); the yardstick never runs."""
    _, _, loaded = exported_cliff
    for n, dispatches in ((3, 1), (9, 3)):
        before, before_simt = skinning.launches, skinning_simt.launches
        out = loaded.predict(_served_batch(n, seed=n))
        assert skinning.launches == before + dispatches
        assert skinning_simt.launches == before_simt
        assert out["smpl_vertices"].shape == (n, 6890, 3)
        assert all(np.isfinite(v).all() for v in out.values())


def test_exported_program_matches_eager_on_the_card(exported_cliff):
    """The program against `model(batch, smpl)` on the same crops (the
    uint8 crops normalized as the program does), at a bucket's size:
    joints and vertices within 1e-6 m, every other output within 1e-5
    absolute and relative."""
    from poco_tpu_torch.ops.preprocess import normalize_image

    model, smpl, loaded = exported_cliff
    batch = _served_batch(4, seed=7)
    got = loaded.predict(batch)
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    tb["img"] = normalize_image(tb["img"].float())
    with torch.inference_mode():
        want = {k: v.cpu().numpy() for k, v in model(tb, smpl).items() if v is not None}
    assert sorted(got) == sorted(want)
    for key in want:
        if key in ("smpl_vertices", "smpl_joints3d"):
            np.testing.assert_allclose(got[key], want[key], atol=SERVED_METERS_TOL, rtol=0,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], atol=SERVED_HEAD_TOL,
                                       rtol=SERVED_HEAD_TOL, err_msg=key)


# --------------------------------------------------------------------------
# multi-process: --dist in an NCCL world of one (chip_smoke.py phase 4i (a))
# --------------------------------------------------------------------------

@pytest.fixture
def torchrun_world_of_one(monkeypatch):
    """torchrun's environment for one process on a free localhost port."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_cli_dist_forms_an_nccl_world_of_one(cuda, torchrun_world_of_one, monkeypatch, tmp_path,
                                            capsys, cli):
    """`cli.train --dist` / `cli.eval --dist` of tiny_smoke on the card
    form an NCCL world (rank 0 of 1), leave no process group behind, and
    give the run without --dist: per-step losses, or the report's mpjpe,
    pa_mpjpe and v2v, within rtol 2e-4."""
    import json

    from poco_tpu_torch.cli import eval as eval_cli
    from poco_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(Path(__file__).resolve().parents[1])
    results = {}
    for label, extra in (("plain", []), ("dist", ["--dist"])):
        if cli == "train":
            logdir = tmp_path / label
            train_cli.main(["--cfg", "configs/tiny_smoke.yaml", "--logdir", str(logdir),
                            "--max_epochs", "1", *extra])
            with open(logdir / "metrics.jsonl") as f:
                rows = [json.loads(line) for line in f]
            results[label] = [r["loss/total_loss"] for r in rows
                              if "step" in r and "loss/total_loss" in r]
        else:
            report = eval_cli.main(["--cfg", "configs/tiny_smoke.yaml", "--dataset", "smoke",
                                    "--batch_size", "8", *extra])
            results[label] = [report["summary"][k] for k in ("mpjpe", "pa_mpjpe", "v2v")]
        out = capsys.readouterr().out
        assert ("world: rank 0 of 1 (backend nccl)" in out) == (label == "dist")
        assert not torch.distributed.is_initialized()
    assert len(results["plain"]) > 0
    np.testing.assert_allclose(results["dist"], results["plain"], rtol=2e-4)


# --------------------------------------------------------------------------
# the demo (chip_smoke.py phase 4j at full width)
# --------------------------------------------------------------------------

def test_yolo_forward_on_the_card_matches_the_cpu(cuda):
    """YOLOv3 at width 4, 3 classes, 64 px: the card's fp32 maps and
    decoded boxes within 1e-4 of the CPU's float64 ones."""
    from poco_tpu_torch.demo import yolo

    torch.manual_seed(0)
    model = yolo.YoloV3(width=4, num_classes=3).eval()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = model.double()(x.double())
        got = model.float().to(cuda)(x.to(cuda))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().double().numpy(), r.numpy(), atol=1e-4, rtol=0)
        boxes, scores = yolo.decode_predictions(g, yolo.YOLO_ANCHORS[0], 32, 3)
        ref_boxes, ref_scores = yolo.decode_predictions(r.float(), yolo.YOLO_ANCHORS[0], 32, 3)
        np.testing.assert_allclose(scores.cpu().numpy(), ref_scores.numpy(), atol=1e-4)
        np.testing.assert_allclose(boxes.cpu().numpy(), ref_boxes.numpy(), atol=1e-3, rtol=1e-4)


def test_tester_folder_on_the_card_matches_the_cpu(cuda, tmp_path):
    """`PocoTester.run_on_image_folder` of tiny-cliff (V=96) over three
    smoke JPEGs, card vs CPU: the fp16-rounded vertices within 1e-4 m +
    one fp16 ulp, cameras and uncertainty within 2e-3; one `skinning`
    launch a frame; a PNG of twice the input's width with the side view."""
    import shutil

    from poco_tpu_torch.demo.tester import PocoTester

    folder = tmp_path / "images"
    folder.mkdir()
    for p in sorted((Path(__file__).resolve().parents[1] / "data" / "dataset_folders"
                     / "smoke").glob("*.jpg"))[:3]:
        shutil.copy(p, folder)
    torch.manual_seed(0)
    model = port_poco.POCO(port_poco.PocoConfig(backbone="tiny-cliff", num_neurons=(216,),
                                                context_dim=64)).eval()
    runs = {}
    for device in ("cpu", "cuda"):
        tester = PocoTester(copy_to(model, device), synthetic_smpl_model(num_verts=96,
                                                                         device=device))
        skinning.launches = 0
        runs[device] = tester.run_on_image_folder(str(folder), str(tmp_path / device),
                                                  sideview=True)
        if device == "cuda":
            assert skinning.launches == 3
    for got, ref in zip(runs["cuda"], runs["cpu"]):
        ulp = np.spacing(np.abs(ref["verts"]).astype(np.float16)).astype(np.float32)
        assert (np.abs(got["verts"] - ref["verts"]) <= 1e-4 + ulp).all()
        for key in ("orig_cam", "var", "var_global", "betas"):
            np.testing.assert_allclose(got[key], ref[key], atol=2e-3, rtol=2e-3)
    from poco_tpu_torch.runtime.loader import decode_image

    written = sorted((tmp_path / "cuda").glob("*.jpg"))   # each input's own name and format
    assert len(written) == 3 and decode_image(str(written[0])).shape[1] == 512


def copy_to(model, device):
    import copy

    return copy.deepcopy(model).to(device)


def test_rasterizer_builds_under_build_and_draws(cuda):
    from poco_tpu_torch.runtime import raster

    path = raster.build()
    assert path.parent.name == "_build" and path.parent.parent.name == "poco_tpu_torch"
    uv = np.array([[2.0, 2.0], [30.0, 4.0], [10.0, 28.0]], np.float32)
    out = raster.raster_mesh(np.zeros((32, 32, 3), np.float32), uv, np.ones(1, np.float32),
                             np.array([[0, 1, 2]]), np.full((1, 3), 200.0, np.float32),
                             np.ones(1, bool))
    assert (out[..., 0] == 200).sum() > 100 and out[0, 31, 0] == 0


def test_soft_raster_on_the_card_matches_the_cpu(cuda):
    """The soft rasterizer's silhouette, part probabilities and vertex
    gradient on the card against the CPU (fp32 both, TF32 off), and its
    refusal to run with TF32 matmuls."""
    from poco_tpu_torch.ops import soft_raster

    smpl = synthetic_smpl_model(num_verts=6890, device="cpu")
    g = torch.Generator().manual_seed(0)
    verts = 0.5 * smpl.v_template[None].repeat(2, 1, 1) + 0.02 * torch.randn(2, 6890, 3,
                                                                             generator=g)
    cam = torch.tensor([[0.9, 0.0, 0.0], [1.1, 0.05, -0.1]])
    out = {}
    for device in ("cpu", "cuda"):
        v = verts.detach().to(device).requires_grad_()
        sil = soft_raster.soft_silhouette(v, cam.to(device))
        probs = soft_raster.soft_part_probs(v, cam.to(device), smpl.lbs_weights.to(device))
        (sil.sum() + probs[..., 5].sum()).backward()
        out[device] = [t.detach().cpu() for t in (sil, probs, v.grad)]
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        assert (got - want).abs().max() <= 1e-5
    grad_c, grad = out["cpu"][2], out["cuda"][2]
    assert (grad - grad_c).norm() <= 1e-4 * grad_c.norm()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            soft_raster.soft_silhouette(verts.cuda(), cam.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_jpeg_encoder_round_trip_on_the_card_host(cuda, tmp_path):
    """`write_image` to .jpg on the route the host builds (nvJPEG on the
    card's host): the file decodes to the frame within 35 dB PSNR."""
    from poco_tpu_torch.runtime.image_write import write_image
    from poco_tpu_torch.runtime.loader import decode_image

    y, x = np.mgrid[0:240, 0:320] / 40.0
    frame = np.stack([127 + 100 * np.sin(x), 127 + 100 * np.cos(y), 127 + 60 * np.sin(x + y)],
                     axis=-1).astype(np.uint8)
    write_image(str(tmp_path / "x.jpg"), frame)
    back = decode_image(str(tmp_path / "x.jpg")).astype(np.float64)
    assert back.shape == frame.shape
    assert 10 * np.log10(255.0**2 / np.mean((back - frame) ** 2)) >= 35.0
