"""HMR 2.0 on the port (`vit_h-hmr2`: `models/backbones/vit.py`,
`models/heads/hmr2.py`) against the benchmark's plain reference
(`gpubench/reference/vit.py`, `hmr2.py`, written from 4DHumans' code) on
seeded random weights at a small size on the CPU: a ViT of width 64, 2
blocks, 4 heads on a 64 x 48 input, and a decoder of 2 layers (width 32,
2 heads of 16). The trunk alone, the head alone, and the whole model
through `detect_forward` on a frame with 4 boxes (a 64-px crop, cut to its
centre 48 columns).

Tolerances: the port and the reference compute the same fp32 products in
another order (SDPA against softmax(q k^T) v written out; one fused
residual against two adds), which moves an output by a few fp32 ulps of
its own scale through 2 blocks, and the 6D Gram-Schmidt of the pose
magnifies that: measured gaps reach 4.5e-6 of an output's largest value
(the pose) and 8.5e-6 m on the mesh. Each output is held to TOL = 3e-5 of
that scale (relative), and the mesh to 3e-5 m. The port's products in
bf16 (8 bits of mantissa, the autocast region `compute_precision` opens)
miss each by over thirty times (3.5e-3 to 0.15 measured; a control in
every case).

Also: the 224-px request path of the other models is bitwise what it was
(the crop follows `model.cfg.img_res`, 224 for them); `configs/hmr2_vith.yaml`
builds HMR 2.0 through `config.py`; `build_hmr2` has HMR 2.0's 670 M
parameters at full width (on the meta device); the reference imports
nothing of JAX, the JAX package or the port; a request opens one
`poco/vit_attention` and one `poco/vit_mlp` span a block."""

from __future__ import annotations

import ast
import collections
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.demo.tester import PocoTester, detect_forward
from poco_tpu_torch.models import poco as port_poco
from poco_tpu_torch.models.backbones.vit import ViT
from poco_tpu_torch.models.heads.hmr2 import IDENTITY_6D, Hmr2Head, rot6d_to_rotmat
from poco_tpu_torch.ops.preprocess import preprocess_crops
from poco_tpu_torch.smpl.assets import load_smpl_model, synthetic_smpl_model
from poco_tpu_torch.utils import spans

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "gpubench"))
from bench import synth  # noqa: E402
from reference import hmr2 as ref_hmr2  # noqa: E402
from reference.preprocess import preprocess_crops as ref_preprocess  # noqa: E402
from reference.train import smpl_from_arrays  # noqa: E402
from reference.vit import ViT as RefViT  # noqa: E402

sys.path.remove(str(REPO / "gpubench"))

TRUNK = {"img_size": (64, 48), "patch_size": 16, "embed_dim": 64, "depth": 2, "num_heads": 4,
         "mlp_ratio": 4}
DECODER = {"dim": 32, "depth": 2, "heads": 2, "dim_head": 16, "mlp_dim": 32}
CONFIG = dict(backbone="vit_tiny-hmr2", img_res=64, uncert_layer="", loss_ver="mse",
              gt_pose_cond=False)
TOL = 3e-5        # relative to each output's largest value (see the module's docstring)
MESH_TOL = 3e-5   # metres


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize(module: torch.nn.Module, seed: int) -> None:
    """Every parameter drawn anew: matrices U(+-sqrt(3 / fan_in)), vectors
    U(+-0.5) (LayerNorm gains about 1), so no bias or gain is trivial."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            u = torch.rand(p.shape, generator=gen) * 2 - 1
            if p.dim() >= 2 and "pos" not in name:
                p.copy_(u * (3.0 / p[0].numel()) ** 0.5)
            else:
                p.copy_(0.5 * u + (1.0 if "norm" in name and name.endswith("weight") else 0.0))


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def ref_trunk() -> RefViT:
    model = RefViT(**TRUNK).eval()
    randomize(model, 1)
    return model


def ref_head() -> ref_hmr2.Hmr2Head:
    model = ref_hmr2.Hmr2Head(context_dim=TRUNK["embed_dim"], **DECODER).eval()
    randomize(model, 2)
    return model


def port_of(reference: torch.nn.Module, port: torch.nn.Module) -> torch.nn.Module:
    port.load_state_dict(reference.state_dict())
    return port.eval()


def bf16(run):
    """`run()` with the port's products in bf16."""
    with port_poco.compute_precision("cpu", torch.bfloat16):
        return run()


@pytest.fixture
def tiny_registry(monkeypatch):
    """`vit_tiny` (TRUNK) in the port's registry, the port's head at DECODER."""
    monkeypatch.setitem(port_poco.BACKBONES, "vit_tiny", lambda: ViT(**TRUNK))
    monkeypatch.setattr(port_poco, "Hmr2Head", functools.partial(Hmr2Head, **DECODER))


def case_trunk(_):
    ref = ref_trunk()
    port = port_of(ref, ViT(**TRUNK))
    x = torch.randn(3, 3, 64, 48, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, got = ref(x), port(x)
        low = bf16(lambda: port(x)).float()
    assert got.shape == want.shape == (3, 64, 4, 3)
    return [("features", got, want, low)]


def case_head(_):
    ref = ref_head()
    port = port_of(ref, Hmr2Head(context_dim=TRUNK["embed_dim"], **DECODER))
    features = torch.randn(3, 64, 4, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        rotmat, betas, cam = ref(features)
        got = port(features)
        low = bf16(lambda: port(features))
    return [(key, got[key], want, low[key].float()) for key, want in
            (("pred_pose", rotmat), ("pred_shape", betas), ("pred_cam", cam))]


def request(seed: int = 5, boxes: int = 4):
    rng = np.random.RandomState(seed)
    frame = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    centers = rng.uniform(40, 100, (boxes, 2)).astype(np.float32)
    scales = rng.uniform(0.3, 0.6, boxes).astype(np.float32)
    return frame, centers, scales


def case_model(tmp_path):
    ref = ref_hmr2.HMR2(synth.ref_config(CONFIG), TRUNK, DECODER).eval()
    randomize(ref, 6)
    port = port_of(ref, port_poco.POCO(port_poco.PocoConfig(**CONFIG)))
    arrays = synth.smpl_arrays(synth.generator(7, "cpu"), "cpu", 6890, 13776)
    smpl = load_smpl_model(*synth.write_smpl_files(arrays, str(tmp_path)), device="cpu")
    frame, centers, scales = request()
    got = detect_forward(port, smpl, frame, centers, scales)
    low = bf16(lambda: detect_forward(port, smpl, frame, centers, scales))
    with torch.no_grad():
        batch = ref_preprocess(*(torch.from_numpy(x) for x in (frame, centers, scales)),
                               out_res=CONFIG["img_res"])
        want = ref(batch, smpl_from_arrays(arrays))
    assert set(want) <= set(got) and got["smpl_vertices"].shape == (4, 6890, 3)
    return [(key, got[key], want[key], low[key].float()) for key in want]


@pytest.mark.parametrize("case", [case_trunk, case_head, case_model],
                         ids=["trunk", "head", "model"])
def test_port_matches_the_reference(case, tiny_registry, tmp_path):
    for key, got, want, low in case(tmp_path):
        assert got.shape == want.shape, key
        if key in ("smpl_vertices", "smpl_joints3d"):
            assert float((got - want).norm(dim=-1).max()) < MESH_TOL, key
            assert float((low - want).norm(dim=-1).max()) > 30 * MESH_TOL, key
        else:
            assert gap(got, want) < TOL, (key, gap(got, want))
            assert gap(low, want) > 30 * TOL, (key, gap(low, want))


def test_rot6d_layout_is_hmr2s():
    """HMR 2.0's 6D rows: the identity is [1, 0, 0, 0, 1, 0] (SPIN's
    column pair would read [1, 0, 0, 1, 0, 0]); port and reference agree."""
    x = torch.randn(50, 6, generator=torch.Generator().manual_seed(8))
    assert torch.allclose(rot6d_to_rotmat(x), ref_hmr2.rot6d_to_rotmat(x), atol=1e-6)
    eye = rot6d_to_rotmat(torch.from_numpy(IDENTITY_6D))
    assert torch.equal(eye, torch.eye(3)[None])
    head = Hmr2Head(context_dim=8, **DECODER)
    assert torch.equal(head.init_body_pose, torch.from_numpy(np.tile(IDENTITY_6D, 24))[None])


@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_224_px_request_is_bitwise_as_before(kind):
    """POCO-CLIFF and POCO-PARE (tiny trunks): `detect_forward`, whose crop
    now follows `model.cfg.img_res`, against the request as it was made
    (`preprocess_crops` at its default 224 px), every output bitwise; the
    tester maps 2D joints back at 224 px, as before."""
    backbone = {"cliff": "tiny-cliff", "pare": "tiny_pose-pare"}[kind]
    torch.manual_seed(0)
    model = port_poco.POCO(port_poco.PocoConfig(backbone=backbone, num_neurons=(64,),
                                                context_dim=64)).eval()
    smpl = synthetic_smpl_model(num_verts=96, device="cpu")
    frame, centers, scales = request(9, boxes=3)
    got = detect_forward(model, smpl, frame, centers, scales)
    with torch.inference_mode():
        want = model(preprocess_crops(*(torch.from_numpy(x) for x in (frame, centers, scales))),
                     smpl)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert (got[key] is None if value is None else torch.equal(got[key], value)), key
    assert model.cfg.img_res == 224 and PocoTester(model, smpl).img_res == 224


def test_yaml_builds_hmr2():
    cfg = model_config_from_hparams(update_hparams(str(REPO / "configs" / "hmr2_vith.yaml")))
    assert (cfg.backbone, cfg.img_res) == ("vit_h-hmr2", 256)
    assert not cfg.has_uncert_head and not cfg.has_flow_head
    with torch.device("meta"):
        built = port_poco.build_hmr2(device="meta")
    assert built.cfg == cfg
    spin = model_config_from_hparams(update_hparams(str(REPO / "configs" / "spin_hmr.yaml")))
    assert (spin.backbone, spin.img_res) == ("resnet50-hmr", 224)


def test_build_hmr2_has_the_published_size():
    """At full width: 32 blocks of 1280 (16 heads, MLP 5120) on a 16 x 12
    grid, 630.9 M parameters; 6 decoder layers of 1024 (8 heads of 64)
    cross-attending to 1280, 39.5 M; 670.5 M in all."""
    with torch.device("meta"):
        model = port_poco.build_hmr2(device="meta")
    trunk, head = model.backbone, model.head
    assert len(trunk.blocks) == 32 and trunk.pos_embed.shape == (1, 16 * 12 + 1, 1280)
    block = trunk.blocks[0]
    assert block.attn.num_heads == 16 and block.mlp.fc1.weight.shape == (5120, 1280)
    layers = head.transformer.transformer.layers
    assert len(layers) == 6 and layers[0][1].fn.to_kv.weight.shape == (1024, 1280)
    assert layers[0][0].fn.heads == 8 and layers[0][0].fn.to_qkv.weight.shape == (3 * 512, 1024)

    def count(m):
        return sum(p.numel() for p in m.parameters())

    assert (count(trunk), count(head), count(model)) == (630_912_000, 39_547_037, 670_459_037)
    assert not hasattr(model, "uncert_head") and not hasattr(model, "flow_head")


def test_reference_imports_nothing_of_jax_or_the_port():
    for name in ("vit.py", "hmr2.py"):
        tree = ast.parse((REPO / "gpubench" / "reference" / name).read_text())
        top = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                top.add(node.module.split(".")[0])
        assert top <= {"__future__", "torch"}, (name, top)


def test_request_opens_a_span_pair_a_block(tiny_registry):
    port = port_poco.POCO(port_poco.PocoConfig(**CONFIG)).eval()
    smpl = synthetic_smpl_model(num_verts=96, device="cpu")
    with spans.recording() as records:
        detect_forward(port, smpl, *request())
    by_id = {r.id: r for r in records}
    inside = collections.Counter((r.name, by_id[r.parent].name) for r in records
                                 if r.name in (spans.VIT_ATTENTION, spans.VIT_MLP))
    assert inside == {(spans.VIT_ATTENTION, spans.BACKBONE): 2, (spans.VIT_MLP, spans.BACKBONE): 2}
    assert not spans.names()[spans.VIT_ATTENTION] and not spans.names()[spans.VIT_MLP]
