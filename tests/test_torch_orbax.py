"""`tools/orbax_to_torch.py`: a JAX trainer checkpoint (orbax) into the
PyTorch port's.

The JAX `Trainer` fits tiny-cliff (V=96 synthetic SMPL, batch 8) for one
step and saves `last` as orbax; the tool converts it. Against the JAX
package on the CPU:
  * the port's forward on the converted weights against JAX's on the saved
    ones: head outputs within atol 2e-3, joints within 1e-4 m;
  * the resumed next step (dropout all-keep on both sides, another batch):
    the port's `Trainer.load_checkpoint` of the converted file and one
    step against JAX's `load_checkpoint` of the orbax directory and one
    step: the loss terms within 1e-3 relative; the weights' update within
    5e-2 relative L2 of JAX's, where a fresh Adam's update (the moments
    not carried over) is shown to miss it by more than 0.3;
  * the trackers and the step carried over; an optimizer state of another
    layout refused.
"""

import json
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.config import get_hparams_defaults as jax_hparams_defaults
from poco_tpu.parallel.mesh import replicate_tree
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu.train.trainer import Trainer as JaxTrainer

from poco_tpu_torch.config import get_hparams_defaults
from poco_tpu_torch.data.dataset import collate
from poco_tpu_torch.models import layers
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.train.trainer import Trainer

from .test_torch_model import REPO
from .test_torch_trainer import _ArrayDataset

HEAD_TOL, JOINT_TOL = 2e-3, 1e-4
LOSS_RTOL = 1e-3
UPDATE_RTOL, FRESH_MISS = 5e-2, 0.3

tool = runpy.run_path(str(REPO / "tools" / "orbax_to_torch.py"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(h, logdir):
    h.LOG_DIR = str(logdir)
    h.METHOD = "poco"
    h.SEED_VALUE = 0
    h.POCO.BACKBONE = "tiny-cliff"
    h.POCO.NUM_NEURONS = "216-"
    h.POCO.SIGMA_DIM = 1
    h.POCO.UNCERT_INP_TYPE = "feat-pose-net"
    h.POCO.COND_NFLOW = True
    h.POCO.CONTEXT_DIM = 64
    h.POCO.NUM_FLOW_LAYERS = 1
    h.POCO.GT_POSE_COND = True
    h.POCO.KEYPOINT_2D_NONCROP = True
    h.DATASET.BATCH_SIZE = 8
    h.TRAINING.MAX_EPOCHS = 1
    h.TRAINING.LOG_SAVE_INTERVAL = 1
    return h


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    data = _ArrayDataset(n=8, seed=3, names=("h36m", "coco"))
    jax_trainer = JaxTrainer(_tiny(jax_hparams_defaults(), root / "jax"),
                             jax_synthetic_smpl(num_verts=96), train_dataset_fn=lambda e: data)
    jax_trainer.fit(max_epochs=1)
    summary = tool["convert"](str(root / "jax" / "last"),
                              _tiny(get_hparams_defaults(), root / "port"),
                              str(root / "port" / "last"))
    return root, jax_trainer, summary


def _port_trainer(root):
    return Trainer(_tiny(get_hparams_defaults(), root / "port"),
                   synthetic_smpl_model(num_verts=96, device="cpu"),
                   train_dataset_fn=lambda e: None, device="cpu")


def test_converted_forward_matches_jax(converted):
    root, jax_trainer, summary = converted
    assert summary["step"] == 1 and summary["adam_count"] == 1
    trainer = _port_trainer(root)
    trainer.load_checkpoint(str(root / "port" / "last"))
    trainer.close()
    host = collate([_ArrayDataset(n=4, seed=5)[i] for i in range(4)])
    batch = trainer._device_batch(host)
    trainer.model.eval()
    with torch.no_grad():
        got = trainer.model(batch, trainer.smpl)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = jax_trainer.model.apply(jax_trainer.state.variables, jbatch, jax_trainer.smpl,
                                   train=False)
    for key in ("pred_pose", "pred_shape", "pred_cam", "var_pose"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=HEAD_TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["smpl_joints3d"].numpy(), np.asarray(want["smpl_joints3d"]),
                               atol=JOINT_TOL)


def test_resumed_step_matches_jax(converted, monkeypatch):
    root, _, _ = converted
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(layers, "dropout_keep_mask",
                        lambda x, keep: torch.ones_like(x, dtype=torch.bool))
    host = collate([_ArrayDataset(n=8, seed=7, names=("h36m", "coco"))[i] for i in range(8)])

    jax_trainer = JaxTrainer(_tiny(jax_hparams_defaults(), root / "jax2"),
                             jax_synthetic_smpl(num_verts=96), train_dataset_fn=lambda e: None)
    jax_trainer.load_checkpoint(str(root / "jax" / "last"))
    with jax_trainer.mesh:
        state = replicate_tree(jax_trainer.state, jax_trainer.mesh)
        smpl = replicate_tree(jax_trainer.smpl, jax_trainer.mesh)
        before = jax.tree.map(np.array, state.params)
        new_state, jax_metrics = jax_trainer.train_step(
            state, jax_trainer._device_batch(dict(host)), smpl, jax.random.PRNGKey(0))
        jax_metrics = {k: float(v) for k, v in jax_metrics.items() if k.startswith("loss/")}
        jax_delta = jax.tree.map(lambda a, b: np.asarray(a) - b, new_state.params, before)

    def port_step(load: bool):
        trainer = _port_trainer(root)
        if load:
            trainer.load_checkpoint(str(root / "port" / "last"))
        else:  # the weights alone: a fresh Adam
            from poco_tpu_torch.utils.checkpoint import load_checkpoint_into

            load_checkpoint_into(trainer.model, str(root / "port" / "last.pt"))
        trainer.close()
        params = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
        metrics = trainer.train_step(trainer._device_batch(dict(host)), trainer.smpl)
        delta = {k: p.detach() - params[k] for k, p in trainer.model.named_parameters()}
        return trainer, {k: float(v) for k, v in metrics.items() if k.startswith("loss/")}, delta

    trainer, metrics, delta = port_step(load=True)
    assert trainer.epoch == 1 and trainer.step == 1
    assert set(metrics) == set(jax_metrics)
    for key, want in jax_metrics.items():
        np.testing.assert_allclose(metrics[key], want, rtol=LOSS_RTOL, atol=1e-7, err_msg=key)

    from poco_tpu_torch.utils.weights import state_dict_from_jax

    want = state_dict_from_jax({"params": jax_delta})
    flat = torch.cat([want[k].reshape(-1) for k in delta])

    def rel(d):
        return float((torch.cat([d[k].reshape(-1) for k in d]) - flat).norm() / flat.norm())

    assert rel(delta) <= UPDATE_RTOL, rel(delta)
    _, _, fresh = port_step(load=False)
    assert rel(fresh) >= FRESH_MISS, rel(fresh)


def test_sidecar_and_refusals(converted, tmp_path):
    root, jax_trainer, _ = converted
    with open(root / "jax" / "last.trainer.json") as f:
        theirs = json.load(f)
    with open(root / "port" / "last.trainer.json") as f:
        ours = json.load(f)
    assert ours["rng"] is None
    for key in tool["SIDECAR_KEYS"]:
        assert ours[key] == theirs[key], key
    payload = torch.load(root / "port" / "last.pt", weights_only=False)
    assert payload["step"] == 1 and payload["optimizer"]["groups"]
    with pytest.raises(ValueError, match="fused Adam"):
        tool["_adam_moments"]({"mu": {}, "nu": {}}, {})
    from poco_tpu_torch.utils.checkpoint import load_torch_checkpoint

    with pytest.raises(ValueError, match="orbax_to_torch"):
        load_torch_checkpoint(str(root / "jax" / "last"))
