"""Experiment configuration: the hparams tree, YAML merge, grid search,
and the bridges to the model, loss and optimizer settings.

Port of `poco_tpu.config`: the same key tree (general / DATASET /
OPTIMIZER / TRAINING / TESTING / SPIN / POCO, reference
pocolib/core/config.py:84-229), YAML files merged over the defaults with
unknown keys refused, the grid-search expansion where a list-valued YAML
leaf is a sweep axis (`--cfg_id` picks one experiment, config.py:251-332),
the dataset-file registry, and the bridges: `model_config_from_hparams`
(the port's `PocoConfig`), `loss_config_from_hparams` (`LossConfig`),
`parse_module_lr` and `parse_freeze_params`, which name the port's
modules `backbone`, `head`, `uncert_head` and `flow_head`.
"""

from __future__ import annotations

import copy
import itertools
import os
import time
from typing import Any

import yaml


class CfgNode(dict):
    """dict with attribute access and recursive merge (yacs-lite)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_dict(self, other: dict, _path: str = "") -> None:
        for k, v in other.items():
            if k not in self:
                # a typo'd override must not silently do nothing
                raise KeyError(
                    f"unknown config key {_path}{k!r} (not in defaults)"
                )
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge_from_dict(v, _path=f"{_path}{k}.")
            else:
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            self.merge_from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self.items()}


# npz filename registry (reference config.py:66-81, DATASET_FILES):
# [0] = eval/test files, [1] = train files. Names not listed fall back
# to the synthesized <name>_{test,train}.npz convention.
DATASET_FILES = [
    {
        "3dpw": "3dpw_test_with_mmpose.npz",
        "3doh": "3doh_test.npz",
    },
    {
        "h36m": "h36m_train.npz",
        "mpii": "mpii_train.npz",
        "coco": "coco_2014_train.npz",
        "lspet": "hr-lspet_train.npz",
        "mpi-inf-3dhp-spin": "mpi_inf_3dhp_spin_train.npz",
        "3dpw": "3dpw_train.npz",
        "3doh": "3doh_train.npz",
        "charades": "charades_train.npz",
    },
]


def dataset_npz_path(data_dir: str, name: str, is_train: bool) -> str:
    """A dataset's npz file under `data_dir/dataset_extras`: the
    registry's name, else `<name>_{test,train}.npz`, whichever exists;
    the registry's name when neither does (for the error message)."""
    registry = DATASET_FILES[1 if is_train else 0]
    suffix = "train" if is_train else "test"
    candidates = []
    if name in registry:
        candidates.append(registry[name])
    candidates.append(f"{name}_{suffix}.npz")
    for fname in candidates:
        path = os.path.join(data_dir, "dataset_extras", fname)
        if os.path.exists(path):
            return path
    return os.path.join(data_dir, "dataset_extras", candidates[0])


def _node(d: dict) -> CfgNode:
    out = CfgNode()
    for k, v in d.items():
        out[k] = _node(v) if isinstance(v, dict) else v
    return out


def get_hparams_defaults() -> CfgNode:
    """Default tree (reference config.py:84-229)."""
    return _node(
        {
            "LOG_DIR": "logs/experiments",
            "METHOD": "spin",
            "EXP_NAME": "default",
            "EXP_ID": "",
            "RUN_TEST": False,
            "SEED_VALUE": -1,
            "PREF_LOGGER": "jsonl",
            "CONDOR_DIR": "condor_logs",
            "PL_LOGGING": True,
            "DATASET": {
                "DATA_DIR": "data",
                "NOISE_FACTOR": 0.4,
                "ROT_FACTOR": 30,
                "FLIP": 1,
                "SCALE_FACTOR": 0.25,
                "BATCH_SIZE": 64,
                "NUM_WORKERS": 8,
                "SHUFFLE_TRAIN": True,
                "SHUFFLE_VAL": False,
                "TRAIN_DS": "all",
                "DATASETS_AND_RATIOS": "h36m_coco_lspet_mpii_mpi-inf-3dhp-spin_0.5_0.233_0.046_0.021_0.2",
                "STAGE_DATASETS": "0+h36m_1.0,1+h36m_coco_lspet_mpii_mpi-inf-3dhp-spin_0.5_0.233_0.046_0.021_0.2",
                "VAL_DS": "3dpw",
                "NUM_IMAGES": -1,
                "IMG_RES": 224,
                "FOCAL_LENGTH": 5000.0,
                "IGNORE_3D": False,
                "MESH_COLOR": "light_pink",
                "GENDER_EVAL": True,
                "USE_SYNTHETIC_OCCLUSION": False,
                "OCC_AUG_DATASET": "pascal",
                "UNCERT_THRESHOLD": 0.3,
                "PIN_MEMORY": True,
                "DATASET_TYPE": "BaseDataset",
                "RESCALE_FAC": 0.224,
                "DATA_TYPE": "eft_data",
                "MIXED_TYPE": "EFTMixed",
            },
            "OPTIMIZER": {
                "TYPE": "adam",
                "LR": 0.0001,
                "WD": 0.0,
                "MM": 0.9,
                "MODULE_LR": "",
                "LR_PLATEAU_FACTOR": 0.5,
                "LR_PLATEAU_PATIENCE": 5,
                "LR_MIN": 1e-7,
                "AMSGRAD": False,
            },
            "TRAINING": {
                "RESUME": None,
                "PRETRAINED": None,
                "PRETRAINED_LIT": None,
                "MAX_EPOCHS": 100,
                "LOG_SAVE_INTERVAL": 40,
                "CHECK_VAL_EVERY_N_EPOCH": 1,
                "FREEZE_PARAMS": "",
                "RELOAD_DATALOADERS_EVERY_EPOCH": True,
                "SAVE_IMAGES": False,
                "LOG_FREQ_TB_IMAGES": 500,
                "USE_AUGM": True,
                "NUM_DEVICES": 1,
                "PRECISION": 32,
                "GRAD_CLIP_VAL": 0.0,
                "USE_SMPL_RENDER_LOSS": False,
                "USE_SMPL_SEGM_LOSS": False,
                "DIST_BACK": "ddp",
                "NUM_GPUS": 1,
            },
            "TESTING": {
                "SAVE_IMAGES": False,
                "SAVE_RESULTS": False,
                "SIDEVIEW": True,
                "TEST_ROT": 0,
                "TEST_SCALE": 1.0,
                "INF_MODEL": "best",
                "LOG_FREQ_TB_IMAGES": 50,
                "DISP_ALL": True,
                "DATASET_TYPE": "BaseDataset",
            },
            "SPIN": {
                "BACKBONE": "resnet50",
                "SHAPE_LOSS_WEIGHT": 0.0,
                "KEYPOINT_3D_LOSS_WEIGHT": 5.0,
                "KEYPOINT_2D_LOSS_WEIGHT": 2.5,
                "KEYPOINT_2D_NONCROP": False,
                "POSE_LOSS_WEIGHT": 1.0,
                "BETA_LOSS_WEIGHT": 0.001,
                "OPENPOSE_TRAIN_WEIGHT": 0.0,
                "GT_TRAIN_WEIGHT": 1.0,
                "LOSS_WEIGHT": 60.0,
                "SMPL_RENDER_LOSS_WEIGHT": 1.0,
                "SMPL_SEGM_LOSS_WEIGHT": 1.0,
            },
            "POCO": {
                "BACKBONE": "resnet50",
                "ACTIVATION_TYPE": "sigmoid",
                "UNCERT_TYPE": "pose",
                "UNCERT_LAYER": "diff_branch",
                "UNCERT_INP_TYPE": "feat",
                "KINEMATIC_UNCERT": False,
                "NUM_NEURONS": "",
                "NUM_FLOW_LAYERS": 3,
                "SIGMA_DIM": 9,
                "NUM_NF_RV": 9,
                "MASK_PARAMS_ID": "",
                "NFLOW_MASK_TYPE": "alter",
                "EXCLUDE_UNCERT_IDX": "",
                "USE_DROPOUT": True,
                "USE_ITER_FEATS": True,
                "COND_NFLOW": False,
                "CONTEXT_DIM": 1024,
                "GT_POSE_COND": False,
                "GT_POSE_COND_DS": "h36m",
                "GT_POSE_COND_RATIO": 0.25,
                "GENG_LOSS_WEIGHT": 1.0,
                "SMPL_RENDER_LOSS_WEIGHT": 1.0,
                "SMPL_SEGM_LOSS_WEIGHT": 1.0,
                "UNCERT_STATS_FILE": "",
                "SHAPE_LOSS_WEIGHT": 0.0,
                "KEYPOINT_3D_LOSS_WEIGHT": 5.0,
                "KEYPOINT_2D_LOSS_WEIGHT": 2.5,
                "KEYPOINT_2D_NONCROP": False,
                "POSE_LOSS_WEIGHT": 1.0,
                "BETA_LOSS_WEIGHT": 0.001,
                "OPENPOSE_TRAIN_WEIGHT": 0.0,
                "GT_TRAIN_WEIGHT": 1.0,
                "POSE_UNCERT_WEIGHT": 1.0,
                "BETA_UNCERT_WEIGHT": 1.0,
                "JNT_UNCERT_WEIGHT": 1.0,
                "NF_LOSS_WEIGHT": 1.0,
                "USE_KEYCONF": False,
                "LOSS_WEIGHT": 60.0,
                # reference default verbatim (config.py:223), extra "s"
                # included; shipped configs set the recognized value
                "LOSS_VER": "norm_flow_res_gauss",
                "LOG_TRAIN_UNCERT": 100,
                "LOG_UNCERT_STAT": 5,
            },
        }
    )


def update_hparams(hparams_file: str) -> CfgNode:
    """Defaults merged with a YAML experiment file."""
    hparams = get_hparams_defaults()
    hparams.merge_from_file(hparams_file)
    return hparams


def update_hparams_from_dict(cfg_dict: dict) -> CfgNode:
    hparams = get_hparams_defaults()
    hparams.merge_from_dict(cfg_dict)
    return hparams


def _flatten(d: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(d: dict[str, Any]) -> dict:
    out: dict = {}
    for k, v in d.items():
        parts = k.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def get_grid_search_configs(
    config: dict, excluded_keys: list[str] = ()
) -> tuple[list[dict], list[str]]:
    """Expand list-valued leaves into a cartesian experiment matrix
    (reference config.py:251-309). Keys in `excluded_keys` keep their list
    value instead of becoming sweep axes. Returns the experiments and the
    axes of more than one value."""
    flat = _flatten(config)
    axes: list[str] = []
    for k, v in flat.items():
        if isinstance(v, list) and k not in excluded_keys:
            if len(v) > 1:
                axes.append(k)
        else:
            flat[k] = [v]
    keys = list(flat)
    experiments = [
        _unflatten(dict(zip(keys, combo)))
        for combo in itertools.product(*(flat[k] for k in keys))
    ]
    return experiments, axes


def run_grid_search_experiments(
    cfg_file: str, cfg_id: int = 0, log: bool = True, logdir: str | None = None
) -> CfgNode:
    """Experiment `cfg_id` of the file's matrix, with its logdir set up
    (reference config.py:312-400, without the cluster hand-off).

    `logdir` pins the run to that directory instead of a timestamped one
    under LOG_DIR/METHOD/EXP_NAME, so a restarted run with --resume keeps
    appending to the same checkpoints and logs. With `log`, the merged
    config is written there as config_to_run.yaml.
    """
    with open(cfg_file) as f:
        cfg = yaml.safe_load(f)
    experiments, axes = get_grid_search_configs(cfg)
    config = update_hparams_from_dict(experiments[cfg_id])

    config.EXP_ID += f"{config.EXP_NAME}_ID{cfg_id:02d}"
    exp_id = ""
    for axis in axes:
        node: Any = experiments[cfg_id]
        for part in axis.split("/"):
            node = node[part]
        exp_id += f'{axis.replace("/", ".").replace("_", "").lower()}-{node}'
    if exp_id:
        config.EXP_ID += f"/{exp_id}"

    if logdir is not None:
        logdir = os.path.abspath(logdir)
    else:
        name = f"{config.EXP_NAME}_ID{cfg_id:02d}_{time.strftime('%d-%m-%Y_%H-%M-%S')}"
        if exp_id:
            name += f"_{exp_id}"
        logdir = os.path.join(config.LOG_DIR, config.METHOD, config.EXP_NAME, name)
    if log:
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "config_to_run.yaml"), "w") as f:
            yaml.safe_dump(config.to_dict(), f, default_flow_style=False)
    config.LOG_DIR = logdir
    return config


def _int_list(spec) -> tuple[int, ...]:
    return tuple(int(x) for x in str(spec).split("-") if x)


def model_config_from_hparams(hparams: CfgNode):
    """POCO.* / SPIN.* keys -> the port's PocoConfig."""
    from .models.poco import PocoConfig

    if hparams.METHOD == "poco":
        p = hparams.POCO
        return PocoConfig(
            backbone=p.BACKBONE,
            img_res=hparams.DATASET.IMG_RES,
            uncert_layer=p.UNCERT_LAYER,
            activation_type=p.ACTIVATION_TYPE,
            uncert_type=p.UNCERT_TYPE,
            uncert_inp_type=p.UNCERT_INP_TYPE,
            loss_ver=p.LOSS_VER,
            num_neurons=PocoConfig.parse_num_neurons(p.NUM_NEURONS),
            num_flow_layers=p.NUM_FLOW_LAYERS,
            sigma_dim=p.SIGMA_DIM,
            num_nf_rv=p.NUM_NF_RV,
            mask_params_id=_int_list(p.MASK_PARAMS_ID),
            nflow_mask_type=p.NFLOW_MASK_TYPE,
            exclude_uncert_idx=_int_list(p.EXCLUDE_UNCERT_IDX),
            use_dropout=p.USE_DROPOUT,
            use_iter_feats=p.USE_ITER_FEATS,
            cond_nflow=p.COND_NFLOW,
            context_dim=p.CONTEXT_DIM,
            gt_pose_cond=p.GT_POSE_COND,
            gt_pose_cond_ds=p.GT_POSE_COND_DS,
            gt_pose_cond_ratio=p.GT_POSE_COND_RATIO,
        )
    s = hparams.SPIN
    return PocoConfig(
        backbone=f"{s.BACKBONE}-hmr",
        img_res=hparams.DATASET.IMG_RES,
        uncert_layer="",
        loss_ver="mse",
        gt_pose_cond=False,
    )


def loss_config_from_hparams(hparams: CfgNode):
    """POCO.* / SPIN.* loss keys -> the port's LossConfig."""
    from .losses.losses import LossConfig

    p = hparams.POCO if hparams.METHOD == "poco" else hparams.SPIN
    kwargs = dict(
        shape_loss_weight=p.SHAPE_LOSS_WEIGHT,
        keypoint3d_loss_weight=p.KEYPOINT_3D_LOSS_WEIGHT,
        keypoint2d_loss_weight=p.KEYPOINT_2D_LOSS_WEIGHT,
        keypoint2d_noncrop=p.KEYPOINT_2D_NONCROP,
        pose_loss_weight=p.POSE_LOSS_WEIGHT,
        beta_loss_weight=p.BETA_LOSS_WEIGHT,
        openpose_train_weight=p.OPENPOSE_TRAIN_WEIGHT,
        gt_train_weight=p.GT_TRAIN_WEIGHT,
        loss_weight=p.LOSS_WEIGHT,
        use_smpl_render_loss=bool(hparams.TRAINING.USE_SMPL_RENDER_LOSS),
        use_smpl_segm_loss=bool(hparams.TRAINING.USE_SMPL_SEGM_LOSS),
        smpl_render_loss_weight=p.SMPL_RENDER_LOSS_WEIGHT,
        smpl_segm_loss_weight=p.SMPL_SEGM_LOSS_WEIGHT,
    )
    if hparams.METHOD == "poco":
        kwargs.update(
            pose_uncert_weight=p.POSE_UNCERT_WEIGHT,
            beta_uncert_weight=p.BETA_UNCERT_WEIGHT,
            nf_loss_weight=p.NF_LOSS_WEIGHT,
            loss_ver=p.LOSS_VER,
            uncert_type=p.UNCERT_TYPE,
            exclude_uncert_idx=_int_list(p.EXCLUDE_UNCERT_IDX),
        )
    else:
        kwargs.update(loss_ver="mse", uncert_type="", nf_loss_weight=0.0)
    return LossConfig(**kwargs)


# the port's top-level modules, in MODULE_LR's order (reference
# trainer.py:592-605: backbone, head, uncertainty head, flow head)
MODULE_GROUPS = ("backbone", "head", "uncert_head", "flow_head")
# the JAX package's names of the same modules
_MODULE_ALIASES = {"backbone_net": "backbone"}


def parse_module_lr(spec: str) -> dict[str, float]:
    """'0.1_0.1_1.0_1.0' -> per-module LR multipliers of backbone, head,
    uncert_head and flow_head."""
    if not spec:
        return {}
    return dict(zip(MODULE_GROUPS, (float(x) for x in spec.split("_"))))


def parse_freeze_params(spec: str) -> dict[int, list[str]]:
    """'0-backbone-head,1-flow_head' -> {epoch: [module, ...]} (reference
    train_utils.py:105-116); the JAX name `backbone_net` maps to `backbone`."""
    out: dict[int, list[str]] = {}
    for part in spec.split(","):
        if not part:
            continue
        bits = part.split("-")
        out[int(bits[0])] = [_MODULE_ALIASES.get(b, b) for b in bits[1:]]
    return out
