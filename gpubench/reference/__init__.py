"""The benchmark's plain reference of POCO-CLIFF and POCO-PARE.

A frozen copy of the port's model, SMPL, crop, loss and training code,
taken from `poco_tpu_torch` at commit 48ff100 (the commit this benchmark
was written on), so that a later change to the port is judged against
the code as it stood here and not against itself. It imports neither
`jax`, nor `poco_tpu`, nor `poco_tpu_torch`, and it takes nothing that
the port made: the benchmark hands both sides the same frames, boxes,
weights, SMPL arrays and batches, and this package makes its crops, GT
meshes and updates again itself. It runs in fp32 with TF32 off (the
benchmark sets that), except as the control.

Copied files (this package's name <- the port's, at 48ff100), with only
their relative imports rewritten to this flat package:

    constants.py    <- poco_tpu_torch/constants.py
    common.py       <- poco_tpu_torch/models/backbones/common.py
    hrnet.py        <- poco_tpu_torch/models/backbones/hrnet.py
    layers.py       <- poco_tpu_torch/models/layers.py
    attention.py    <- poco_tpu_torch/models/attention.py
    cliff.py        <- poco_tpu_torch/models/heads/cliff.py
    pare.py         <- poco_tpu_torch/models/heads/pare.py
    poco_uncert.py  <- poco_tpu_torch/models/heads/poco_uncert.py
    flow.py         <- poco_tpu_torch/models/heads/flow.py
    mean_params.py  <- poco_tpu_torch/smpl/mean_params.py
    lbs.py          <- poco_tpu_torch/smpl/lbs.py
    smpl_model.py   <- poco_tpu_torch/smpl/model.py
    camera.py       <- poco_tpu_torch/ops/camera.py
    rotation.py     <- poco_tpu_torch/ops/rotation.py
    preprocess.py   <- poco_tpu_torch/ops/preprocess.py
    losses.py       <- poco_tpu_torch/losses/losses.py
    poco.py         <- poco_tpu_torch/models/poco.py (PocoConfig, POCO)
    train.py        <- poco_tpu_torch/train/step.py (prepare_gt)

Departures from the port:

- skinning (`lbs.py:skinning`) is the plain two-einsum blend and affine
  of `poco_tpu_torch/ops/skinning.py:skinning_reference`, in place of the
  custom op `poco_tpu_torch::skinning` and its CUDA kernels (forward and
  backward: autograd differentiates the einsums);
- no autocast: `poco.py` drops the bf16 region (`compute_precision`) and
  the fp32 casts around SMPL, and the registry holds the two HRNets the
  benchmark runs (no ResNet, no HMR head, no builders);
- one process: `distributed.py` replaces the port's process groups (the
  sums over processes are the identity; no model axis);
- `losses.py` has no part-segmentation term (off in every configuration
  of the benchmark; it raises if asked for);
- `train.py:train_step` and `Adam` are written out from
  `train/step.py:make_train_step` and `train/state.py:ModuleAdam` for the
  configurations' settings: one learning rate, no weight decay, no
  clipping, no frozen module, no render targets; `smpl_from_arrays`
  builds SMPL from a model file's arrays as
  `smpl/assets.py:_params_from_dict` does.
"""
