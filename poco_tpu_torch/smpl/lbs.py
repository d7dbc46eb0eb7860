"""Batched linear blend skinning (LBS) for the SMPL body model, in torch.

Port of `poco_tpu.smpl.lbs`: shape and pose blendshapes, joint
regression and the 24-step kinematic chain are plain torch; the skinning
stage goes through `ops.skinning.skinning`, which launches the CUDA
kernel on CUDA tensors. All math is float32; callers that need it exact
keep TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`, the
default).

Params that carry a `VertexShard` (`parallel.mesh.shard_smpl_params`: the
SMPL "model" axis) hold one process's vertex range, and the forward runs
on that shard: the shaped and posed vertices and the skinning kernel on
the shard's vertices, the rest joints and the extra joints as partial
sums over the model group, the kinematic chain replicated, and the
vertices gathered in shard order at the end, so that every caller reads
the whole mesh as before. The crossings are the autograd functions of
`parallel.distributed` (`model_partial_sum`, `model_replicated`,
`model_gather`), which keep the gradients those of one process.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.skinning import skinning
from ..parallel import distributed
from ..utils import spans

_TENSOR_FIELDS = (
    "v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
    "j_regressor_extra", "faces",
)


@dataclasses.dataclass(frozen=True, eq=False)
class VertexShard:
    """One process's share of the SMPL vertices on the model axis.

        lo, hi: its vertex range [lo, hi)
        counts: the vertices of each model index, in order
        group: the model group (`parallel.distributed.model_group()`)
        lbs_weights: (V, 24) every vertex's skinning weights, for the
            readers of the whole mesh's parts (part labels, colours)
    """

    lo: int
    hi: int
    counts: tuple
    group: object
    lbs_weights: torch.Tensor

    def to(self, device) -> "VertexShard":
        return dataclasses.replace(self, lbs_weights=self.lbs_weights.to(device))


@dataclasses.dataclass(frozen=True, eq=False)
class SmplParams:
    """SMPL model weights (V = number of vertices, 6890 for SMPL).

        v_template:  (V, 3)    rest-pose template mesh
        shapedirs:   (V, 3, num_betas) shape blendshape basis
        posedirs:    (207, V*3)       pose-corrective blendshape basis
        j_regressor: (24, V)   rest-joint regressor
        lbs_weights: (V, 24)   skinning weights
        j_regressor_extra: (9, V) extra-joint regressor, on posed vertices
        faces: (F, 3) int32 triangle indices
        parents: kinematic parent table (parents[0] == -1)
        vertex_joint_ids: vertex indices appended as 21 keypoints
        shard: this process's vertex range on the model axis, or None;
            with a shard the vertex arrays hold that range only (their V
            is the shard's), `faces` and `vertex_joint_ids` stay global
    """

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    j_regressor_extra: torch.Tensor
    faces: torch.Tensor
    parents: tuple
    vertex_joint_ids: tuple
    shard: VertexShard | None = None

    def to(self, device) -> "SmplParams":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS},
            shard=None if self.shard is None else self.shard.to(device),
        )

    @property
    def all_lbs_weights(self) -> torch.Tensor:
        """(V, 24) the skinning weights of every vertex, sharded or not."""
        return self.lbs_weights if self.shard is None else self.shard.lbs_weights


class SmplOutput(NamedTuple):
    vertices: torch.Tensor    # (B, V, 3)
    joints: torch.Tensor      # (B, 54, 3): 24 LBS + 21 vertex + 9 extra
    joints_lbs: torch.Tensor  # (B, 24, 3) posed skeleton joints


def blend_shapes(betas: torch.Tensor, shapedirs: torch.Tensor) -> torch.Tensor:
    """(B, num_betas) x (V, 3, num_betas) -> (B, V, 3) shape offsets."""
    num_verts = shapedirs.shape[0]
    basis = shapedirs.reshape(num_verts * 3, -1)
    return (betas @ basis.T).reshape(betas.shape[0], num_verts, 3)


def vertices2joints(j_regressor: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvk->bjk", j_regressor, verts)


def batch_rigid_transform(
    rotmats: torch.Tensor, joints: torch.Tensor, parents
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-kinematics chain.

    Args:
        rotmats: (B, J, 3, 3) per-joint local rotations.
        joints: (B, J, 3) rest-pose joint locations.
        parents: length-J parent table.
    Returns:
        posed_joints: (B, J, 3) world-frame joint positions.
        rel_transforms: (B, J, 4, 4) skinning transforms (world transform
            with the rest-pose joint location factored out).
    """
    batch, num_joints = joints.shape[:2]
    parents = [int(p) for p in parents]

    rel_joints = joints.clone()
    with spans.span(spans.SYNC_PARENTS, wait=True):   # the list index goes to the card
        rel_joints[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]

    tfm = torch.zeros(
        (batch, num_joints, 4, 4), dtype=rotmats.dtype, device=rotmats.device
    )
    tfm[:, :, :3, :3] = rotmats
    tfm[:, :, :3, 3] = rel_joints
    tfm[:, :, 3, 3] = 1.0

    world = [tfm[:, 0]]
    for j in range(1, num_joints):
        world.append(world[parents[j]] @ tfm[:, j])
    world = torch.stack(world, dim=1)

    posed_joints = world[:, :, :3, 3]
    correction = torch.einsum("bjxy,bjy->bjx", world[:, :, :3, :3], joints)
    rel = world.clone()
    rel[:, :, :3, 3] = world[:, :, :3, 3] - correction
    return posed_joints, rel


def lbs(
    betas: torch.Tensor, pose_rotmats: torch.Tensor, params: SmplParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SMPL LBS forward.

    Args:
        betas: (B, num_betas) shape coefficients.
        pose_rotmats: (B, 24, 3, 3) per-joint rotations (root first).
    Returns:
        vertices (B, V, 3), joints_lbs (B, 24, 3). With a shard the
        vertices are the shard's (B, hi - lo, 3).
    """
    batch = betas.shape[0]
    num_verts = params.v_template.shape[0]
    dtype = params.v_template.dtype
    betas = betas.to(dtype)
    pose_rotmats = pose_rotmats.to(dtype)
    group = None if params.shard is None else params.shard.group

    def into_shard(x):
        return x if group is None else distributed.model_replicated(x, group)

    def over_shards(x):
        return x if group is None else distributed.model_partial_sum(x, group)

    v_shaped = params.v_template[None] + blend_shapes(into_shard(betas), params.shapedirs)
    j_rest = over_shards(vertices2joints(params.j_regressor, v_shaped))

    ident = torch.eye(3, dtype=dtype, device=pose_rotmats.device)
    pose_feature = (pose_rotmats[:, 1:] - ident).reshape(batch, -1)  # (B, 207)
    pose_offsets = (into_shard(pose_feature) @ params.posedirs).reshape(batch, num_verts, 3)
    v_posed = v_shaped + pose_offsets

    joints_posed, rel_tfms = batch_rigid_transform(
        pose_rotmats, j_rest, params.parents
    )
    rel_tfms = into_shard(rel_tfms)
    verts = skinning(
        params.lbs_weights.contiguous(), rel_tfms.contiguous(),
        v_posed.contiguous(),
    )
    return verts, joints_posed


def smpl_forward(
    params: SmplParams, betas: torch.Tensor, pose_rotmats: torch.Tensor
) -> SmplOutput:
    """SMPL forward producing the 54-joint superset.

    Joint layout (reference pocolib/models/head/smpl_head.py:22-34):
        [0:24)   LBS skeleton joints
        [24:45)  vertex-selected keypoints
        [45:54)  extra regressed joints (J_regressor_extra)
    """
    verts, joints_lbs = lbs(betas, pose_rotmats, params)
    extra_joints = vertices2joints(params.j_regressor_extra, verts)
    if params.shard is not None:
        group = params.shard.group
        extra_joints = distributed.model_partial_sum(extra_joints, group)
        verts = distributed.model_gather(verts, group, params.shard.counts, dim=1)
    with spans.span(spans.SYNC_VERTEX_IDS, wait=True):
        ids = torch.as_tensor(params.vertex_joint_ids, device=verts.device)
    vertex_joints = verts[:, ids]
    joints = torch.cat([joints_lbs, vertex_joints, extra_joints], dim=1)
    return SmplOutput(vertices=verts, joints=joints, joints_lbs=joints_lbs)
