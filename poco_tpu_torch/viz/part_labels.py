"""GT part-label rendering (port of `poco_tpu.viz.part_labels`; reference
pocolib/utils/image_utils.py:289-314, `generate_part_labels`).

The GT SMPL mesh drawn with a part label a face into a (B, H, W) label
map: the painter's algorithm, far faces first, each face's part the
dominant skinning weight of its first vertex. Labels: 0 background, j + 1
for SMPL joint j (the 25 channels of PARE's segmentation head).

The JAX package fills each face with `cv2.fillPoly`; the port has no
OpenCV, so the faces go to the native rasterizer's
`runtime/raster.label_triangles`, which fills each rounded integer
triangle as that call does (its outline clipped to the map included):
pixel for pixel against cv2 on meshes inside the map and across its
border (tests/test_torch_part_labels.py).
"""

from __future__ import annotations

import numpy as np

from ..runtime.raster import label_triangles
from .renderer import vertex_part_ids


def render_part_labels(verts: np.ndarray, faces: np.ndarray, cam: np.ndarray,
                       lbs_weights: np.ndarray, out_res: int = 56) -> np.ndarray:
    """One mesh as a part-label map.

    Args:
        verts: (V, 3) SMPL vertices.
        faces: (F, 3) triangles.
        cam: (3,) [s, tx, ty] weak-perspective crop camera, or (4,)
            [sx, sy, tx, ty].
        lbs_weights: (V, 24) skinning weights (parts by argmax).
        out_res: the map's size (56, PARE's 1/4 feature grid).
    Returns:
        (out_res, out_res) uint8, 0 the background.
    """
    cam = np.asarray(cam, np.float32).reshape(-1)
    if cam.shape[0] == 3:
        cam = np.array([cam[0], cam[0], cam[1], cam[2]], np.float32)
    sx, sy, tx, ty = cam
    x, y, z = verts[:, 0], -verts[:, 1], -verts[:, 2]
    u = (sx * (x + tx) + 1.0) * out_res / 2.0
    v = (sy * (y + ty) + 1.0) * out_res / 2.0
    uv = np.stack([u, v], axis=-1)

    order = np.argsort(z[faces].mean(axis=-1))  # far first; near parts overwrite
    pts = np.round(uv[faces[order]]).astype(np.int32)
    on_map = ((pts.max(axis=1) >= 0) & (pts.min(axis=1) < out_res)).all(axis=1)
    face_part = vertex_part_ids(lbs_weights)[faces[order, 0]].astype(np.uint8) + 1
    return label_triangles(np.zeros((out_res, out_res), np.uint8), pts[on_map],
                           face_part[on_map])


def generate_part_labels(verts_batch: np.ndarray, faces: np.ndarray, cams: np.ndarray,
                         lbs_weights: np.ndarray, out_res: int = 56) -> np.ndarray:
    """(B, V, 3) meshes and (B, 3) cameras -> (B, R, R) uint8 label maps."""
    return np.stack([
        render_part_labels(np.asarray(verts_batch[i]), faces, np.asarray(cams[i]),
                           lbs_weights, out_res)
        for i in range(len(verts_batch))
    ])
