"""Software mesh renderer: weak-perspective overlay with uncertainty
colours (port of `poco_tpu.viz.renderer`; reference
pocolib/utils/vibe_renderer.py:34-151, renderer.py:137-224).

The mesh is projected with the [sx, sy, tx, ty] original-image camera,
flat-shaded per face and drawn by the native z-buffer rasterizer
(`runtime/raster.py`), the only route: the JAX package's painter's loop
is `cv2.fillPoly`, and the port has no OpenCV. With `wireframe` each face
is outlined far first, as the JAX package's `cv2.polylines` loop draws it
(`runtime.raster.wireframe`, native). The sideview caption is
`overlay_text` (`viz/text.py`).

The SMPL part segmentation of the uncertainty colours is the skinning
weights' argmax over joints.
"""

from __future__ import annotations

import numpy as np

from ..runtime.raster import raster_mesh
from ..runtime.raster import wireframe as wireframe_faces
from .text import get_text_size, put_text

# Mesh color registry (reference MESH_COLOR config + the demo color
# table used by the vibe renderer).
MESH_COLORS = {
    "light_pink": (0.96, 0.76, 0.76),
    "pink": (0.77, 0.57, 0.57),
    "light_blue": (0.65, 0.74, 0.86),
    "blue": (0.0, 0.4, 0.7),
    "light_green": (0.65, 0.85, 0.65),
    "green": (0.3, 0.7, 0.3),
    "purple": (0.6, 0.4, 0.7),
    "red": (0.8, 0.3, 0.3),
    "gray": (0.5, 0.5, 0.5),
    "white": (0.9, 0.9, 0.9),
    "yellow": (0.85, 0.8, 0.3),
}


def get_mesh_color(name: str) -> tuple:
    return MESH_COLORS.get(name, MESH_COLORS["light_pink"])


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Matplotlib-'jet'-style colormap, x in [0,1] -> RGB in [0,1]."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)

    def interp(val, points, vals):
        return np.interp(val, points, vals)

    r = interp(x, [0.0, 0.35, 0.66, 0.89, 1.0], [0.0, 0.0, 1.0, 1.0, 0.5])
    g = interp(x, [0.0, 0.125, 0.375, 0.64, 0.91, 1.0],
               [0.0, 0.0, 1.0, 1.0, 0.0, 0.0])
    b = interp(x, [0.0, 0.11, 0.34, 0.65, 1.0], [0.5, 1.0, 1.0, 0.0, 0.0])
    return np.stack([r, g, b], axis=-1)


def vertex_part_ids(lbs_weights: np.ndarray) -> np.ndarray:
    """(V,) dominant-joint id per vertex (part segmentation)."""
    return np.argmax(np.asarray(lbs_weights), axis=-1)


def get_vertex_colors(
    per_joint_uncert: np.ndarray,
    lbs_weights: np.ndarray,
    backbone: str = "cliff",
    sensitivity_threshold: float = 0.40,
) -> np.ndarray:
    """Per-vertex RGBA colors from per-joint uncertainty.

    Reference contract: renderer.py:193-224 — CLIFF uses the global (hip)
    uncertainty for the whole body; PARE uses the joint mean; the colormap
    max expands when the hip uncertainty exceeds the threshold.
    """
    parts = vertex_part_ids(lbs_weights)
    n_verts = parts.shape[0]
    label = np.array(per_joint_uncert, np.float32).reshape(-1)
    vmax = 1.0
    if label.shape[0] > 1:
        if "cliff" in backbone:
            if label[0] > 2 * sensitivity_threshold:
                vmax = label[0]
            label[:] = label[0]
        else:
            if label[0] > sensitivity_threshold:
                vmax = label[0]
            label[:] = label.mean()
    else:
        label = np.repeat(label, 24)

    colors = np.ones((n_verts, 4), np.float32) * np.array(
        [0.3, 0.3, 0.3, 1.0], np.float32
    )
    rgb = jet_colormap(label / max(vmax, 1e-6))
    colors[:, :3] = rgb[parts]
    return colors


class Renderer:
    """Mesh overlay renderer on the native z-buffer rasterizer.

    Args:
        faces: (F, 3) triangle indices.
        width/height: output image size (may be overridden per call).
    """

    def __init__(self, faces: np.ndarray, width: int = 224, height: int = 224):
        self.faces = np.asarray(faces, np.int64)
        self.width = width
        self.height = height

    def render(
        self,
        img: np.ndarray | None,
        verts: np.ndarray,
        cam: np.ndarray,
        color: tuple = (0.8, 0.3, 0.3),
        vertex_colors: np.ndarray | None = None,
        angle: float | None = None,
        axis: tuple = (0.0, 1.0, 0.0),
        mesh_filename: str | None = None,
        alpha: float = 0.9,
        wireframe: bool = False,
    ) -> np.ndarray:
        """Overlay the mesh on `img`.

        Args:
            img: (H, W, 3) uint8/float background, or None for black.
            verts: (V, 3) SMPL vertices.
            cam: (4,) [sx, sy, tx, ty] original-image weak-persp camera
                (from demo_utils.convert_crop_cam_to_orig_img), or (3,)
                crop camera [s, tx, ty] (sx = sy = s assumed).
        """
        if img is None:
            img = np.zeros((self.height, self.width, 3), np.uint8)
        h, w = img.shape[:2]
        out = img.astype(np.float32).copy()

        verts = np.asarray(verts, np.float32)
        if angle is not None:
            verts = _rotate_verts(verts, angle, axis)
        if mesh_filename:
            save_obj(mesh_filename, verts, self.faces)

        cam = np.asarray(cam, np.float32).reshape(-1)
        if cam.shape[0] == 3:
            cam = np.array([cam[0], cam[0], cam[1], cam[2]], np.float32)
        sx, sy, tx, ty = cam

        # 180-degree rotation about x (render convention), then ortho NDC.
        x, y, z = verts[:, 0], -verts[:, 1], -verts[:, 2]
        u = (sx * (x + tx) + 1.0) * w / 2.0
        v = (sy * (y + ty) + 1.0) * h / 2.0
        uv = np.stack([u, v], axis=-1)

        tri_uv = uv[self.faces]                      # (F, 3, 2)
        tri_z = z[self.faces].mean(axis=-1)          # (F,)

        # Cull off-screen and back-facing(ish) degenerate triangles.
        e1 = tri_uv[:, 1] - tri_uv[:, 0]
        e2 = tri_uv[:, 2] - tri_uv[:, 0]
        area = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        on_screen = (
            (tri_uv[..., 0].max(-1) >= 0) & (tri_uv[..., 0].min(-1) < w)
            & (tri_uv[..., 1].max(-1) >= 0) & (tri_uv[..., 1].min(-1) < h)
            & (np.abs(area) > 1e-6)
        )

        # Simple diffuse shading from the face normal.
        v3 = verts[self.faces]
        n = np.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
        n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9)
        light = np.abs(n @ np.array([0.2, 0.2, 0.95], np.float32)) * 0.7 + 0.3

        if vertex_colors is not None:
            face_rgb = vertex_colors[self.faces, :3].mean(axis=1)
        else:
            face_rgb = np.broadcast_to(
                np.asarray(color, np.float32), (len(self.faces), 3)
            ).copy()
        face_rgb = np.clip(face_rgb * light[:, None], 0, 1) * 255.0

        if wireframe:
            # the JAX package's painter's loop: far faces first, each a
            # closed cv2.polylines outline over the float overlay
            order = np.argsort(tri_z)
            order = order[on_screen[order]]
            pts = np.round(tri_uv[order]).astype(np.int32)
            overlay = wireframe_faces(out, pts, face_rgb[order])
        else:
            overlay = raster_mesh(out, uv, tri_z, self.faces, face_rgb, on_screen)
        out = (1 - alpha) * out + alpha * overlay
        return np.clip(out, 0, 255).astype(np.uint8)

    def render_sideview(self, verts, cam, **kwargs):
        """90-degree rotated view (reference tester.py sideview path)."""
        return self.render(
            None, verts - verts.mean(0, keepdims=True), cam,
            angle=270.0, axis=(0, 1, 0), **kwargs,
        )


def _rotate_verts(verts, angle_deg, axis):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
         [-axis[1], axis[0], 0]]
    )
    rot = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)
    return (verts @ rot.T).astype(np.float32)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal OBJ export (reference uses trimesh, vibe_renderer.py:102)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def overlay_text(image: np.ndarray, txt_str: str, str_id: int = 1) -> np.ndarray:
    """White-boxed red text, sized to the image (the JAX package's caption:
    `cv2.getTextSize`, a filled `cv2.rectangle` and `cv2.putText` with
    FONT_HERSHEY_SIMPLEX; reference pocolib/utils/image_utils.py:355-367,
    whose only live use is the sideview "Other View" caption,
    tester.py:567). The box is the rectangle's pixels, corners included;
    the text is `viz.text`'s model of cv2's (OpenCV 5's Rubik glyphs)."""
    image = np.ascontiguousarray(image)
    font_scale = image.shape[0] * 0.0016
    thickness = max(int(image.shape[0] * 0.005), 1)
    bbox_offset = int(image.shape[0] * 0.01)
    text_x = int(image.shape[1] * 0.02)
    text_y = int(image.shape[0] * 0.06 * str_id)
    tw, th = get_text_size(txt_str, font_scale, thickness)
    x0, x1 = text_x, text_x + tw + bbox_offset
    y0, y1 = text_y - th - bbox_offset, text_y + bbox_offset
    image[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = 255
    return put_text(image, txt_str, (text_x, text_y), font_scale, (255, 0, 0), thickness)
