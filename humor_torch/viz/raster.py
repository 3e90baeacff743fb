"""Software mesh rasterizer (port of humor_tpu/viz/raster.py): shaded
SMPL mesh composited over video frames with the intrinsics camera, plus
a checkerboard floor.

A painter's-algorithm rasterizer on PIL's polygon fill: project with the
pinhole intrinsics, backface-cull, depth-sort, flat Lambertian shading,
alpha-composite over the frame.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BODY_COLOR = (0.65, 0.68, 0.72)   # light grey-blue, like pyrender
CONTACT_COLOR = (0.85, 0.25, 0.25)
LIGHT_DIR = (0.25, -0.4, -0.88)           # head-on key light


def project_pinhole(verts: np.ndarray, cam_f: Sequence[float],
                    cam_center: Sequence[float]) -> np.ndarray:
    """(V, 3) camera-frame points -> (V, 2) pixel coords."""
    z = np.maximum(verts[:, 2:3], 1e-6)
    return verts[:, :2] / z * np.asarray(cam_f) + np.asarray(cam_center)


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def _fill_polygons(img: np.ndarray, polys: Sequence[np.ndarray],
                   fills: Sequence) -> np.ndarray:
    """A copy of `img` ((H, W, 3) or (H, W) uint8) with the integer pixel
    polygons (each (n, 2)) filled in order, polygon i with fills[i] (an
    RGB tuple, or an int for a mask)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img))
    draw = ImageDraw.Draw(im)
    for p, fill in zip(polys, fills):
        draw.polygon([(int(u), int(v)) for u, v in p], fill=fill)
    return np.array(im)


def rasterize_mesh(
    img: np.ndarray,                 # (H, W, 3) uint8, modified copy out
    verts: np.ndarray,               # (V, 3) camera frame (+z forward)
    faces: np.ndarray,               # (F, 3) int
    cam_f: Sequence[float],
    cam_center: Sequence[float],
    color: Tuple[float, float, float] = DEFAULT_BODY_COLOR,
    alpha: float = 0.85,
    vert_colors: Optional[np.ndarray] = None,  # (V, 3) float overrides
) -> np.ndarray:
    """Composite a flat-shaded mesh over `img` (painter's algorithm:
    backface cull -> far-to-near depth sort -> a polygon fill a face)."""
    H, W = img.shape[:2]
    uv = project_pinhole(verts, cam_f, cam_center)

    # keep faces fully in front of the camera
    z_ok = (verts[faces][:, :, 2] > 1e-3).all(axis=1)
    normals = _face_normals(verts, faces)
    centers = verts[faces].mean(axis=1)
    # backface cull: visible faces point toward the camera (n . view < 0)
    facing = np.einsum("fc,fc->f", normals, centers) < 0.0
    keep = z_ok & facing
    f = faces[keep]
    n = normals[keep]
    if f.shape[0] == 0:
        return img

    # far-to-near painter's order
    order = np.argsort(-verts[f].mean(axis=1)[:, 2])
    f, n = f[order], n[order]

    light = np.asarray(LIGHT_DIR) / np.linalg.norm(LIGHT_DIR)
    lam = 0.35 + 0.65 * np.clip(-(n @ light), 0.0, 1.0)  # (F,)
    if vert_colors is not None:
        base = vert_colors[f].mean(axis=1)  # (F, 3)
    else:
        base = np.asarray(color)[None]
    shades = np.clip(lam[:, None] * base * 255.0, 0, 255).astype(np.uint8)

    polys = np.round(uv[f]).astype(np.int32)  # (F, 3, 2)
    shades = np.broadcast_to(shades, (f.shape[0], 3))
    overlay = _fill_polygons(img, polys, [tuple(int(v) for v in c)
                                          for c in shades])
    mask = _fill_polygons(np.zeros((H, W), np.uint8), polys,
                          [1] * len(polys))
    m = (mask[..., None] * alpha)
    return (img * (1 - m) + overlay * m).astype(np.uint8)


def draw_checkerboard_floor(
    img: np.ndarray,
    floor_plane: np.ndarray,          # (4,) [nx, ny, nz, off], n.p = off
    cam_f: Sequence[float],
    cam_center: Sequence[float],
    center_xz: Tuple[float, float] = (0.0, 3.0),
    extent: float = 4.0,
    tile: float = 0.5,
    alpha: float = 0.35,
) -> np.ndarray:
    """Checkerboard on the floor plane, centered under `center_xz`
    (camera-frame x and z)."""
    n = np.asarray(floor_plane[:3], np.float64)
    off = float(floor_plane[3])
    n = n / max(np.linalg.norm(n), 1e-12)
    # plane basis: two tangents orthogonal to n
    t1 = np.cross(n, [0.0, 0.0, 1.0])
    if np.linalg.norm(t1) < 1e-6:
        t1 = np.cross(n, [1.0, 0.0, 0.0])
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    # plane point nearest the requested center
    p0 = np.asarray([center_xz[0], 0.0, center_xz[1]])
    p0 = p0 - (n @ p0 - off) * n

    k = int(np.ceil(extent / tile))
    polys, shades = [], []
    for i in range(-k, k):
        for j in range(-k, k):
            corners = np.stack([
                p0 + t1 * (i * tile) + t2 * (j * tile),
                p0 + t1 * ((i + 1) * tile) + t2 * (j * tile),
                p0 + t1 * ((i + 1) * tile) + t2 * ((j + 1) * tile),
                p0 + t1 * (i * tile) + t2 * ((j + 1) * tile),
            ])
            if (corners[:, 2] < 0.3).any():
                continue
            uv = np.round(project_pinhole(corners, cam_f, cam_center)
                          ).astype(np.int32)
            shade = 210 if (i + j) % 2 == 0 else 120
            polys.append(uv)
            shades.append((shade, shade, shade))
    overlay = _fill_polygons(img, polys, shades)
    drawn = _fill_polygons(np.zeros(img.shape[:2], np.uint8), polys,
                           [1] * len(polys))
    m = drawn[..., None] * alpha
    return (img * (1 - m) + overlay * m).astype(np.uint8)


def render_mesh_over_frames(
    verts_seq: np.ndarray,            # (T, V, 3) camera frame
    faces: np.ndarray,
    cam_f: Sequence[float],
    cam_center: Sequence[float],
    out_dir: str,
    img_paths: Optional[Sequence[str]] = None,
    img_size: Tuple[int, int] = (1920, 1080),
    floor_plane: Optional[np.ndarray] = None,
    contact_verts: Optional[np.ndarray] = None,  # (T, V) bool/float
    make_video: bool = True,
    scale: float = 0.5,               # render-resolution factor
) -> List[str]:
    """Shaded fitted mesh (+floor +contacts) composited over the video
    frames. Frames missing on disk render over black."""
    from PIL import Image

    from humor_torch.viz.utils import create_video

    os.makedirs(out_dir, exist_ok=True)
    W, H = img_size
    sW, sH = int(W * scale), int(H * scale)
    s_f = (np.asarray(cam_f) * scale).tolist()
    s_c = (np.asarray(cam_center) * scale).tolist()

    paths = []
    for t in range(verts_seq.shape[0]):
        if img_paths is not None and t < len(img_paths) \
                and os.path.exists(img_paths[t]):
            img = np.asarray(Image.open(img_paths[t]).resize((sW, sH)))
            img = img[..., :3].copy()
        else:
            img = np.zeros((sH, sW, 3), np.uint8)
        if floor_plane is not None:
            cx = float(verts_seq[t, :, 0].mean())
            cz = float(verts_seq[t, :, 2].mean())
            img = draw_checkerboard_floor(img, floor_plane, s_f, s_c,
                                          center_xz=(cx, cz))
        vc = None
        if contact_verts is not None:
            w = np.clip(contact_verts[t].astype(np.float32), 0, 1)[:, None]
            vc = (np.asarray(DEFAULT_BODY_COLOR)[None] * (1 - w)
                  + np.asarray(CONTACT_COLOR)[None] * w)
        img = rasterize_mesh(img, verts_seq[t], faces, s_f, s_c,
                             vert_colors=vc)
        path = os.path.join(out_dir, f"mesh_{t:06d}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    if make_video:
        create_video(out_dir, os.path.join(out_dir, "mesh_overlay.mp4"),
                     pattern="mesh_%06d.png")
    return paths
