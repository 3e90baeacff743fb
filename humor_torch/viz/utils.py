"""Host-side visualization (port of humor_tpu/viz/utils.py): skeleton
rendering of motion sequences with matplotlib (headless), gif writing
with PIL, mp4 through ffmpeg when it is installed, and OBJ mesh export.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np

from humor_torch.body_model import constants as C

# bone list from the kinematic tree (parent -> child)
SMPL_BONES = [(int(C.SMPL_PARENTS[j]), j)
              for j in range(1, C.NUM_SMPL_JOINTS)]


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # noqa: F401

    return matplotlib


def render_joint_frame(joints: np.ndarray,
                       ax=None,
                       contacts: Optional[np.ndarray] = None,
                       lim: float = 1.2,
                       center: Optional[np.ndarray] = None,
                       ground_z: Optional[float] = 0.0,
                       color: str = "#1f77b4"):
    """Draw one (J, 3) joint skeleton into a matplotlib 3D axis."""
    _require_mpl()
    import matplotlib.pyplot as plt

    own = ax is None
    if own:
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
    if center is None:
        center = joints[0]
    for p, c in SMPL_BONES:
        ax.plot(*zip(joints[p], joints[c]), c=color, lw=2)
    col = np.full(len(joints), color, dtype=object)
    if contacts is not None:
        col[np.asarray(contacts) > 0.5] = "#d62728"
    ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], c=list(col), s=12)
    if ground_z is not None:
        gx, gy = np.meshgrid(
            np.linspace(center[0] - lim, center[0] + lim, 2),
            np.linspace(center[1] - lim, center[1] + lim, 2))
        ax.plot_surface(gx, gy, np.full_like(gx, ground_z), alpha=0.15,
                        color="gray")
    ax.set_xlim(center[0] - lim, center[0] + lim)
    ax.set_ylim(center[1] - lim, center[1] + lim)
    ax.set_zlim(min(0.0, center[2] - lim) if ground_z is not None
                else center[2] - lim, center[2] + lim)
    ax.set_box_aspect((1, 1, 1))
    return ax


def render_joint_seq(joints_seq: np.ndarray, out_dir: str,
                     contacts: Optional[np.ndarray] = None,
                     follow: bool = True,
                     prefix: str = "frame") -> List[str]:
    """Render a (T, J, 3) sequence to pngs. Returns the frame paths."""
    _require_mpl()
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    center0 = joints_seq[0, 0]
    for t in range(joints_seq.shape[0]):
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        render_joint_frame(
            joints_seq[t], ax=ax,
            contacts=None if contacts is None else contacts[t],
            center=joints_seq[t, 0] if follow else center0)
        path = os.path.join(out_dir, f"{prefix}_{t:06d}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        paths.append(path)
    return paths


def render_comparison_seq(seqs: Sequence[np.ndarray], labels: Sequence[str],
                          out_dir: str, prefix: str = "cmp") -> List[str]:
    """Side-by-side skeleton comparison, one panel a sequence."""
    _require_mpl()
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    T = min(s.shape[0] for s in seqs)
    n = len(seqs)
    paths = []
    for t in range(T):
        fig = plt.figure(figsize=(5 * n, 5))
        for i, (seq, label) in enumerate(zip(seqs, labels)):
            ax = fig.add_subplot(1, n, i + 1, projection="3d")
            render_joint_frame(seq[t], ax=ax, center=seq[t, 0])
            ax.set_title(label)
        path = os.path.join(out_dir, f"{prefix}_{t:06d}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        paths.append(path)
    return paths


def create_gif(frame_paths: Sequence[str], out_path: str,
               fps: float = 30.0) -> str:
    """Assemble pngs into a gif with PIL."""
    from PIL import Image

    frames = [Image.open(p) for p in frame_paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(int(1000.0 / fps), 20), loop=0)
    return out_path


def create_video(frame_dir: str, out_path: str, fps: float = 30.0,
                 pattern: str = "frame_%06d.png") -> Optional[str]:
    """mp4 via ffmpeg when available, else a gif."""
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-r", str(fps), "-i",
             os.path.join(frame_dir, pattern), "-pix_fmt", "yuv420p",
             out_path],
            check=True, capture_output=True)
        return out_path
    frames = sorted(
        os.path.join(frame_dir, f) for f in os.listdir(frame_dir)
        if f.endswith(".png"))
    if not frames:
        return None
    gif = os.path.splitext(out_path)[0] + ".gif"
    return create_gif(frames, gif, fps)


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    """Write one mesh frame as OBJ (viewable anywhere)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(faces):
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
    return path


def export_obj_seq(out_dir: str, verts_seq: np.ndarray,
                   faces: np.ndarray) -> List[str]:
    """(T, V, 3) mesh sequence -> per-frame OBJ files."""
    os.makedirs(out_dir, exist_ok=True)
    return [export_obj(os.path.join(out_dir, f"mesh_{t:06d}.obj"),
                       verts_seq[t], faces)
            for t in range(verts_seq.shape[0])]


def viz_smpl_seq(joints_seq: np.ndarray, out_dir: str,
                 contacts: Optional[np.ndarray] = None,
                 fps: float = 30.0,
                 make_video: bool = True) -> Dict[str, object]:
    """One-call sequence visualization: renders frames and assembles a
    video/gif."""
    frames = render_joint_seq(np.asarray(joints_seq), out_dir,
                              contacts=contacts)
    out: Dict[str, object] = {"frames": frames}
    if make_video:
        out["video"] = create_video(out_dir,
                                    os.path.join(out_dir, "motion.mp4"),
                                    fps=fps)
    return out
