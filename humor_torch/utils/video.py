"""External-tool shell for the RGB pipeline (port of
humor_tpu/utils/video.py): video -> frames (ffmpeg), OpenPose keypoint
detection (a local OpenPose build), person segmentation masks
(torchvision's DeepLabv3 through torch.hub, which downloads its weights
once). Each is gated on its tool with a clear error; the fit CLI reads
precomputed keypoints and masks, so it needs none of them.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional


def video_to_images(vid_path: str, out_path: str, fps: float = 30.0,
                    ext: str = "png") -> str:
    """Extract frames at `fps` with ffmpeg."""
    if not shutil.which("ffmpeg"):
        raise RuntimeError(
            "ffmpeg not found; extract frames manually or install ffmpeg")
    os.makedirs(out_path, exist_ok=True)
    cmd = ["ffmpeg", "-i", vid_path, "-f", "image2", "-v", "error",
           "-vf", f"fps={fps}",
           os.path.join(out_path, f"%06d.{ext}")]
    subprocess.run(cmd, check=True)
    return out_path


def run_openpose(openpose_path: str, img_dir: str, out_dir: str,
                 video_out: Optional[str] = None,
                 img_out: Optional[str] = None) -> str:
    """Run the OpenPose binary for BODY_25 keypoints, max 1 person, JSON
    out. Requires a local OpenPose build."""
    binary = os.path.join(openpose_path, "build/examples/openpose/"
                          "openpose.bin")
    if not os.path.exists(binary):
        raise RuntimeError(
            f"OpenPose binary not found at {binary}; pass precomputed "
            "keypoints with --op-keypts instead")
    os.makedirs(out_dir, exist_ok=True)
    cmd = [binary,
           "--image_dir", os.path.abspath(img_dir),
           "--write_json", os.path.abspath(out_dir),
           "--display", "0",
           "--model_pose", "BODY_25",
           "--number_people_max", "1"]
    if img_out:
        os.makedirs(img_out, exist_ok=True)
        cmd += ["--write_images", os.path.abspath(img_out)]
    else:
        cmd += ["--render_pose", "0"]
    if video_out:
        cmd += ["--write_video", os.path.abspath(video_out)]
    subprocess.run(cmd, check=True, cwd=openpose_path)
    return out_dir


def run_deeplab_v3(img_dir: str, out_dir: str, batch_size: int = 16,
                   device: str = "cuda") -> str:
    """Person segmentation masks with torchvision DeepLabv3 (its weights
    need one download), on the card unless `device="cpu"`. Masks are
    white where a person occluder is NOT (mask != 0 means occluded in
    the loaders' convention -> here person pixels are 0)."""
    import numpy as np
    import torch
    from PIL import Image

    from humor_torch.device import resolve_device

    device = resolve_device(device)
    try:
        model = torch.hub.load("pytorch/vision", "deeplabv3_resnet50",
                               weights="DEFAULT")
    except Exception as e:  # no network / cache
        raise RuntimeError(
            f"could not load DeepLabv3 ({e}); provide masks manually") \
            from e
    model.eval().to(device)
    mean = torch.tensor([0.485, 0.456, 0.406]).view(3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(3, 1, 1)

    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(p for p in os.listdir(img_dir)
                   if p.endswith((".png", ".jpg")))
    with torch.no_grad():
        for i in range(0, len(paths), batch_size):
            batch_paths = paths[i: i + batch_size]
            imgs = []
            for p in batch_paths:
                im = np.asarray(Image.open(os.path.join(img_dir, p))
                                .convert("RGB"), np.float32) / 255.0
                t = torch.from_numpy(im).permute(2, 0, 1)
                imgs.append((t - mean) / std)
            out = model(torch.stack(imgs).to(device))["out"].argmax(1)
            person = (out == 15).cpu().numpy()  # VOC class 15 = person
            for p, m in zip(batch_paths, person):
                # occluder convention: non-person pixels are non-zero
                mask = ((~m) * 255).astype(np.uint8)
                Image.fromarray(mask).save(
                    os.path.join(out_dir,
                                 os.path.splitext(p)[0] + ".png"))
    return out_dir
