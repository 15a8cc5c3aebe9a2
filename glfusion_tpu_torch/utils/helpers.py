"""Image and logging helpers (port of ``glfusion_tpu/utils/helpers.py``;
reference ``utils/helpers.py``).

``maybe_download`` keeps the reference's local-cache contract without any
network access: it loads a file already in the cache directory, or raises
``FileNotFoundError``. It never fetches. A local torchvision resnet50 file
goes to ``--imagenet-backbone`` (``utils/imagenet_init.py``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from glfusion_tpu_torch.utils.visualize import COLOR_TABLE

IMG_SCALE = 1.0 / 255
IMG_MEAN = np.array([0.485, 0.456, 0.406]).reshape((1, 1, 3))
IMG_STD = np.array([0.229, 0.224, 0.225]).reshape((1, 1, 3))

logger = None  # an open file, or None: print_log also writes there


def print_log(message) -> None:
    """Print, and write to ``logger`` when set (reference helpers.py:15-19)."""
    print(message, flush=True)
    if logger:
        logger.write(str(message) + "\n")


def maybe_download(model_name: str, model_url: str,
                   model_dir: Optional[str] = None):
    """The state dict cached at ``<model_dir>/<model_name>.pth.tar``
    (default ``$TORCH_MODEL_ZOO``, else ``$TORCH_HOME/models``, else
    ``~/.torch/models``); raises ``FileNotFoundError`` naming the path and
    the URL when it is not there."""
    if model_dir is None:
        torch_home = os.path.expanduser(os.getenv("TORCH_HOME", "~/.torch"))
        model_dir = os.getenv("TORCH_MODEL_ZOO",
                              os.path.join(torch_home, "models"))
    cached = Path(model_dir) / f"{model_name}.pth.tar"
    if not cached.exists():
        raise FileNotFoundError(
            f"pretrained weights not cached at {cached} (url was "
            f"{model_url}); nothing is downloaded: place the file there "
            "if pretrained init is required")
    import torch

    return torch.load(str(cached), map_location="cpu")


def prepare_img(img: np.ndarray) -> np.ndarray:
    """ImageNet normalization of an (H, W, 3) uint8 image (reference :38)."""
    return (img * IMG_SCALE - IMG_MEAN) / IMG_STD


def make_validation_img(img: np.ndarray, lab: np.ndarray,
                        pre: np.ndarray) -> np.ndarray:
    """Side-by-side [image | label | prediction] uint8 panel; classes are
    colored by the visualization table (reference :42-62, without its
    depth stream)."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    img8 = np.clip(img * 255 if img.max() <= 1.0 else img,
                   0, 255).astype(np.uint8)
    lab_rgb = COLOR_TABLE[np.asarray(lab, np.int64)][..., :3]
    pre_rgb = COLOR_TABLE[np.asarray(pre, np.int64)][..., :3]
    return np.concatenate([img8, lab_rgb, pre_rgb], axis=1)
