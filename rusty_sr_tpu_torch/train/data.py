"""Image folders: the file listing of `rusty_sr_tpu/train/data.py`.

Only `list_images` is ported so far (the folder and watch modes use it);
the training pipeline comes with training.
"""

from __future__ import annotations

import os
from typing import List

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff", ".webp"}


def list_images(folder: str, recurse: bool = False) -> List[str]:
    """Image files in `folder` (optionally recursive), sorted for determinism."""
    out: List[str] = []
    if recurse:
        for root, _dirs, files in os.walk(folder):
            out += [os.path.join(root, f) for f in files
                    if os.path.splitext(f)[1].lower() in _IMG_EXTS]
    else:
        out = [os.path.join(folder, f) for f in os.listdir(folder)
               if os.path.splitext(f)[1].lower() in _IMG_EXTS]
    return sorted(out)
