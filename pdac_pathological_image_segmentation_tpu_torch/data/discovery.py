"""Dataset path discovery: the reference's filesystem contract (the JAX
package's ``data/discovery.py``).

A directory of ``*.png`` patches where mask files end in ``labelled.png``
and every other ``.png`` is an image (the QuPath export layout, reference
``train_main.py:46-67``).
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple


def discover_split(root: str) -> Tuple[List[str], List[str]]:
    """``(image_paths, mask_paths)``, both sorted."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"dataset directory does not exist: {root}")
    paths = sorted(glob.glob(os.path.join(root, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no .png patches found in {root}")
    masks = [p for p in paths if p.endswith("labelled.png")]
    images = [p for p in paths if not p.endswith("labelled.png")]
    if len(images) != len(masks):
        raise ValueError(
            f"unpaired patches in {root}: {len(images)} images vs "
            f"{len(masks)} masks (mask files must end in 'labelled.png')")
    return images, masks
