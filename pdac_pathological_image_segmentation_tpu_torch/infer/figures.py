"""Per-sample original/label/prediction triptychs (the JAX package's
``infer/figures.py``; reference ``test.py:128-178``): three panels,
"original", "label" and "predicted", the mask panels in ``inferno``,
saved as ``figure_{N}.png``.  matplotlib is imported only when a figure
is drawn, so an evaluation without figures does not need it.
"""

from __future__ import annotations

import os

import numpy as np


def save_triptych(figure_path: str, index: int, image01: np.ndarray,
                  label: np.ndarray, pred: np.ndarray) -> str:
    """Write ``figure_{index}.png``: ``image01`` (H, W, 3) in [0, 1]
    (already denormalized), ``label`` and ``pred`` (H, W)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matplotlib.rcParams["image.cmap"] = "inferno"  # reference test.py:134

    fig = plt.figure()
    for i, (title, panel) in enumerate((("original", np.clip(image01, 0, 1)),
                                        ("label", label),
                                        ("predicted", pred))):
        ax = fig.add_subplot(1, 3, i + 1)
        ax.set_title(title)
        ax.imshow(panel)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    out = os.path.join(figure_path, f"figure_{index}.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out
