"""Batched multi-slide inference sweep (BASELINE.json config #5; the JAX
package's ``infer/sweep.py``) on one device.

Slides stream one after another through :class:`SlidingWindowInference`:
each slide's tiles go to the device in batches, stitching stays on the
device, and the host fetches each finished map once.  The JAX sweep's
mesh path (tiles batch-sharded across chips, the banded halo-exchange
runner, slides split across hosts by process index) is not ported yet
(``ROADMAP.md`` Queue 1 item 4.5): here the slides are all process 0's of
1.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from pdac_pathological_image_segmentation_tpu_torch.data.geojson import (
    mask_to_polygons,
    polygons_to_geojson,
    write_geojson,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi import (
    GridTiler,
    SlidingWindowInference,
)


def run_sweep(
    model,
    slides: Sequence,  # items: np.ndarray slides OR tile sources
    mesh=None,
    tile: int = 512,
    stride: Optional[int] = None,
    batch_size: int = 64,
    blend: str = "hann",
    tta: bool = False,
    sharded: bool = False,
    out_dir: Optional[str] = None,
    infer_step=None,
    geojson: bool = False,
    geojson_min_area: float = 0.0,
    geojson_simplify: float = 0.0,
    device=None,
) -> List[Dict]:
    """Segment every slide; returns per-slide result dicts (mask and prob
    saved to ``out_dir`` as ``slide_{i:04d}_{prob,mask}.npy`` instead of
    kept in memory).

    ``model`` is an eval-ready module on its device (the JAX function's
    ``(model, state)``).  A numpy slide (H×W×3 uint8) is tiled by
    ``GridTiler`` at ``stride or tile``; any other item is a tile source
    (``TiffSlideSource``, ``DeviceSlideSource``, ``PyHISTTileSource``…)
    read through its ``get``.

    ``geojson=True`` additionally polygonizes each slide's mask into
    QuPath-importable annotations (``data/geojson.py``): written as
    ``slide_{i:04d}_annotations.geojson`` under ``out_dir``, or returned
    under ``rec["geojson"]``.

    ``infer_step``: optional ``step(images_u8) → probs`` on the device (a
    serving artifact's ``step``, the int8 path), with ``device`` naming
    where it runs when ``model`` is None.

    ``sharded=True`` or a ``mesh`` raises ``NotImplementedError``: the
    multi-device sweep is ``ROADMAP.md`` Queue 1 item 4.5."""
    if sharded or mesh is not None:
        raise NotImplementedError(
            "the sharded multi-device sweep (sharded=True, mesh=) is not "
            "ported yet: ROADMAP.md Queue 1 item 4.5")
    runner = SlidingWindowInference(
        model, tile=tile, batch_size=batch_size, blend=blend, tta=tta,
        infer_step=infer_step, device=device)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    results: List[Dict] = []
    for i, slide in enumerate(slides):
        source = (
            GridTiler(slide, tile=tile, stride=stride or tile)
            if isinstance(slide, np.ndarray) else slide
        )
        t0 = time.perf_counter()
        prob, mask = runner.run(source)
        dt = time.perf_counter() - t0
        rec: Dict = {
            "slide": i,
            "n_tiles": len(source),
            "canvas_hw": tuple(source.canvas_hw),
            "tumor_fraction": float(mask.mean()),
            "seconds": dt,
        }
        if out_dir:
            np.save(os.path.join(out_dir, f"slide_{i:04d}_prob.npy"), prob)
            np.save(os.path.join(out_dir, f"slide_{i:04d}_mask.npy"), mask)
        else:
            rec["prob"] = prob
            rec["mask"] = mask
        if geojson:
            fc = polygons_to_geojson(
                mask_to_polygons(mask, min_area=geojson_min_area,
                                 simplify_tol=geojson_simplify),
                measurements={"tumor_fraction": rec["tumor_fraction"]},
            )
            rec["n_regions"] = len(fc["features"])
            if out_dir:
                write_geojson(
                    os.path.join(out_dir,
                                 f"slide_{i:04d}_annotations.geojson"), fc)
            else:
                rec["geojson"] = fc
        results.append(rec)
    return results
