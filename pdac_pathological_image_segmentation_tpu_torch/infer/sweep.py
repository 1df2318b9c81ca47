"""Batched multi-slide inference sweep (BASELINE.json config #5; the JAX
package's ``infer/sweep.py``).

Slides stream one after another through :class:`SlidingWindowInference`
(one device), or with ``sharded=True`` through
:class:`~.wsi_sharded.ShardedSlidingWindow` over a device list (bands
across devices, the halo exchanged once per slide): each slide's tiles go
to the devices in batches, stitching stays on the devices, and the host
fetches each finished map once.  In a process group the slides are split
round-robin by rank (each rank segments its own), as the JAX sweep splits
them by process index.
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
    _runner_device,
)
from pdac_pathological_image_segmentation_tpu_torch.infer.wsi_sharded import (
    ShardedSlidingWindow,
)
from pdac_pathological_image_segmentation_tpu_torch.parallel import (
    mesh as parallel_mesh,
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

    ``sharded=True`` runs the band-sharded runner over ``mesh`` (a device
    list; default ``create_mesh()``, every visible card, or one CPU) with
    ``batch_per_device = max(1, batch_size // D)``, as the JAX sweep; it
    pays for slides whose canvas does not fit one device.  ``mesh`` alone
    is ignored, as in the JAX sweep."""
    rank, world = parallel_mesh.rank(), parallel_mesh.world_size()
    if sharded:
        devices = list(mesh) if mesh is not None else \
            parallel_mesh.create_mesh(device=_runner_device(model, device))
        runner = ShardedSlidingWindow(
            model, devices, tile=tile,
            batch_per_device=max(1, batch_size // len(devices)),
            blend=blend, tta=tta, infer_step=infer_step)
    else:
        runner = SlidingWindowInference(
            model, tile=tile, batch_size=batch_size, blend=blend, tta=tta,
            infer_step=infer_step, device=device)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    results: List[Dict] = []
    for i, slide in enumerate(slides):
        if i % world != rank:
            continue  # another rank's slide
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
