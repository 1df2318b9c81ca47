"""QuPath GeoJSON interop: masks → annotation polygons and back (the port's
own copy of the JAX package's ``data/geojson.py``, pure NumPy like it).

Closes the reference's QuPath loop in both directions, natively:

* **export** (`mask_to_polygons` + `polygons_to_geojson`): trace predicted
  binary masks into exact pixel-boundary polygons (exterior rings + holes)
  and write them as a QuPath-importable GeoJSON ``FeatureCollection`` —
  the annotation-object counterpart of the pyramidal-TIFF export
  (``data/tiffwriter.py``).  QuPath reads these via *File → Import objects*.
* **import** (`parse_geojson` + `rasterize_shapes`): read QuPath-exported
  annotations (the upstream artifact of the reference's
  ``QuPath_WSI_to_Patch.groovy``, which builds a ``LabeledImageServer``
  from annotation objects, ``QuPath_WSI_to_Patch.groovy:19-24``) and
  rasterize them into label masks — the in-repo replacement for the
  Groovy exporter's label rendering (SURVEY.md C14).

Everything is pure NumPy (host-side, runs once per slide — not a hot
path).  Polygon coordinates follow QuPath's convention: level-0 pixel
units, x right, y down.

Polygonization is **exact**: rings follow pixel boundaries (integer grid
vertices), so ``rasterize_shapes(mask_to_polygons(m)) == m`` bit-for-bit
(pinned by tests/test_geojson.py and, for this copy,
tests/test_torch_geojson.py).  Foreground connectivity is
4-connected (diagonal-only contacts trace as separate polygons), the
convention under which every traced ring is edge-disjoint and closed.
"""

from __future__ import annotations

import json
import math
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Ring = np.ndarray  # (N, 2) float64 [x, y], closed (first == last)
Polygon = Tuple[Ring, List[Ring]]  # (exterior, holes)
Shape = Tuple[int, List[Ring]]  # (label, [exterior, hole, hole, ...])

# direction codes for the boundary walk: 0=+x, 1=+y, 2=-x, 3=-y.
# With filled pixels kept on the RIGHT of the travel direction, a right
# turn is (d + 1) % 4 and exterior rings come out with positive shoelace
# area in image coordinates (y down).
_DX = np.array([1, 0, -1, 0])
_DY = np.array([0, 1, 0, -1])


def _boundary_edges(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Directed unit edges along the mask boundary, filled region on the
    right.  Returns (start_vertex, dir_code, end_vertex); vertices are
    encoded as ``y * (W + 1) + x`` on the (H+1)×(W+1) corner grid."""
    m = mask.astype(bool)
    h, w = m.shape
    pad = np.zeros((h + 2, w + 2), bool)
    pad[1:-1, 1:-1] = m
    stride = w + 1

    starts: List[np.ndarray] = []
    dirs: List[np.ndarray] = []
    # (neighbor slice, start-vertex offset (dy, dx) from the pixel, dir
    # code); exposures are computed one at a time — a gigapixel mask's
    # temporaries stay at one H×W bool, not four
    specs = (
        ((slice(None, -2), slice(1, -1)), 0, 0, 0),  # top:    (x,y)     +x
        ((slice(1, -1), slice(2, None)), 0, 1, 1),   # right:  (x+1,y)   +y
        ((slice(2, None), slice(1, -1)), 1, 1, 2),   # bottom: (x+1,y+1) -x
        ((slice(1, -1), slice(None, -2)), 1, 0, 3),  # left:   (x,y+1)   -y
    )
    for nb, dy, dx, code in specs:
        ys, xs = np.nonzero(m & ~pad[nb])
        starts.append((ys + dy) * stride + (xs + dx))
        dirs.append(np.full(ys.shape, code, np.int64))
    sv = np.concatenate(starts) if starts else np.empty(0, np.int64)
    dv = np.concatenate(dirs) if dirs else np.empty(0, np.int64)
    ev = sv + _DY[dv] * stride + _DX[dv]
    return sv, dv, ev


def _link_edges(sv: np.ndarray, dv: np.ndarray, ev: np.ndarray
                ) -> np.ndarray:
    """For each directed edge, the index of the next edge in its ring.

    At most one outgoing edge exists per (vertex, direction), so edges key
    uniquely as ``start * 4 + dir``.  Successor preference is right turn,
    straight, left turn — the right-turn-first rule keeps diagonally
    touching regions separate (4-connected foreground) and pairs each
    incoming edge with a unique outgoing edge, so the edge set decomposes
    into disjoint closed rings (no dead ends, no U-turns — a reversed
    duplicate of an edge would need the pixel above/below to be both
    filled and empty)."""
    keys = sv * 4 + dv
    order = np.argsort(keys)
    sorted_keys = keys[order]
    nxt = np.full(sv.shape, -1, np.int64)
    unresolved = np.arange(sv.shape[0])
    for turn in (1, 0, 3):  # right, straight, left
        want = ev[unresolved] * 4 + (dv[unresolved] + turn) % 4
        pos = np.searchsorted(sorted_keys, want)
        pos_c = np.minimum(pos, sorted_keys.size - 1)
        hit = sorted_keys[pos_c] == want
        nxt[unresolved[hit]] = order[pos_c[hit]]
        unresolved = unresolved[~hit]
        if unresolved.size == 0:
            break
    if unresolved.size:  # pragma: no cover - structurally impossible
        raise AssertionError("unclosed boundary ring")
    return nxt


def _trace_rings(mask: np.ndarray) -> List[np.ndarray]:
    """All boundary rings of ``mask`` as (N, 2) int arrays of [x, y] corner
    vertices, closed, collinear runs collapsed.  Positive shoelace area
    (image coords, y down) = exterior; negative = hole."""
    sv, dv, ev = _boundary_edges(mask)
    if sv.size == 0:
        return []
    nxt = _link_edges(sv, dv, ev)
    stride = mask.shape[1] + 1
    used = np.zeros(sv.shape, bool)
    rings: List[np.ndarray] = []
    for e0 in range(sv.shape[0]):
        if used[e0]:
            continue
        chain = []
        e = e0
        while not used[e]:
            used[e] = True
            chain.append(e)
            e = nxt[e]
        idx = np.asarray(chain)
        # keep only corner vertices (direction changes)
        corner = dv[idx] != dv[np.roll(idx, 1)]
        if not corner.any():  # pragma: no cover - can't happen on a grid
            corner[0] = True
        keep = idx[corner]
        pts = np.stack([sv[keep] % stride, sv[keep] // stride], axis=1)
        rings.append(np.concatenate([pts, pts[:1]], axis=0))
    return rings


def _signed_area(ring: np.ndarray) -> float:
    """Shoelace area in image coordinates (y down): positive for rings
    traced with the filled region on the right (exteriors)."""
    x, y = ring[:, 0], ring[:, 1]
    return float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]) / 2.0)


def _point_in_ring(px: float, py: float, ring: np.ndarray) -> bool:
    """Even-odd ray cast (ray toward +x)."""
    x, y = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    active = (np.minimum(y, y2) <= py) & (py < np.maximum(y, y2))
    if not active.any():
        return False
    xa, ya, xb, yb = x[active], y[active], x2[active], y2[active]
    xc = xa + (py - ya) * (xb - xa) / (yb - ya)
    return bool(np.count_nonzero(xc > px) % 2)


def _interior_point(ring: np.ndarray) -> Tuple[float, float]:
    """A point strictly on the LEFT of the ring's first segment — inside
    the enclosed background for hole rings (which keep filled pixels on
    the right).  Offset a quarter-unit both along and across the segment
    so neither coordinate lands on the integer grid (no ray-cast ties
    against other rectilinear rings)."""
    (x0, y0), (x1, y1) = ring[0], ring[1]
    dx, dy = x1 - x0, y1 - y0
    n = math.hypot(dx, dy)
    ux, uy = dx / n, dy / n
    return x0 + 0.25 * (ux + uy), y0 + 0.25 * (uy - ux)


def _simplify_ring(ring: np.ndarray, tol: float) -> np.ndarray:
    """Douglas–Peucker on a closed ring: anchor at vertex 0 and the vertex
    farthest from it, simplify both open chains, rejoin."""
    if tol <= 0 or ring.shape[0] <= 4:
        return ring
    pts = ring[:-1]
    far = int(np.argmax(np.sum((pts - pts[0]) ** 2, axis=1)))
    if far == 0:
        return ring
    a = _dp(pts[: far + 1], tol)
    b = _dp(np.concatenate([pts[far:], pts[:1]], axis=0), tol)
    out = np.concatenate([a[:-1], b[:-1]], axis=0)
    if out.shape[0] < 3:
        return ring
    return np.concatenate([out, out[:1]], axis=0)


def _dp(pts: np.ndarray, tol: float) -> np.ndarray:
    """Iterative Douglas–Peucker on an open polyline."""
    n = pts.shape[0]
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        seg = pts[j] - pts[i]
        ln = math.hypot(*seg)
        mid = pts[i + 1:j] - pts[i]
        if ln == 0:
            d = np.sqrt(np.sum(mid ** 2, axis=1))
        else:
            d = np.abs(mid[:, 0] * seg[1] - mid[:, 1] * seg[0]) / ln
        k = int(np.argmax(d))
        if d[k] > tol:
            k += i + 1
            keep[k] = True
            stack.append((i, k))
            stack.append((k, j))
    return pts[keep]


def mask_to_polygons(mask: np.ndarray, *, min_area: float = 0.0,
                     simplify_tol: float = 0.0, scale: float = 1.0,
                     offset: Tuple[float, float] = (0.0, 0.0)
                     ) -> List[Polygon]:
    """Trace a binary mask into polygons with holes.

    Rings follow pixel boundaries exactly (vertices on the corner grid),
    scaled by ``scale`` and shifted by ``offset=(x, y)`` into slide
    (level-0) coordinates.  ``min_area`` filters polygons below that area
    in *scaled* units²; ``simplify_tol`` runs Douglas–Peucker with a
    tolerance in scaled units (0 = exact).  Returns
    ``[(exterior, [holes...]), ...]`` sorted by descending area.
    """
    rings = _trace_rings(np.asarray(mask))
    exts: List[Tuple[float, np.ndarray]] = []
    holes: List[np.ndarray] = []
    for r in rings:
        a = _signed_area(r)
        if a >= 0:
            exts.append((a, r))
        else:
            holes.append(r)
    exts.sort(key=lambda t: t[0])  # ascending: match holes to smallest
    polys: List[Tuple[float, np.ndarray, List[np.ndarray]]] = [
        (a, r, []) for a, r in exts
    ]
    for hr in holes:
        px, py = _interior_point(hr)
        for _, ext, hs in polys:  # smallest containing exterior first
            if _point_in_ring(px, py, ext):
                hs.append(hr)
                break
    out: List[Polygon] = []
    ox, oy = offset
    shift = np.asarray([ox, oy], np.float64)
    for a, ext, hs in sorted(polys, key=lambda t: -t[0]):
        if a * scale * scale < min_area:
            continue
        e = _simplify_ring(ext.astype(np.float64) * scale + shift,
                           simplify_tol)
        out.append((e, [
            _simplify_ring(h.astype(np.float64) * scale + shift,
                           simplify_tol)
            for h in hs
        ]))
    return out


# ---------------------------------------------------------------------------
# GeoJSON writing (QuPath feature schema)
# ---------------------------------------------------------------------------

def polygons_to_geojson(polys: Sequence[Polygon], *,
                        class_name: str = "Tumor",
                        color: Tuple[int, int, int] = (200, 0, 0),
                        object_type: str = "annotation",
                        measurements: Optional[Dict[str, float]] = None
                        ) -> dict:
    """QuPath-importable ``FeatureCollection``: one Feature per polygon,
    classified ``class_name`` (the Groovy exporter's label name,
    ``QuPath_WSI_to_Patch.groovy:22``), coordinates in level-0 pixels."""
    feats = []
    for ext, holes in polys:
        coords = [ext.tolist()] + [h.tolist() for h in holes]
        props: dict = {
            "objectType": object_type,
            "classification": {"name": class_name, "color": list(color)},
        }
        if measurements:
            props["measurements"] = dict(measurements)
        feats.append({
            "type": "Feature",
            "id": str(uuid.uuid4()),
            "geometry": {"type": "Polygon", "coordinates": coords},
            "properties": props,
        })
    return {"type": "FeatureCollection", "features": feats}


def write_geojson(path: str, obj: dict) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


# ---------------------------------------------------------------------------
# GeoJSON reading + rasterization (the Groovy exporter's label rendering)
# ---------------------------------------------------------------------------

def _ring_array(coords: Sequence[Sequence[float]]) -> np.ndarray:
    r = np.asarray(coords, np.float64)
    if r.ndim != 2 or r.shape[1] < 2:
        raise ValueError(f"bad ring shape {r.shape}")
    r = r[:, :2]
    if not np.allclose(r[0], r[-1]):
        r = np.concatenate([r, r[:1]], axis=0)
    return r


def parse_geojson(obj, *, label_map: Optional[Dict[str, int]] = None,
                  default_label: Optional[int] = 1) -> List[Shape]:
    """Extract labeled polygon shapes from QuPath GeoJSON.

    Accepts a FeatureCollection, a Feature list, a single Feature, or a
    bare geometry; a path or JSON string also works.  ``label_map`` maps
    classification names to integer labels (the Groovy ``addLabel`` table,
    default ``{"Tumor": 1}``); features whose class is not in the map get
    ``default_label`` (or are skipped when it is None).  Each returned
    shape is ``(label, [exterior, holes...])``; MultiPolygons yield one
    shape per member polygon."""
    if isinstance(obj, str):
        if obj.lstrip().startswith(("{", "[")):
            obj = json.loads(obj)
        else:
            with open(obj) as f:
                obj = json.load(f)
    if label_map is None:
        label_map = {"Tumor": 1}
    if isinstance(obj, dict) and obj.get("type") == "FeatureCollection":
        feats = obj.get("features", [])
    elif isinstance(obj, list):
        feats = obj
    elif isinstance(obj, dict) and obj.get("type") == "Feature":
        feats = [obj]
    else:
        feats = [{"type": "Feature", "geometry": obj, "properties": {}}]

    shapes: List[Shape] = []
    for feat in feats:
        geom = feat.get("geometry") or {}
        props = feat.get("properties") or {}
        cls = props.get("classification") or {}
        name = cls.get("name") if isinstance(cls, dict) else None
        if name in label_map:
            label = label_map[name]
        elif default_label is None:
            continue
        else:
            label = default_label
        gtype = geom.get("type")
        if gtype == "Polygon":
            groups = [geom["coordinates"]]
        elif gtype == "MultiPolygon":
            groups = list(geom["coordinates"])
        else:
            continue  # points/lines can't rasterize to area labels
        for rings in groups:
            if not rings:
                continue
            shapes.append((label, [_ring_array(r) for r in rings]))
    return shapes


def _fill_even_odd(rings: Sequence[np.ndarray], h: int, w: int,
                   scale: float, offset: Tuple[float, float]) -> np.ndarray:
    """Even-odd scanline fill of a ring set onto an (h, w) grid whose pixel
    (r, c) covers level-0 coords ``[offset + (c, r)·scale, ·+scale)``;
    pixel centers are tested.  Holes are just additional rings (even-odd
    parity turns them off)."""
    flips = np.zeros((h, w + 1), np.uint8)
    ox, oy = offset
    for ring in rings:
        x = (ring[:, 0] - ox) / scale
        y = (ring[:, 1] - oy) / scale
        x1, y1, x2, y2 = x[:-1], y[:-1], x[1:], y[1:]
        # untrusted GeoJSON: drop horizontal and non-finite segments
        keep = ((y1 != y2) & np.isfinite(x1) & np.isfinite(y1)
                & np.isfinite(x2) & np.isfinite(y2))
        for ax, ay, bx, by in zip(x1[keep], y1[keep], x2[keep], y2[keep]):
            ylo, yhi = (ay, by) if ay < by else (by, ay)
            r0 = max(0, int(math.ceil(ylo - 0.5)))
            r1 = min(h, int(math.ceil(yhi - 0.5)))
            if r1 <= r0:
                continue
            rows = np.arange(r0, r1)
            xc = ax + (rows + 0.5 - ay) * (bx - ax) / (by - ay)
            cols = np.clip(np.floor(xc + 0.5).astype(np.int64), 0, w)
            np.add.at(flips, (rows, cols), 1)
    return (np.cumsum(flips[:, :w], axis=1) % 2).astype(bool)


def clean_mask(mask: np.ndarray, *, min_area: float = 0.0,
               fill_holes_area: float = 0.0) -> np.ndarray:
    """Morphology-free mask cleanup through the exact polygon pipeline:
    drop 4-connected foreground regions smaller than ``min_area`` px² and
    fill enclosed holes smaller than ``fill_holes_area`` px² (``inf`` =
    fill every hole).  With both thresholds 0 this is the identity
    (bit-exact round trip).  The standard post-processing step between a
    thresholded probability map and a clinical overlay/annotation export —
    the reference has no equivalent (its masks go straight to figures,
    ``test.py:152-178``)."""
    m = np.asarray(mask)
    polys = mask_to_polygons(m, min_area=min_area)
    shapes: List[Shape] = []
    for ext, holes in polys:
        kept = [h for h in holes if -_signed_area(h) >= fill_holes_area]
        shapes.append((1, [ext] + kept))
    out = rasterize_shapes(shapes, m.shape[0], m.shape[1])
    return out.astype(m.dtype) if m.dtype != np.bool_ else out.astype(bool)


def rasterize_shapes(shapes: Sequence[Shape], height: int, width: int, *,
                     scale: float = 1.0,
                     offset: Tuple[float, float] = (0.0, 0.0),
                     dtype=np.uint8) -> np.ndarray:
    """Paint labeled polygon shapes into a (height, width) label mask —
    the ``LabeledImageServer`` render of the Groovy exporter
    (``QuPath_WSI_to_Patch.groovy:19-24``: background 0, later labels
    overwrite earlier — "the order matters").  ``scale`` is the downsample
    (level-0 units per output pixel) and ``offset=(x, y)`` the level-0
    coordinate of the output's top-left corner."""
    if not (scale > 0 and math.isfinite(scale)):
        raise ValueError(f"scale must be positive and finite, got {scale}")
    mask = np.zeros((height, width), dtype)
    ox, oy = offset
    for label, rings in shapes:
        # fill only the shape's bounding box — a cohort of small polygons
        # on a gigapixel canvas must not pay O(shapes × canvas)
        pts = np.concatenate([r for r in rings], axis=0)
        finite = np.isfinite(pts).all(axis=1)
        if not finite.any():
            continue
        pts = pts[finite]
        x_lo = max(0, int(math.floor((pts[:, 0].min() - ox) / scale)) - 1)
        y_lo = max(0, int(math.floor((pts[:, 1].min() - oy) / scale)) - 1)
        x_hi = min(width, int(math.ceil((pts[:, 0].max() - ox) / scale)) + 1)
        y_hi = min(height,
                   int(math.ceil((pts[:, 1].max() - oy) / scale)) + 1)
        if x_hi <= x_lo or y_hi <= y_lo:
            continue
        inside = _fill_even_odd(
            rings, y_hi - y_lo, x_hi - x_lo, scale,
            (ox + x_lo * scale, oy + y_lo * scale))
        view = mask[y_lo:y_hi, x_lo:x_hi]
        view[inside] = label
    return mask
