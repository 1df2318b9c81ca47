"""Whole-slide overlays: ``BandedSlidingWindow.run`` over procedural slides
made on the card (``DeviceSlideSource``), in the traffic's precision.

Set-up makes the weights from the seed, builds the runner (and in int8
calibrates on the first slide's first windows, as ``cli.overlay --int8``
does) and warms it on a slide of the same size whose grid holds one window
a band.  The window then starts whole slides, each with its own field,
while fewer than ``seconds`` have passed, and ends when the last one's
maps are on the host: ``slide_s`` is its length over the slides.  From
every slide it keeps the overlay at blocks drawn from the seed (corners,
both sides of a band boundary, and random ones), which the plain
reference (``reference/slide.py``) works out again after the window in
float32 (:func:`reference_readings`).  For int8 traffic the reference
also calibrates and quantizes again, on the same windows cut from its own
field, and the program's error is read against that scheme's own.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import models, quant
from benchmark.reference import slide as ref_slide
from benchmark.trace import Trace, span


def field_seed(seed: int, k: int) -> int:
    """Slide ``k``'s field seed: small, since the field adds it to a phase
    in float32."""
    return harness.sub_seed(seed, 1, k) % 10_007


def check_blocks(tr: dict, seed: int, k: int) -> list:
    """Slide ``k``'s check blocks ``(y, x, side)``, block-aligned."""
    side, size = tr["check_block"], tr["slide_side"]
    last = size // side - 1
    band = tr["band_rows"] // side
    rng = np.random.default_rng([seed % 2 ** 63, 2, k])
    cells = {(0, 0), (0, last), (last, 0), (last, last)}
    for row in (band - 1, band):  # both sides of the first band boundary
        cells.add((row, int(rng.integers(0, last + 1))))
    boundary = band * int(rng.integers(1, max(2, size // tr["band_rows"])))
    cells.update({(boundary - 1, int(rng.integers(0, last + 1))),
                  (boundary, int(rng.integers(0, last + 1)))})
    while len(cells) < tr["check_blocks"]:
        cells.add((int(rng.integers(0, last + 1)),
                   int(rng.integers(0, last + 1))))
    return [(r * side, c * side, side) for r, c in sorted(cells)]


def build_runner(cell, sd, dev, first_source):
    """``(runner, pieces to free)``: the program's banded runner of the
    cell's configuration, with the int8 step where the traffic asks."""
    from pdac_pathological_image_segmentation_tpu_torch.infer import (
        quantized,
        wsi,
    )

    tr = cell.traffic
    pcfg, model = harness.program_model(cell.config, sd, dev)
    infer_step = None
    if tr["precision"] == "int8":
        calib = np.stack([first_source.get(i)[0]
                          for i in range(tr["calibration_windows"])])
        bundle, forward = quantized.quantize_from_config(
            pcfg, model.state_dict(), [calib])
        infer_step = quantized.make_quantized_infer_step(
            model.state_dict(), bundle, tr["tile"], forward)
    elif tr["precision"] != "bf16":
        raise ValueError(f"unknown precision {tr['precision']!r}")
    runner = wsi.BandedSlidingWindow(
        model, tile=tr["tile"], batch_size=tr["batch"],
        band_h=tr["band_rows"], blend=tr["blend"], infer_step=infer_step)
    return runner, [model, infer_step]


def integer_scheme(cfg: dict, bits: int, amax: dict):
    return quant.integer(bits, amax, cfg.get("int8_float_sites", ()))


def source(tr: dict, seed: int, dev):
    from pdac_pathological_image_segmentation_tpu_torch.data.synthetic import (
        DeviceSlideSource,
    )

    return DeviceSlideSource(tr["slide_side"], tile=tr["tile"],
                             stride=tr["stride"], seed=seed, device=dev)


def warm(runner, tr: dict, seed: int, dev) -> None:
    """One run over a slide of the cell's size whose grid holds the first
    window of each band: every shape, buffer and host array of a slide."""
    src = source(tr, field_seed(seed, 2 ** 20), dev)
    src.coords = [(y, 0) for y in range(0, tr["slide_side"] - tr["tile"] + 1,
                                        tr["band_rows"])]
    runner.run(src)


def crop(prob: np.ndarray, mask: np.ndarray, blocks) -> list:
    return [(prob[y:y + s, x:x + s].copy(), mask[y:y + s, x:x + s].copy())
            for y, x, s in blocks]


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def compare(got: list, want: list, margin: float,
            scheme: list | None = None) -> dict:
    """Numbers of a check: ``got`` ``[(prob, mask)]`` host crops of the
    program's maps, ``want`` the reference's float32 overlays (tensors).

    * ``prob_gap_max``: the widest probability gap;
    * ``logit_gap_mean`` and ``logit_gap_max``: the gaps of the logits
      where the reference's probability lies in [0.05, 0.95] (elsewhere a
      float16 probability holds too little of its logit), which do not
      depend on how much of a slide a seed's weights saturate;
    * ``logit_gap_ratio``, where ``scheme`` holds the reference's own
      overlays in the traffic's integer scheme (as returned): the
      program's ``logit_gap_mean`` over the scheme's, on the same pixels,
      so the error that the scheme itself makes is the unit;
    * ``mask_flips``: pixels whose mask disagrees with the reference's
      though the reference's logit lies more than ``margin`` from 0."""
    prob, logit, own, flips = [], [], [], 0
    for i, ((p, m), ref) in enumerate(zip(got, want)):
        r = ref.float().cpu()
        q = torch.from_numpy(p.astype(np.float32))
        prob.append((q - r).abs().reshape(-1))
        inside = (r >= 0.05) & (r <= 0.95)
        logit.append((_logit(q) - _logit(r)).abs()[inside])
        if scheme is not None:
            s = torch.from_numpy(scheme[i][0].astype(np.float32))
            own.append((_logit(s) - _logit(r)).abs()[inside])
        decided = _logit(r).abs() > margin
        flips += int(((torch.from_numpy(m).bool() != (r >= 0.5))
                      & decided).sum())
    prob, logit = torch.cat(prob), torch.cat(logit)
    out = {"prob_gap_max": float(prob.max()),
           "logit_gap_mean": float(logit.mean()) if logit.numel() else 0.0,
           "logit_gap_max": float(logit.max()) if logit.numel() else 0.0,
           "mask_flips": flips}
    if scheme is not None:
        own = torch.cat(own)
        out["logit_gap_ratio"] = (out["logit_gap_mean"]
                                  / max(float(own.mean()), 1e-12)
                                  if own.numel() else 0.0)
    return out


def as_returned(overlays: list) -> list:
    """Overlays computed in the program's place, in the form the runner
    returns them: float16 probabilities, the mask at 0.5."""
    return [(o.float().cpu().numpy().astype(np.float16),
             (o >= 0.5).to(torch.uint8).cpu().numpy()) for o in overlays]


def reference_overlays(model, tr: dict, fseed: int, blocks, dev) -> list:
    windows = ref_slide.block_windows(blocks, tr["slide_side"], tr["tile"],
                                      tr["stride"])
    probs = ref_slide.window_probs(model, windows, fseed, tr["tile"], dev,
                                   tr["batch"])
    return [ref_slide.block_overlay(probs, b, tr["slide_side"], tr["tile"],
                                    tr["stride"], tr["blend"], dev)
            for b in blocks]


def reference_readings(cell, sd, dev, slides: list, margin: float,
                       control: bool = False) -> list:
    """The check's numbers (:func:`compare`) of each slide ``(got, field
    seed, blocks)`` of a run, the first being the one the program
    calibrated on.  The plain model works the blocks out in float32; for
    int8 traffic also in the integer scheme (``quant.integer``) at the
    activation amax that the float32 model reads on that slide's first
    ``calibration_windows`` windows, cut from its own field.  With
    ``control`` the control stands in the program's place (``got`` is not
    read): the plain model a precision below the traffic's, fp8 below
    bf16, int4 below int8 at the same calibration."""
    tr, cfg = cell.traffic, cell.config
    model = harness.reference_model(cfg, sd, dev)

    def overlays(quantizer) -> list:
        models.set_quantizer(model, quantizer)
        return [reference_overlays(model, tr, fseed, blocks, dev)
                for _, fseed, blocks in slides]

    want, scheme = overlays(None), [None] * len(slides)
    amax = None
    if tr["precision"] == "int8":
        windows = ref_slide.first_windows(
            tr["calibration_windows"], tr["slide_side"], tr["tile"],
            tr["stride"], slides[0][1], dev)
        amax = quant.calibrate(model, [models.normalize_u8(windows)])
        scheme = [as_returned(o)
                  for o in overlays(integer_scheme(cfg, 8, amax))]
    elif tr["precision"] != "bf16":
        raise ValueError(f"unknown precision {tr['precision']!r}")
    got = [g for g, _, _ in slides]
    if control:
        got = [as_returned(o) for o in overlays(
            quant.fp8 if amax is None else integer_scheme(cfg, 4, amax))]
    return [compare(g, w, margin, s) for g, w, s in zip(got, want, scheme)]


def run(cell) -> harness.Outcome:
    tr, dev = cell.traffic, torch.device(cell.device)
    harness.log(cell, "set-up starts")
    sd = harness.weights(cell.config, cell.seed, dev)
    runner, owned = build_runner(cell, sd, dev,
                                 source(tr, field_seed(cell.seed, 0), dev))
    harness.log(cell, "weights made, runner built")
    warm(runner, tr, cell.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    harness.log(cell, "warmed; the window starts")

    kept, seeds, blocks = [], [], []
    with Trace(cell.trace) as trace:
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        while True:
            k = len(kept)
            seeds.append(field_seed(cell.seed, k))
            blocks.append(check_blocks(tr, cell.seed, k))
            t_slide = time.perf_counter()
            with span("slide.run"):
                prob, mask = runner.run(source(tr, seeds[k], dev))
            with span("slide.keep"):
                kept.append(crop(prob, mask, blocks[k]))
            del prob, mask
            harness.log(cell, f"slide {k}: "
                        f"{time.perf_counter() - t_slide:.3f} s")
            if cell.trace or time.perf_counter() - t0 >= cell.seconds:
                break
        window = time.perf_counter() - t0
    n = len(kept)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = trace.summary() if cell.trace else None
    stats = dict(runner.last_run)
    del runner, owned
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    harness.log(cell, f"window closed: {n} slide(s) in {window:.3f} s")
    checks, failed = harness.judge(cell.limits, reference_readings(
        cell, sd, dev, list(zip(kept, seeds, blocks)),
        cell.limits["mask_margin_logit"]))
    harness.log(cell, "reference compared")
    windows = len(ref_slide.grid(tr["slide_side"], tr["tile"],
                                 tr["stride"])) ** 2
    return harness.Outcome(
        attempted=n, failed=failed,
        e2e={"slide_s": window / n, "setup_s": setup_s},
        work={"windows": n * windows, "slides": n,
              "batches": n * batches_per_slide(tr),
              "window_s": window, "bands": stats.get("bands")},
        checks=checks, peak_bytes=peak, trace=summary)


def batches_per_slide(tr: dict) -> int:
    """The runner's batches a slide: per band, its windows (those whose
    top edge lies in it) in batches of ``batch``, the last one padded."""
    ys = ref_slide.grid(tr["slide_side"], tr["tile"], tr["stride"])
    n_bands = -(-tr["slide_side"] // tr["band_rows"])
    rows = Counter(min(y // tr["band_rows"], n_bands - 1) for y in ys)
    return sum(-(-n * len(ys) // tr["batch"]) for n in rows.values())
