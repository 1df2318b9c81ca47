"""H&E stain normalization on the device (the JAX package's
``ops/stain.py``), on NHWC float RGB in [0, 1].

* Reinhard: each image's per-channel LAB mean and std matched to those of
  :func:`reference_lab_stats`.
* Macenko: each image's H&E basis from the top-2 eigenvectors of its
  optical-density covariance over tissue pixels (OD norm above
  :data:`BETA`), the angles' ``ALPHA`` and ``100 − ALPHA`` nearest
  percentiles, and the concentrations' 99th nearest percentile; the image
  is then unmixed and remapped onto the reference basis.

The JAX package's defaults (``alpha=1``, ``beta=0.15``, the reference
target) are the only values its callers pass, so they are constants here.

Plain PyTorch: the JAX package leaves both to XLA.  The percentiles are
``jnp.nanpercentile(..., method="nearest")`` index for index
(:func:`nanpercentile_nearest`), written as a sort of the tissue values and
an explicit index rather than ``torch.nanquantile``, whose input-size limit
a batch of 512² tiles can reach.  Unlike the JAX fit, which keeps the
eigenvector signs its solver returns, the port fixes them and takes the
covariance and its eigenvectors in float64, so that the card and the CPU
give the same tile; the two agree with JAX wherever the tissue angles do
not straddle ±π under XLA's signs.  Compare bases and outputs, not raw
eigenvectors.  The constants are numpy, as in the JAX module.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

REFERENCE_STAIN_BASIS = np.asarray(
    [[0.5626, 0.2159],
     [0.7201, 0.8012],
     [0.4062, 0.5581]], dtype=np.float32)
REFERENCE_MAX_CONC = np.asarray([1.9705, 1.0308], dtype=np.float32)

_EPS = 1e-6
ALPHA = 1.0  # Macenko's angle percentile
BETA = 0.15  # Macenko's tissue threshold on the OD norm

_RGB2LMS = np.asarray(
    [[0.3811, 0.5783, 0.0402],
     [0.1967, 0.7244, 0.0782],
     [0.0241, 0.1288, 0.8444]], dtype=np.float32)
_LMS2LAB_A = (np.diag(1.0 / np.sqrt(np.asarray([3.0, 6.0, 2.0])))
              @ np.asarray([[1.0, 1.0, 1.0],
                            [1.0, 1.0, -2.0],
                            [1.0, -1.0, 0.0]])).astype(np.float32)
_LAB2LMS = np.linalg.inv(_LMS2LAB_A.astype(np.float64)).astype(np.float32)
_LMS2RGB = np.linalg.inv(_RGB2LMS.astype(np.float64)).astype(np.float32)

METHODS = ("none", "reinhard", "macenko")


class LabStats(NamedTuple):
    mean: np.ndarray  # (3,)
    std: np.ndarray  # (3,)


class StainBasis(NamedTuple):
    basis: torch.Tensor  # (N, 3, 2) H and E OD vectors (columns)
    max_conc: torch.Tensor  # (N, 2) 99th-percentile concentrations


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    lms = rgb @ _t(_RGB2LMS, rgb).T
    log_lms = torch.log10(torch.clamp_min(lms, _EPS))
    return log_lms @ _t(_LMS2LAB_A, rgb).T


def _lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    log_lms = lab @ _t(_LAB2LMS, lab).T
    lms = torch.pow(10.0, log_lms)
    return torch.clamp(lms @ _t(_LMS2RGB, lab).T, 0.0, 1.0)


@functools.lru_cache(maxsize=1)
def reference_lab_stats() -> LabStats:
    """LAB statistics of a synthetic H&E tile made from the reference stain
    basis by Beer-Lambert over a grid of concentrations (numpy, as in the
    JAX package): the Reinhard target when no slide is fitted."""
    c = np.linspace(0.05, 1.0, 64)
    g1, g2 = np.meshgrid(c * REFERENCE_MAX_CONC[0], c * REFERENCE_MAX_CONC[1])
    conc = np.stack([g1.ravel(), g2.ravel()])
    od = REFERENCE_STAIN_BASIS @ conc
    rgb = np.power(10.0, -od).T.astype(np.float64)
    lms = rgb @ _RGB2LMS.T
    lab = np.log10(np.maximum(lms, _EPS)) @ _LMS2LAB_A.T
    return LabStats(lab.mean(axis=0).astype(np.float32),
                    (lab.std(axis=0) + _EPS).astype(np.float32))


def reinhard_normalize(rgb: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) [0, 1] → each image's LAB statistics matched to
    :func:`reference_lab_stats`."""
    target = reference_lab_stats()
    lab = _rgb_to_lab(rgb)
    mean = lab.mean(dim=(1, 2), keepdim=True)
    std = lab.std(dim=(1, 2), keepdim=True, correction=0) + _EPS
    lab = (lab - mean) / std * _t(target.std, rgb) + _t(target.mean, rgb)
    return _lab_to_rgb(lab)


def nanpercentile_nearest(values: torch.Tensor, valid: torch.Tensor,
                          percent: float) -> torch.Tensor:
    """``jnp.nanpercentile(where(valid, values, nan), percent, axis=-1,
    method="nearest")``, index for index: the valid values sorted first,
    position ``q·(n − 1)`` in float32 with ``q = percent / 100``, the lower
    neighbour where the fraction is at most 0.5 (a tie goes down), the
    index clamped to ``[0, n − 1]`` (NaN where no value is valid)."""
    x = torch.where(valid, values, torch.full_like(values, float("nan")))
    srt = torch.sort(x, dim=-1).values  # NaN sorts last
    n = valid.sum(dim=-1, dtype=torch.float32)
    q = torch.tensor(percent, dtype=torch.float32) / torch.tensor(
        100.0, dtype=torch.float32)
    pos = q.to(values.device) * (n - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    zero = torch.zeros_like(low)
    low = torch.maximum(zero, torch.minimum(low, n - 1.0))
    high = torch.maximum(zero, torch.minimum(high, n - 1.0))
    idx = torch.where(pos - torch.floor(pos) <= 0.5, low, high).long()
    return torch.gather(srt, -1, idx.unsqueeze(-1)).squeeze(-1)


def _compute_dtype(rgb: torch.Tensor) -> torch.dtype:
    """float32 for a bfloat16 input, the input's own dtype otherwise."""
    return torch.promote_types(rgb.dtype, torch.float32)


def _optical_density(rgb: torch.Tensor) -> torch.Tensor:
    """``-log10(max(rgb, eps))`` in ``rgb``'s dtype."""
    return -torch.log10(torch.clamp_min(rgb, _EPS))


def _concentrations(od: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(N, P, 3) OD and (N, 3, 2) bases → (N, 2, P) least-squares
    concentrations.  A singular ``bᵀb`` (a tile of one colour, whose two
    stain vectors coincide) gives non-finite values, as ``jnp.linalg.inv``
    does, instead of raising."""
    bt = basis.transpose(1, 2)
    pinv = torch.linalg.inv_ex(bt @ basis).inverse @ bt
    return pinv @ od.to(basis.dtype).transpose(1, 2)


def macenko_stain_matrix(rgb: torch.Tensor) -> StainBasis:
    """Each image's H&E basis and 99th-percentile concentrations, (N, H, W,
    3) [0, 1] → ``StainBasis((N, 3, 2), (N, 2))``.  Background pixels (OD
    norm at most ``BETA``) weigh zero in the covariance and are left out of
    the percentiles."""
    n = rgb.shape[0]
    od_in = _optical_density(rgb).reshape(n, -1, 3)
    tissue = torch.linalg.vector_norm(od_in, dim=2) > BETA
    od = od_in.to(_compute_dtype(rgb))
    w = tissue.float().unsqueeze(2)
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)  # (N, 1)
    mean = (od * w).sum(dim=1) / cnt
    # the covariance and its eigenvectors in float64, on every device: in
    # float32 cuBLAS's sums over a 512² tile drift ~1e-4 (relative) where
    # the CPU's stay ~1e-7, and cuSOLVER's batched eigh is looser than
    # LAPACK's; the plane follows both
    centered = ((od - mean.unsqueeze(1)) * w).double()
    cov = centered.transpose(1, 2) @ centered / cnt.unsqueeze(2).double()
    _, vecs = torch.linalg.eigh(cov)
    plane = vecs[:, :, 1:3].to(od.dtype)  # ascending: the last two
    # each eigenvector's sign is the solver's choice (LAPACK's, cuSOLVER's
    # and XLA's differ) and turns the angles below by π or mirrors them;
    # where the tissue angles then straddle ±π the percentiles take other
    # pixels.  Each axis points its largest component up, on every device.
    big = plane.abs().argmax(dim=1, keepdim=True)
    plane = plane * torch.where(torch.gather(plane, 1, big) < 0, -1.0, 1.0)
    proj = od @ plane
    phi = torch.atan2(proj[..., 1], proj[..., 0])
    lo = nanpercentile_nearest(phi, tissue, ALPHA)
    hi = nanpercentile_nearest(phi, tissue, 100.0 - ALPHA)
    v1 = (plane @ torch.stack([torch.cos(lo), torch.sin(lo)], 1)
          .unsqueeze(2)).squeeze(2)
    v2 = (plane @ torch.stack([torch.cos(hi), torch.sin(hi)], 1)
          .unsqueeze(2)).squeeze(2)
    v1 = v1 * torch.sign(v1.sum(dim=1, keepdim=True) + _EPS)
    v2 = v2 * torch.sign(v2.sum(dim=1, keepdim=True) + _EPS)
    # hematoxylin has the larger first (red-OD) component
    first_is_h = (v1[:, 0] > v2[:, 0]).unsqueeze(1)
    h = torch.where(first_is_h, v1, v2)
    e = torch.where(first_is_h, v2, v1)
    basis = torch.stack([h, e], dim=2)
    basis = basis / (torch.linalg.vector_norm(basis, dim=1, keepdim=True)
                     + _EPS)
    conc = _concentrations(od_in, basis)
    max_conc = nanpercentile_nearest(
        conc, tissue.unsqueeze(1).expand_as(conc), 99.0)
    return StainBasis(basis, max_conc)


def macenko_normalize(rgb: torch.Tensor, source: StainBasis) -> torch.Tensor:
    """Remap each image from its ``source`` basis onto the reference
    basis."""
    n = rgb.shape[0]
    conc = _concentrations(_optical_density(rgb).reshape(n, -1, 3),
                           source.basis)
    scale = _t(REFERENCE_MAX_CONC, conc) / torch.clamp_min(source.max_conc,
                                                           _EPS)
    od_out = _t(REFERENCE_STAIN_BASIS, conc) @ (conc * scale.unsqueeze(-1))
    out = torch.pow(10.0, -od_out).transpose(1, 2).reshape(rgb.shape)
    return torch.clamp(out, 0.0, 1.0)


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown stain method {method!r} (one of "
                         f"{METHODS})")


def apply_stain_batch(imgs01: torch.Tensor, method: str) -> torch.Tensor:
    """Per-image stain normalization of (N, H, W, 3) float RGB in [0, 1];
    ``method`` is one of ``none``, ``reinhard``, ``macenko``.

    A bfloat16 batch (the bf16 train chain's) is computed as the JAX
    function computes it, where numpy's float32 constants promote: Reinhard
    on its float32 values; Macenko with the optical density, and the
    tissue test on its norm, in bfloat16 and the rest in float32.  The
    result is then float32, as JAX's is."""
    if method in (None, "", "none"):
        return imgs01
    check_method(method)
    if method == "reinhard":
        return reinhard_normalize(imgs01.to(_compute_dtype(imgs01)))
    return macenko_normalize(imgs01, macenko_stain_matrix(imgs01))
