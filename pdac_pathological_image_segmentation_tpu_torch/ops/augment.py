"""Device-side augmentation (the JAX package's ``ops/augment.py``), NCHW.

The train chain of the reference (``train_main.py:70-81``):

* default mode: uint8 pixels → ``/255`` → slot-matrix ColorJitter on
  [0, 1] with clipping (p = 0.5) → ImageNet normalize → OneOf{hflip,
  rot90(k), vflip} (p = 0.3), masks sharing the geometry.  Every
  ColorJitter op on [0, 1] RGB is the affine map ``x ← clip(A @ x +
  γ·mean_gray(x))`` with a per-sample, per-slot 3×3 ``A`` and scalar
  ``γ``; the random op order lives in which matrix sits in which slot;
* ``parity_mode``: the reference's own order, normalize first, then the
  four ColorJitter ops (:func:`color_jitter`) on the normalized floats
  without clipping, then the OneOf.

The random draws happen outside the chain, as in the JAX package:
:func:`draw_augment_scalars` draws ``(facs, ints)`` from a
``torch.Generator`` with the JAX draws' distributions (the streams differ),
:func:`jitter_slot_params` and :func:`geom_bits` turn them into the tables
the chain and the kernel consume.  The draws of both modes are the same
table: the JAX package draws the parity chain's factors, order, apply bits
and OneOf choice with the key splits of ``draw_augment_scalars`` too.
Every function takes injected draws, so tests can feed it the JAX
package's.

:func:`train_transform` is the non-fused chain (the JAX ``train_transform``)
in any float dtype, with the resize on ingest and the stain hook
(``ops/stain.py``); the train step takes it wherever the fused kernel
(``ops/fused_augment.py``) does not apply.  :func:`fused_chain_bf16` is
the kernel's plain version: the default chain in bfloat16 at the native
size.  The chain's per-sample choices (geometry, parity-mode op order) are
made on the host from the host's draws, so a chain on the card never waits
for it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pdac_pathological_image_segmentation_tpu_torch import host_to_device
from pdac_pathological_image_segmentation_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_nearest,
)
from pdac_pathological_image_segmentation_tpu_torch.ops.stain import (
    apply_stain_batch,
    check_method,
)

_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_STD = np.asarray(IMAGENET_STD, np.float32)
_GRAY_W = np.asarray([0.299, 0.587, 0.114], np.float32)
_T_YIQ = np.asarray(
    [[0.299, 0.587, 0.114],
     [0.59590059, -0.27455667, -0.32134392],
     [0.21153661, -0.52273617, 0.31119955]], np.float32)
_T_RGB = np.linalg.inv(_T_YIQ).astype(np.float32)
_ONES_W = np.ones((3, 1), np.float32) @ _GRAY_W[None, :]  # rows = w_gray


def _const(a: np.ndarray, like: torch.Tensor, shape=(1, 3, 1, 1)
           ) -> torch.Tensor:
    """A numpy constant in ``like``'s dtype on its device; bound for a card
    through pinned memory, so the copy does not wait for the card."""
    return host_to_device(torch.from_numpy(np.asarray(a)).to(like.dtype),
                          like.device).view(shape)


class AugmentTables(NamedTuple):
    """Per-sample tables of one batch: ``a_mats (N,4,3,3) f32``,
    ``gammas (N,4) f32``, ``ints (N,8) i32`` (the raw draws), ``geom (N,3)
    i32`` (``[t, l, r]``)."""

    a_mats: torch.Tensor
    gammas: torch.Tensor
    ints: torch.Tensor
    geom: torch.Tensor

    def to(self, device) -> "AugmentTables":
        """The tables on ``device``; host tables go to a card through
        pinned memory, so the copy does not wait for the card."""
        return AugmentTables(*(host_to_device(t, device) for t in self))


def draw_augment_scalars(n: int, generator: torch.Generator, *,
                         brightness: float = 0.3, contrast: float = 0.3,
                         saturation: float = 0.3, hue: float = 0.3,
                         p_jitter: float = 0.5, p_geom: float = 0.3):
    """The per-sample draws of the train augmentation, from ``generator``:
    ``facs (N,4) f32 = [fb, fc, fs, fh]`` with fb, fc, fs ~ U(1−x, 1+x) and
    fh ~ U(−hue, hue); ``ints (N,8) i32 = [perm0..perm3, j_apply, g_apply,
    choice, rot_k]`` with a uniform permutation of the four ops, j_apply ~
    Bernoulli(p_jitter), g_apply ~ Bernoulli(p_geom), choice ∈ {0, 1, 2}
    (hflip, rot90, vflip) and rot_k ∈ {0..3} uniform.  The same tables as
    the JAX package's ``draw_augment_scalars``, from another stream."""
    dev = generator.device
    u = torch.rand((n, 4), generator=generator, device=dev)
    lo = torch.tensor([1.0 - brightness, 1.0 - contrast, 1.0 - saturation,
                       -hue], device=dev)
    hi = torch.tensor([1.0 + brightness, 1.0 + contrast, 1.0 + saturation,
                       hue], device=dev)
    facs = lo + (hi - lo) * u
    perm = torch.rand((n, 4), generator=generator, device=dev).argsort(dim=1)
    flags = torch.rand((n, 2), generator=generator, device=dev)
    j_apply = flags[:, 0] < p_jitter
    g_apply = flags[:, 1] < p_geom
    choice = torch.randint(0, 3, (n,), generator=generator, device=dev)
    rot_k = torch.randint(0, 4, (n,), generator=generator, device=dev)
    ints = torch.cat([perm, torch.stack([j_apply.long(), g_apply.long(),
                                         choice, rot_k], dim=1)], dim=1)
    return facs.float(), ints.to(torch.int32)


def jitter_slot_params(facs: torch.Tensor, ints: torch.Tensor):
    """``(A (N,4,3,3) f32, γ (N,4) f32)``: slot ``s`` of sample ``i``
    applies ``x ← clip(A[i,s] @ x + γ[i,s]·mean_gray(x))``.  Brightness
    ``f·I``; contrast ``f·I`` with ``γ = 1 − f``; saturation
    ``f·I + (1−f)·𝟙w_grayᵀ``; hue ``T_RGB·R(2πf)·T_YIQ``."""
    facs = facs.float()
    dev = facs.device
    fb, fc, fs, fh = facs.unbind(1)
    eye = torch.eye(3, device=dev)
    ones_w = torch.from_numpy(_ONES_W).to(dev)
    ang = fh * (2.0 * math.pi)
    co, si = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones_like(co), torch.zeros_like(co)
    rot = torch.stack([torch.stack([one, zero, zero], 1),
                       torch.stack([zero, co, -si], 1),
                       torch.stack([zero, si, co], 1)], 1)
    hue = torch.from_numpy(_T_RGB).to(dev) @ (
        rot @ torch.from_numpy(_T_YIQ).to(dev))
    cands = torch.stack([
        fb[:, None, None] * eye,
        fc[:, None, None] * eye,
        fs[:, None, None] * eye + (1.0 - fs)[:, None, None] * ones_w,
        hue,
    ], dim=1)
    gcands = torch.stack([zero, 1.0 - fc, zero, zero], dim=1)
    op = ints[:, :4].long()
    a_mats = cands.gather(1, op[:, :, None, None].expand(-1, -1, 3, 3))
    return a_mats.contiguous(), gcands.gather(1, op).contiguous()


def geom_bits(ints: torch.Tensor) -> torch.Tensor:
    """The OneOf draw as ``(N,3) i32`` columns ``[t, l, r]`` such that
    ``x ← (exch @)ˡ (transpose?)ᵗ(x) (@ exch)ʳ``: ``hflip = r``,
    ``vflip = l``, ``rot90¹ = l∘t``, ``rot90² = l∘r``, ``rot90³ = r∘t``."""
    g_apply = ints[:, 5] == 1
    choice, rot_k = ints[:, 6], ints[:, 7]
    hf = g_apply & (choice == 0)
    rot = g_apply & (choice == 1)
    vf = g_apply & (choice == 2)
    t = rot & ((rot_k == 1) | (rot_k == 3))
    left = vf | (rot & ((rot_k == 1) | (rot_k == 2)))
    right = hf | (rot & ((rot_k == 2) | (rot_k == 3)))
    return torch.stack([t, left, right], dim=1).to(torch.int32)


def make_augment_tables(facs: torch.Tensor, ints: torch.Tensor
                        ) -> AugmentTables:
    """The tables of one batch from its draws."""
    a_mats, gammas = jitter_slot_params(facs, ints)
    return AugmentTables(a_mats, gammas, ints.to(torch.int32).contiguous(),
                         geom_bits(ints).contiguous())


def normalize(img: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """uint8/float [0, 255] NCHW → ImageNet-normalized ``dtype``
    (albumentations ``A.Normalize``: ``(x − 255·mean)·(1/(255·std))``)."""
    img = img.to(dtype)
    return (img - _const(_MEAN * 255.0, img)) * _const(1.0 / (_STD * 255.0),
                                                      img)


def denormalize(img: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`normalize`, clipped to [0, 1], on NCHW images
    (reference ``test.py:128-131``)."""
    mean = torch.from_numpy(_MEAN).to(img.device, img.dtype).view(1, 3, 1, 1)
    std = torch.from_numpy(_STD).to(img.device, img.dtype).view(1, 3, 1, 1)
    return (img * std + mean).clamp(0.0, 1.0)


def eval_images(images: torch.Tensor, img_size: int,
                dtype: torch.dtype = torch.float32, stain: str = "none"
                ) -> torch.Tensor:
    """The image half of :func:`eval_transform`: (N,H,W,3) uint8 → ``dtype``
    (N,3,S,S) normalized images (bilinear f32 resize where the size
    differs).  ``stain`` (``none``, ``reinhard`` or ``macenko``) is the JAX
    ``eval_transform``'s hook: after the resize, ``apply_stain_batch(x /
    255, stain) · 255`` in float32, then the normalize."""
    check_method(stain)
    x = images.permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) != (img_size, img_size):
        x = resize_bilinear(x.float(), img_size, img_size)
    if stain != "none":
        c255 = torch.full((1,), 255.0, dtype=torch.float32, device=x.device)
        x01 = x.float().permute(0, 2, 3, 1) / c255
        x = (apply_stain_batch(x01, stain) * c255).permute(0, 3, 1, 2)
    return normalize(x, dtype).contiguous()


def eval_transform(images: torch.Tensor, masks: torch.Tensor, img_size: int,
                   dtype: torch.dtype = torch.float32, stain: str = "none"):
    """The reference's val/test pipeline: resize → normalize.  ``images``
    (N,H,W,3) uint8 and ``masks`` (N,H,W) → ``dtype`` (N,3,S,S) normalized
    images and float32 (N,S,S) masks (bilinear f32 resize for images,
    nearest for masks, only where the size differs)."""
    x = eval_images(images, img_size, dtype, stain)
    return x, resize_nearest(masks, img_size, img_size).float()


def _channel_mean(xc: torch.Tensor, inv_hw: float,
                  exact: bool) -> torch.Tensor:
    """Each sample's mean of an (N, H, W) float32 plane: the f32 sum times
    ``1/(H·W)`` (the JAX expression), or with ``exact`` the float64 mean
    rounded to f32, which does not depend on the device's summation
    order."""
    if exact:
        return xc.double().mean(dim=(1, 2)).float()
    return xc.sum(dim=(1, 2)) * inv_hw


def apply_slot_jitter(imgs: torch.Tensor, a_mats: torch.Tensor,
                      gammas: torch.Tensor, j_apply: torch.Tensor,
                      exact_means: bool = False) -> torch.Tensor:
    """Slot-matrix ColorJitter on [0, 1] NCHW images (any float dtype):
    f32 products and sums, one round to the image dtype per slot, then the
    clip — the expression shapes of the JAX ``apply_slot_jitter`` and of
    the kernel.  Samples with ``j_apply`` False pass unchanged.
    ``exact_means`` takes each slot's channel means in float64
    (:func:`_channel_mean`), so a card and a CPU give the same image."""
    h, w = imgs.shape[-2:]
    inv_hw = float(np.float32(1.0) / np.float32(h * w))  # exact in f32
    orig = imgs
    wg = [float(v) for v in _GRAY_W]
    for s in range(4):
        xf = imgs.float()
        x0, x1, x2 = xf[:, 0], xf[:, 1], xf[:, 2]
        mu = [_channel_mean(xc, inv_hw, exact_means) for xc in (x0, x1, x2)]
        m = wg[0] * mu[0] + wg[1] * mu[1] + wg[2] * mu[2]
        gm = (gammas[:, s] * m)[:, None, None]
        a = a_mats[:, s]

        def ch(c):
            return (a[:, c, 0, None, None] * x0
                    + a[:, c, 1, None, None] * x1
                    + a[:, c, 2, None, None] * x2) + gm

        y = torch.stack([ch(0), ch(1), ch(2)], dim=1).to(imgs.dtype)
        imgs = y.clamp(0.0, 1.0)
    return torch.where(j_apply.view(-1, 1, 1, 1), imgs, orig)


def _index(rows: list, device) -> torch.Tensor:
    return host_to_device(torch.tensor(rows, dtype=torch.long), device)


def apply_one_of_geom(imgs: torch.Tensor, masks: torch.Tensor,
                      ints: torch.Tensor):
    """OneOf{hflip, rot90(k), vflip} from the drawn ``ints`` columns 5..7,
    per sample, on NCHW images and NHW masks (the JAX
    ``apply_one_of_geom``; ``rot90`` turns the (H, W) plane as
    ``jnp.rot90`` turns HWC).  ``ints`` lies on the host: the samples are
    grouped by geometry there, and each group moves in one indexed copy.
    Returns contiguous tensors."""
    groups: dict = {}
    for i, (g_apply, choice, rot_k) in enumerate(ints[:, 5:8].tolist()):
        key = (choice, rot_k if choice == 1 else 0) if g_apply == 1 else None
        groups.setdefault(key, []).append(i)
    out_i = torch.empty(imgs.shape, dtype=imgs.dtype, device=imgs.device)
    out_m = torch.empty(masks.shape, dtype=masks.dtype, device=masks.device)
    for key, rows in groups.items():
        idx = _index(rows, imgs.device)
        im, ms = imgs.index_select(0, idx), masks.index_select(0, idx)
        if key is not None:
            choice, rot_k = key
            if choice == 0:
                im, ms = im.flip(-1), ms.flip(-1)
            elif choice == 1:
                im = torch.rot90(im, rot_k, dims=(-2, -1))
                ms = torch.rot90(ms, rot_k, dims=(-2, -1))
            else:
                im, ms = im.flip(-2), ms.flip(-2)
        out_i.index_copy_(0, idx, im)
        out_m.index_copy_(0, idx, ms)
    return out_i, out_m


def unit(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[0, 255] pixels → ``dtype(x) / dtype(255)`` on [0, 1], the default
    chain's first step (``images / jnp.asarray(255.0, dtype)``)."""
    return x.to(dtype) / torch.tensor(255.0, dtype=dtype)


def divide_255(x: torch.Tensor) -> torch.Tensor:
    """``x / 255`` by a true division in ``x``'s dtype on every device (on
    a card PyTorch divides by a host scalar as a multiplication by its
    reciprocal, one ulp off for some values)."""
    return x / torch.full((1,), 255.0, dtype=x.dtype, device=x.device)


def normalize_unit(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NCHW → ``(x − mean) / std`` in ``x``'s dtype, the default
    chain's normalize."""
    return (x - _const(_MEAN, x)) / _const(_STD, x)


def _default_chain(x01: torch.Tensor, masks: torch.Tensor,
                   tables: AugmentTables, host_ints: torch.Tensor,
                   exact_means: bool):
    """Default mode from NCHW images on [0, 1] in the chain's dtype: the
    slot jitter, the normalize, the OneOf."""
    imgs = apply_slot_jitter(x01, tables.a_mats, tables.gammas,
                             tables.ints[:, 4] == 1, exact_means)
    return apply_one_of_geom(normalize_unit(imgs), masks, host_ints)


def fused_chain_bf16(images: torch.Tensor, masks: torch.Tensor,
                     tables: AugmentTables):
    """The fused kernel's plain version: the default chain in bfloat16 at
    the native size, (N,S,S,3) uint8 images and (N,S,S) uint8 masks → bf16
    (N,3,S,S) normalized, augmented images and float32 (N,S,S) masks.
    ``tables`` lie on the images' device (the CPU, where this runs).  Its
    channel means are f32 sums, as the kernel's."""
    return _default_chain(unit(images.permute(0, 3, 1, 2), torch.bfloat16),
                          masks.float(), tables, tables.ints.cpu(),
                          exact_means=False)


# -- parity mode: the reference's per-op ColorJitter on normalized floats ----

# The parity ops' channel mixes are written as products and sums in a
# fixed order (no reduction, no matrix product), so a card and a CPU round
# them alike.

def _mix(img: torch.Tensor, row) -> torch.Tensor:
    """``Σ_c row[c]·img[:, c]`` left to right, (N, 1, H, W); ``row`` holds
    three numbers in the image dtype."""
    return (img[:, 0:1] * row[0] + img[:, 1:2] * row[1]) \
        + img[:, 2:3] * row[2]


def _rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    return _mix(img, _const(_GRAY_W, img, (3,)))


def _adjust_brightness(img, factor, clip):
    out = img * factor
    return out.clamp(0.0, 1.0) if clip else out


def _adjust_contrast(img, factor, clip):
    # the spatial mean (JAX: in f32) taken in float64, so that it does not
    # depend on the device's summation order, then in the image dtype
    mean = _rgb_to_grayscale(img).double().mean(dim=(2, 3), keepdim=True)
    mean = mean.float().to(img.dtype)
    out = mean + (img - mean) * factor
    return out.clamp(0.0, 1.0) if clip else out


def _adjust_saturation(img, factor, clip):
    gray = _rgb_to_grayscale(img)
    out = gray + (img - gray) * factor
    return out.clamp(0.0, 1.0) if clip else out


def hue_rotation(delta: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[cos, sin]`` of the hue shift ``delta`` (turns) along the last
    axis, taken in f32 and rounded to ``dtype``, as the JAX op takes
    them."""
    angle = delta.float() * (2.0 * math.pi)
    return torch.stack([torch.cos(angle), torch.sin(angle)], -1).to(dtype)


def _adjust_hue(img, rotation, clip):
    """Shift the hue through the YIQ rotation by ``rotation`` (the
    ``[cos, sin]`` of :func:`hue_rotation`, shaped to broadcast over
    (N, 1, H, W) with a last axis of 2)."""
    t_yiq = _const(_T_YIQ, img, (3, 3))
    y, i, q = (_mix(img, t_yiq[k]) for k in range(3))
    cos, sin = rotation[..., 0], rotation[..., 1]
    rot = torch.cat([y, i * cos - q * sin, i * sin + q * cos], dim=1)
    t_rgb = _const(_T_RGB, img, (3, 3))
    out = torch.cat([_mix(rot, t_rgb[k]) for k in range(3)], dim=1)
    return out.clamp(0.0, 1.0) if clip else out


_JITTER_OPS = (_adjust_brightness, _adjust_contrast, _adjust_saturation,
               _adjust_hue)


def color_jitter(imgs: torch.Tensor, facs: torch.Tensor,
                 ints: torch.Tensor, clip: bool = False) -> torch.Tensor:
    """Per-sample ColorJitter (the JAX ``color_jitter``) from drawn
    factors: the four ops in each sample's drawn order (``ints`` columns
    0..3), with ``[fb, fc, fs]`` rounded to the image dtype and the hue's
    :func:`hue_rotation`, applied where ``ints`` column 4 is 1.  ``facs``
    and ``ints`` lie on the host: the factors are rounded and the rotation
    taken there, then sent to the device; each slot's samples are grouped
    by op there, each group running its op once."""
    dt, dev = imgs.dtype, imgs.device
    scale = host_to_device(facs[:, :3].to(dt), dev).view(-1, 3, 1, 1, 1)
    rotation = host_to_device(hue_rotation(facs[:, 3], dt), dev)
    args = (scale[:, 0], scale[:, 1], scale[:, 2],
            rotation.view(-1, 1, 1, 1, 2))
    rows = ints.tolist()
    out = imgs
    for s in range(4):
        nxt = out.clone()
        for op, fn in enumerate(_JITTER_OPS):
            sel = [i for i, r in enumerate(rows) if r[4] == 1 and r[s] == op]
            if sel:
                idx = _index(sel, dev)
                nxt.index_copy_(0, idx, fn(out.index_select(0, idx),
                                           args[op].index_select(0, idx),
                                           clip))
        out = nxt
    return out


def train_transform(images: torch.Tensor, masks: torch.Tensor,
                    img_size: int, generator: torch.Generator,
                    parity_mode: bool = False, stain: str = "none",
                    dtype: torch.dtype = torch.float32):
    """The non-fused train chain (the JAX ``train_transform``) with the
    batch's draws from ``generator`` (a host generator): (N,H,W,3) uint8
    images and (N,H,W) uint8 masks → ``dtype`` (N,3,S,S) normalized,
    augmented images and float32 (N,S,S) masks.  See
    :func:`train_transform_drawn`."""
    facs, ints = draw_augment_scalars(images.shape[0], generator)
    return train_transform_drawn(images, masks, img_size, facs, ints,
                                 parity_mode=parity_mode, stain=stain,
                                 dtype=dtype)


def train_transform_drawn(images: torch.Tensor, masks: torch.Tensor,
                          img_size: int, facs: torch.Tensor,
                          ints: torch.Tensor, parity_mode: bool = False,
                          stain: str = "none",
                          dtype: torch.dtype = torch.float32):
    """The non-fused train chain on given draws ``(facs, ints)`` (host
    tensors, :func:`draw_augment_scalars`' layout), step by step as the
    JAX ``train_transform`` takes them: a bilinear float32 resize of the
    images and a nearest one of the masks where the size is not
    ``img_size``; the images in ``dtype``; with ``stain`` (``reinhard`` or
    ``macenko``) ``apply_stain_batch(x / 255).to(dtype) * 255``; then the
    default chain (the slot tables computed on the host and sent to the
    device), or under ``parity_mode`` the normalize, :func:`color_jitter`
    without clipping and the OneOf.  So that the card and the CPU give the
    same image, the chain divides by 255 with a true division
    (:func:`divide_255`), takes its image means in float64 (the JAX chain
    sums in f32), computes every per-sample factor on the host, and mixes
    channels in a fixed order."""
    check_method(stain)
    dev = images.device
    x = images.permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) != (img_size, img_size):
        x = resize_bilinear(x.float(), img_size, img_size)
    masks = resize_nearest(masks, img_size, img_size).float()
    x = x.to(dtype)
    if stain != "none":
        stained = apply_stain_batch(divide_255(x).permute(0, 2, 3, 1), stain)
        x = (stained.to(dtype) * 255.0).permute(0, 3, 1, 2)
    facs, ints = facs.float().cpu(), ints.cpu()
    if parity_mode:
        imgs = color_jitter(normalize(x, dtype), facs, ints)
        return apply_one_of_geom(imgs, masks, ints)
    tables = make_augment_tables(facs, ints).to(dev)
    return _default_chain(divide_255(x), masks, tables, ints,
                          exact_means=True)
