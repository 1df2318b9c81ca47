"""Device-side augmentation (the JAX package's ``ops/augment.py``), NCHW.

The train chain of the reference (``train_main.py:70-81``) in its default
mode: uint8 pixels → ``/255`` → slot-matrix ColorJitter on [0, 1] with
clipping (p = 0.5) → ImageNet normalize → OneOf{hflip, rot90(k), vflip}
(p = 0.3), all in bfloat16, masks sharing the geometry.  Every ColorJitter
op on [0, 1] RGB is the affine map ``x ← clip(A @ x + γ·mean_gray(x))``
with a per-sample, per-slot 3×3 ``A`` and scalar ``γ``; the random op order
lives in which matrix sits in which slot.

The random draws happen outside the chain, as in the JAX package:
:func:`draw_augment_scalars` draws ``(facs, ints)`` from a
``torch.Generator`` with the JAX draws' distributions (the streams differ),
:func:`jitter_slot_params` and :func:`geom_bits` turn them into the tables
the chain and the kernel consume.  Every function takes injected tables,
so tests can feed it the JAX package's draws.

:func:`train_transform` is the plain version of the fused kernel
(``ops/fused_augment.py``).  Stain normalization (``ops/stain.py``) runs in
the eval chain (:func:`eval_images`); ``parity_mode`` (jitter on
normalized floats) and stain in the train chain are not ported and raise.
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

_NOT_PORTED = {
    "parity_mode": "parity_mode (jitter on normalized floats, no clip) is "
                   "not ported yet (ROADMAP.md Queue 1, item 4)",
    "stain": "stain normalization in training is not ported yet: the JAX "
             "train step sends it through the non-fused train_transform, "
             "which waits with fused_augment: false (ROADMAP.md Queue 1, "
             "item 4); serving, evaluation and whole slides take it",
}


def check_supported(parity_mode: bool = False, stain: str = "none") -> None:
    """Raise for the train-chain options the port does not have."""
    if parity_mode:
        raise NotImplementedError(_NOT_PORTED["parity_mode"])
    if stain != "none":
        raise NotImplementedError(f"stain={stain!r}: {_NOT_PORTED['stain']}")


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
    mean = torch.from_numpy(_MEAN * 255.0).to(img.device, dtype)
    inv_std = torch.from_numpy(1.0 / (_STD * 255.0)).to(img.device, dtype)
    return (img - mean.view(1, 3, 1, 1)) * inv_std.view(1, 3, 1, 1)


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


def apply_slot_jitter(imgs: torch.Tensor, a_mats: torch.Tensor,
                      gammas: torch.Tensor, j_apply: torch.Tensor
                      ) -> torch.Tensor:
    """Slot-matrix ColorJitter on [0, 1] NCHW images (any float dtype):
    f32 products and sums, one round to the image dtype per slot, then the
    clip — the expression shapes of the JAX ``apply_slot_jitter`` and of
    the kernel.  Samples with ``j_apply`` False pass unchanged."""
    h, w = imgs.shape[-2:]
    inv_hw = 1.0 / torch.tensor(float(h * w), dtype=torch.float32)
    orig = imgs
    wg = [float(v) for v in _GRAY_W]
    for s in range(4):
        xf = imgs.float()
        x0, x1, x2 = xf[:, 0], xf[:, 1], xf[:, 2]
        mu = [xc.sum(dim=(1, 2)) * inv_hw.to(xf.device) for xc in
              (x0, x1, x2)]
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


def apply_one_of_geom(imgs: torch.Tensor, masks: torch.Tensor,
                      ints: torch.Tensor):
    """OneOf{hflip, rot90(k), vflip} from the drawn ``ints`` columns 5..7,
    per sample, on NCHW images and NHW masks (the JAX
    ``apply_one_of_geom``; ``rot90`` turns the (H, W) plane as
    ``jnp.rot90`` turns HWC)."""
    out_i, out_m = [], []
    for k, (g_apply, choice, rot_k) in enumerate(ints[:, 5:8].tolist()):
        im, ms = imgs[k], masks[k]
        if g_apply == 1:
            if choice == 0:
                im, ms = im.flip(-1), ms.flip(-1)
            elif choice == 1:
                im = torch.rot90(im, rot_k, dims=(-2, -1))
                ms = torch.rot90(ms, rot_k, dims=(-2, -1))
            else:
                im, ms = im.flip(-2), ms.flip(-2)
        out_i.append(im)
        out_m.append(ms)
    return torch.stack(out_i).contiguous(), torch.stack(out_m).contiguous()


def unit_bf16(images: torch.Tensor) -> torch.Tensor:
    """(N,H,W,3) uint8 → bf16 (N,3,H,W) on [0, 1]: ``bf16(u8) / bf16(255)``,
    the train chain's first step."""
    bf = torch.bfloat16
    return images.permute(0, 3, 1, 2).to(bf) / torch.tensor(255.0, dtype=bf)


def normalize_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 NCHW on [0, 1] → ``(x − bf16(mean)) / bf16(std)`` in bf16, the
    train chain's normalize."""
    bf = torch.bfloat16
    mean = torch.from_numpy(_MEAN).to(x.device, bf).view(1, 3, 1, 1)
    std = torch.from_numpy(_STD).to(x.device, bf).view(1, 3, 1, 1)
    return (x - mean) / std


def train_transform(images: torch.Tensor, masks: torch.Tensor,
                    tables: AugmentTables):
    """The default-mode train chain in bfloat16, the plain version of the
    fused kernel: (N,S,S,3) uint8 images and (N,S,S) uint8 masks → bf16
    (N,3,S,S) normalized, augmented images and float32 (N,S,S) masks."""
    x = apply_slot_jitter(unit_bf16(images), tables.a_mats, tables.gammas,
                          tables.ints[:, 4] == 1)
    return apply_one_of_geom(normalize_bf16(x), masks.float(), tables.ints)
