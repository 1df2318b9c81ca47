"""Plain reference of the training recipe: augmentation, forward, Dice,
backward and Adam, in float32, on the batches and the generator seeds
that the benchmark hands the program.

The recipe (the reference repository's ``train_main.py``): pixels on
[0, 1]; with p = 0.5 a ColorJitter (brightness, contrast, saturation and
hue at 0.3, in a random order), each op clipped to [0, 1]; ImageNet
normalize; with p = 0.3 one of {horizontal flip, rot90 by k, vertical
flip}, the mask turned alike; the global soft Dice loss (smooth 1e-6) on
the sigmoid; Adam.  The draws come from the step's CPU generator in the
order the program takes them: the batch's jitter factors, op order, apply
flags, geometry choice and rotation, then (FPN) the Dropout2d mask of the
decoder's output, (N, C) planes kept where U[0, 1) ≥ p.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.models import (
    NORMALIZE_MEAN,
    NORMALIZE_STD,
    has_dropout,
)

SMOOTH = 1e-6
GRAY = (0.299, 0.587, 0.114)
T_YIQ = ((0.299, 0.587, 0.114),
         (0.59590059, -0.27455667, -0.32134392),
         (0.21153661, -0.52273617, 0.31119955))


def draws(n: int, g: torch.Generator, strength: float = 0.3,
          p_jitter: float = 0.5, p_geom: float = 0.3) -> dict:
    """One batch's augmentation draws, in the generator's order."""
    u = torch.rand((n, 4), generator=g)
    lo = torch.tensor([1.0 - strength] * 3 + [-strength])
    hi = torch.tensor([1.0 + strength] * 3 + [strength])
    facs = (lo + (hi - lo) * u).float()
    order = torch.rand((n, 4), generator=g).argsort(dim=1)
    flags = torch.rand((n, 2), generator=g)
    choice = torch.randint(0, 3, (n,), generator=g)
    rot_k = torch.randint(0, 4, (n,), generator=g)
    return {"facs": facs, "order": order, "jitter": flags[:, 0] < p_jitter,
            "geom": flags[:, 1] < p_geom, "choice": choice, "rot_k": rot_k}


def _op_matrices(facs: torch.Tensor) -> tuple:
    """(N, 4, 3, 3) matrices and (N, 4) gray-mean gains of brightness,
    contrast, saturation and hue: ``x ← A x + γ·mean_gray(x)``."""
    n = facs.shape[0]
    fb, fc, fs, fh = facs.double().unbind(1)
    eye = torch.eye(3, dtype=torch.float64).expand(n, 3, 3)
    gray = torch.tensor(GRAY, dtype=torch.float64)
    ones_w = torch.ones(3, 1, dtype=torch.float64) * gray[None, :]
    t_yiq = torch.tensor(T_YIQ, dtype=torch.float64)
    t_rgb = torch.linalg.inv(t_yiq)
    ang = fh * 2.0 * math.pi
    rot = torch.zeros(n, 3, 3, dtype=torch.float64)
    rot[:, 0, 0] = 1.0
    rot[:, 1, 1], rot[:, 1, 2] = torch.cos(ang), -torch.sin(ang)
    rot[:, 2, 1], rot[:, 2, 2] = torch.sin(ang), torch.cos(ang)
    mats = torch.stack([fb[:, None, None] * eye, fc[:, None, None] * eye,
                        fs[:, None, None] * eye
                        + (1 - fs)[:, None, None] * ones_w,
                        t_rgb @ rot @ t_yiq], dim=1)
    gains = torch.stack([torch.zeros_like(fc), 1 - fc, torch.zeros_like(fc),
                         torch.zeros_like(fc)], dim=1)
    return mats.float(), gains.float()


def augment(images_u8: torch.Tensor, masks_u8: torch.Tensor, d: dict):
    """(N, H, W, 3) and (N, H, W) uint8 → normalized float32 (N, 3, H, W)
    images and float32 (N, H, W) masks."""
    dev = images_u8.device
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    mats, gains = (t.to(dev) for t in _op_matrices(d["facs"]))
    gray = torch.tensor(GRAY, device=dev)
    jittered = x
    for slot in range(4):
        op = d["order"][:, slot].to(dev)
        a = mats[torch.arange(len(op), device=dev), op]  # (N, 3, 3)
        gain = gains[torch.arange(len(op), device=dev), op]
        m = (jittered.mean(dim=(2, 3)) * gray).sum(dim=1)  # (N,)
        y = torch.einsum("nij,njhw->nihw", a, jittered) \
            + (gain * m)[:, None, None, None]
        jittered = y.clamp(0.0, 1.0)
    x = torch.where(d["jitter"].to(dev)[:, None, None, None], jittered, x)
    x = _normalize01(x)
    masks = masks_u8.float()
    xs, ms = [], []
    for i in range(x.shape[0]):
        xi, mi = x[i], masks[i]
        if bool(d["geom"][i]):
            c, k = int(d["choice"][i]), int(d["rot_k"][i])
            if c == 0:
                xi, mi = xi.flip(-1), mi.flip(-1)
            elif c == 1:
                xi, mi = torch.rot90(xi, k, (-2, -1)), torch.rot90(mi, k,
                                                                   (-2, -1))
            else:
                xi, mi = xi.flip(-2), mi.flip(-2)
        xs.append(xi)
        ms.append(mi)
    return torch.stack(xs), torch.stack(ms)


def _normalize01(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(NORMALIZE_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(NORMALIZE_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def dice_loss(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    p = torch.sigmoid(logits[:, 0].float()).reshape(-1)
    t = masks.float().reshape(-1)
    return 1.0 - (2.0 * (p * t).sum() + SMOOTH) / (p.sum() + t.sum()
                                                    + SMOOTH)


class Adam:
    """Adam without weight decay: the bias-corrected moments, the update
    ``lr·m̂/(√v̂ + eps)``."""

    def __init__(self, params: dict, lr: float, betas, eps: float):
        self.params, self.lr, self.eps = params, lr, eps
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.sub_(self.lr * (self.m[k] / c1) / denom)


def run_steps(model, cfg: dict, batches) -> dict:
    """Steps of the recipe on ``batches`` ``[(images_u8, masks_u8,
    generator seed)]``: ``{"losses": [float], "grad1": {name: first
    gradient}, "change": {name: parameters after the last step − before
    the first}}``."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, cfg["lr"], cfg["adam_betas"], cfg["adam_eps"])
    losses, grad1 = [], None
    model.train()
    for images, masks, gen_seed in batches:
        g = torch.Generator().manual_seed(gen_seed)
        d = draws(images.shape[0], g)
        x, m = augment(images, masks, d)
        keep = None
        if has_dropout(cfg):
            c = cfg["segmentation_channels"]
            keep = (torch.rand((x.shape[0], c, 1, 1), generator=g)
                    >= cfg["dropout"])[:, :, 0, 0].to(x.device)
        for p in params.values():
            p.grad = None
        loss = dice_loss(model(x, keep), m)
        loss.backward()
        if grad1 is None:
            grad1 = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    change = {k: p.detach() - start[k] for k, p in params.items()}
    return {"losses": losses, "grad1": grad1, "change": change}


def leaf_gaps(program: dict, reference: dict, keep: list) -> dict:
    """``{leaf: gap}`` over ``keep``, a leaf's gap being |‖program‖ −
    ‖reference‖| over the larger of the reference's norm and the median
    reference leaf norm."""
    norms = {k: float(reference[k].float().norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(program[k].float().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep}


def leaf_differences(program: dict, reference: dict, keep: list) -> dict:
    """``{leaf: ‖program − reference‖}`` over ``keep``, over the larger of
    the reference's norm and the median reference leaf norm."""
    norms = {k: float(reference[k].float().norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: float((program[k].float() - reference[k].float()).norm())
            / max(norms[k], med, 1e-30) for k in keep}


def moving_leaves(grad1: dict, share: float = 1e-3) -> list:
    """Leaves whose first reference gradient is at least ``share`` of the
    median leaf's (the others move under Adam by round-off alone)."""
    norms = {k: float(g.float().norm()) for k, g in grad1.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= share * med]
