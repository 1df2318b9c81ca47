"""Typed configuration with the reference's flat-YAML schema.

The port's own copy of the JAX package's ``config.py``: the same fields,
defaults and validation, so the reference YAMLs (``configs/*.yaml``) and
every config the JAX package accepts parse here unchanged.  Unknown keys
are kept in ``extras``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional, Tuple

import yaml

VALID_MODELS = ("unet", "fpn", "deeplabv3+", "pspnet", "unet++")

# ImageNet normalization constants used everywhere in the reference
# (train_main.py:73,85, test.py:65,128).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _parse_dilations(value: Any) -> Tuple[int, ...]:
    """Parse dilations from YAML — the reference config writes ``(3, 6, 9)``
    which PyYAML reads as the *string* ``"(3, 6, 9)"``
    (configs/train_config.yaml:24)."""
    if value is None:
        return (3, 6, 9)
    if isinstance(value, (tuple, list)):
        return tuple(int(v) for v in value)
    if isinstance(value, str):
        nums = re.findall(r"-?\d+", value)
        if not nums:
            raise ValueError(f"cannot parse dilations from {value!r}")
        return tuple(int(n) for n in nums)
    raise TypeError(f"unsupported dilations value: {value!r}")


@dataclasses.dataclass
class Config:
    """Training/eval configuration.

    Field names match the reference YAML keys one-for-one
    (reference ``configs/train_config.yaml:1-24`` and
    ``configs/visualize_config.yaml:1-21``).
    """

    # dataset paths
    train_path: Optional[str] = None
    val_path: Optional[str] = None
    test_path: Optional[str] = None

    # WSI visualization inputs
    svs_path: Optional[str] = None
    tile_path: Optional[str] = None
    tsv_path: Optional[str] = None

    # training
    epochs: int = 50
    batch_size: int = 128
    lr: float = 1e-4
    img_size: int = 512
    seed: int = 41
    num_worker: int = 8
    port: str = ""
    earlystop_patience: int = 30

    # model
    model: str = "fpn"
    backbone: str = "resnet18"
    dilations: Tuple[int, ...] = (3, 6, 9)

    # framework knobs, all with safe defaults
    num_classes: int = 1
    earlystop_delta: float = 0.02
    plateau_factor: float = 0.5
    plateau_patience: int = 2
    min_lr: float = 1e-10
    # compute dtype of the convolutions; parameters stay float32
    compute_dtype: str = "bfloat16"
    parity_mode: bool = False
    pretrained_path: Optional[str] = None
    num_devices: Optional[int] = None
    use_pallas: bool = True
    stain: str = "none"
    tissue_threshold: float = 0.0

    extras: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.model = str(self.model).lower()
        # reference test.py:101 checks the typo'd key "pspnet+"; accept both.
        if self.model == "pspnet+":
            self.model = "pspnet"
        if self.model not in VALID_MODELS:
            raise ValueError(
                f"model must be one of {VALID_MODELS}, got {self.model!r}"
            )
        self.dilations = _parse_dilations(self.dilations)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.img_size < 32:
            raise ValueError("img_size must be >= 32")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16")
        self.stain = str(self.stain).lower()
        if self.stain not in ("none", "reinhard", "macenko"):
            raise ValueError(
                f"stain must be none, reinhard or macenko, got {self.stain!r}"
            )
        if not 0.0 <= float(self.tissue_threshold) <= 1.0:
            raise ValueError("tissue_threshold must be in [0, 1]")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        field_names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in field_names}
        extras = {k: v for k, v in d.items() if k not in field_names}
        cfg = cls(**known)
        cfg.extras.update(extras)
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("extras")
        d.update(self.extras)
        return d


def load_config(path: str) -> Config:
    """Load a YAML config file (reference ``train_main.py:21``)."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    return Config.from_dict(raw)
