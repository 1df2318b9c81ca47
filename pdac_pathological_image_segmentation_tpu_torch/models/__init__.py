"""Models of the port (FPN on the ResNet encoders so far)."""

from pdac_pathological_image_segmentation_tpu_torch.models.registry import (
    build_model,
)

__all__ = ["build_model"]
