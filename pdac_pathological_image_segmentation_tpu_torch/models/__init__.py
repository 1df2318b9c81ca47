"""Models of the port: the registry's five architectures on the ResNet,
MobileNetV2 and EfficientNet encoders."""

from pdac_pathological_image_segmentation_tpu_torch.models.registry import (
    build_model,
)

__all__ = ["build_model"]
