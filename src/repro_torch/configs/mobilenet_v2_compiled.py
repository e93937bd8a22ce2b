"""MobileNetV2 Compiled CNN — the depthwise model-zoo member
(models/mobilenet_v2.py); ports ``repro/configs/mobilenet_v2_compiled.py``."""
from repro_torch.models.mobilenet_v2 import MobileNetV2Config

CONFIG = MobileNetV2Config(width_mult=1.0)
