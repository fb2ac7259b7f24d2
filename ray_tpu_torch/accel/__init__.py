from ray_tpu_torch.accel.gpu import (
    detect_gpu_resources,
    get_visible_devices,
    set_visible_devices,
)

__all__ = [
    "detect_gpu_resources",
    "get_visible_devices",
    "set_visible_devices",
]
