"""Shared small utilities."""

from lsbench_tpu_torch.utils.fence import device_fence  # noqa: F401
from lsbench_tpu_torch.utils.precision import full_f32  # noqa: F401
