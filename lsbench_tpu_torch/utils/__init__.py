"""Shared small utilities."""

from lsbench_tpu_torch.utils.fence import device_fence  # noqa: F401
