"""`--debug-nans`: fail fast on a NaN out of any kernel wrapper (the
counterpart of the JAX package's `jax_debug_nans`, the sanitizer role).

Off by default, so that no timed path pays for it. When it is on, every
kernel wrapper checks its output, whether the kernel or its plain version
computed it, and raises `FloatingPointError` naming the op. The check reads
one flag back from the card, so it syncs each call.
"""

from __future__ import annotations

import torch

_debug_nans = False


def enable_debug_nans(on: bool = True) -> None:
    global _debug_nans
    _debug_nans = bool(on)


def debug_nans_enabled() -> bool:
    return _debug_nans


def checked(y: torch.Tensor, op: str) -> torch.Tensor:
    """Return y; with the switch on, raise if it holds a NaN."""
    if _debug_nans and bool(torch.isnan(y).any()):
        raise FloatingPointError(f"{op}: NaN in the output (--debug-nans)")
    return y
