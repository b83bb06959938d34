"""Hand-written Hopper kernels, each behind a wrapper (``<name>/ops.py``)
that sends CPU tensors to its plain version (``<name>/ref.py``)."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when a call would need a gradient through a kernel.

    The kernels have no backward, as the TPU kernels they port have none,
    so a call with autograd on and an input that requires a gradient fails
    on every device (the plain version on the CPU included) rather than
    hand autograd a constant. Forward calls under ``torch.no_grad()`` or
    ``torch.inference_mode()``, and calls on tensors that need no gradient,
    pass.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (nor has the TPU kernel it "
            f"ports), so it cannot run where a gradient is needed; a "
            f"training step takes use_pallas=False")
