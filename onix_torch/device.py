"""Device choice for the port's entry points.

Every entry point takes a `device` argument whose default is "cuda".
There is no fallback: without a card, "cuda" raises, and the CPU runs
only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for `device`, with float32 matmuls pinned to
    full precision (the JAX package scores in f32: TF32 would round
    θ·φᵀ to ~3 decimal digits).

    Raises RuntimeError for "cuda" when no card is visible, and
    ValueError for any device type other than cuda or cpu."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev


def describe(device: torch.device) -> dict:
    """Manifest entry naming where a run went: the torch device and,
    on a card, its name."""
    if device.type == "cuda":
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        return {"torch": f"cuda:{index}",
                "name": torch.cuda.get_device_name(index)}
    return {"torch": str(device), "name": "cpu"}
