"""onix_torch — the PyTorch / CUDA port of onix for NVIDIA Hopper.

A second package beside `onix/`, which stays the reference. The port
imports `torch`, never `jax`, and nothing from `onix`: where it needs a
module of `onix/` that has no JAX in it, it keeps its own copy. Each
Pallas kernel of `onix/` becomes a kernel written by hand for sm_90a
(`onix_torch/csrc/`), built with nvcc at first use
(`onix_torch/kernels.py`).

Entry points run on the card by default and raise when there is none
(`onix_torch.device.resolve_device`); the CPU is used only when the
caller asks for it, as the tests do.
"""


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error for a setting or entry point that the port does not
    run yet; `where` names its item in ROADMAP.md."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; it is queued in "
        f"ROADMAP.md under {where}")
