"""Device resolution and the error raised by options the port lacks."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device must exist.

    There is no silent CPU fallback: the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the port on the CPU")
    return dev


def unported(what: str, item: str) -> NotImplementedError:
    """The error for an option or path this port does not cover yet."""
    return NotImplementedError(
        f"{what} is not ported to nerfnav_tpu_torch yet (ROADMAP {item})")
