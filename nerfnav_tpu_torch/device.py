"""Device resolution and cached device constants."""

from functools import lru_cache

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


@lru_cache(maxsize=None)
def _const(values: tuple, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def device_const(values, device) -> torch.Tensor:
    """A float32 tensor of `values` (a number or nested sequences) on
    `device`, built once per device and shared: never write to it.

    A fresh torch.tensor(..., device="cuda") is a host-to-device copy from
    pageable memory, which waits for the card to drain its queue; a
    constant inside a loop of small kernels would sync every iteration."""
    def freeze(v):
        return tuple(freeze(x) for x in v) if isinstance(v, (list, tuple)) else float(v)

    return _const(freeze(values), str(torch.device(device)))

