"""nerfnav in PyTorch and CUDA for one NVIDIA H100.

The port of `nerfnav_tpu` (JAX on a TPU), held against it module by module.
This package runs the occupancy-grid eval render (`Trainer.render_full`) with
the fused-MLP backend: ray tiles, the block-packed two-phase march, the
hash-grid field and the early-terminating round compositor. The one TPU
kernel on that path, the Pallas fused MLP, is a hand-written CUDA kernel here
(`csrc/fused_mlp.cu`); everything else is plain PyTorch for now.

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU, and raise when no CUDA device is present. Options this slice does not
port raise `NotImplementedError` naming their ROADMAP item.
"""

from nerfnav_tpu_torch.device import resolve_device, unported

__all__ = ["resolve_device", "unported"]
