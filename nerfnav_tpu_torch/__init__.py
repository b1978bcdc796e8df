"""nerfnav in PyTorch and CUDA for one NVIDIA H100.

The port of `nerfnav_tpu` (JAX on a TPU), held against it module by module.
It does everything the JAX package does: the Instant-NGP field, the
occupancy-grid render and training (`training/trainer.py`), checkpoints and
their converters, the navigation stack (`nav/`), the interactive viewer
(`gui/`), the Blender observation backend (`sim/`) and the dataset
converters (`scripts/`). The one TPU kernel, the Pallas fused MLP, is a
hand-written CUDA kernel here (`csrc/fused_mlp.cu`); everything else is plain
PyTorch.

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU, and raise when no CUDA device is present.
"""

from nerfnav_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
