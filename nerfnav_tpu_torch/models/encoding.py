"""Encoder factory.

Counterpart of nerfnav_tpu/models/encoding.py: a name maps to
(init_fn | None, encode_fn, output_dim) for None, "frequency",
"sphere_harmonics" / "spherical_harmonics", "hashgrid" and "tiledgrid".
encode_fn is (params_or_None, x) -> features; init_fn, for the grids only,
is hash_grid_init on the grid's config: (generator, device=...) -> tables.
"""

from functools import partial

from nerfnav_tpu_torch.ops.frequency import freq_encode, freq_output_dim
from nerfnav_tpu_torch.ops.hashgrid import HashGridConfig, hash_grid_encode, hash_grid_init
from nerfnav_tpu_torch.ops.spherical_harmonics import sh_encode, sh_output_dim


def get_encoder(encoding: str, input_dim: int = 3, degree: int = 4, multires: int = 6,
                num_levels: int = 16, level_dim: int = 2, base_resolution: int = 16,
                log2_hashmap_size: int = 19, desired_resolution: int = 2048,
                layout: str = "corner", **kwargs):
    """(init_fn | None, encode_fn, output_dim); kwargs may hold the grids'
    `bound` (default 1)."""
    if encoding in (None, "None", "none"):
        return None, (lambda p, x: x), input_dim
    if encoding == "frequency":
        return (None, lambda p, x: freq_encode(x, degree=multires),
                freq_output_dim(input_dim, multires))
    if encoding in ("sphere_harmonics", "spherical_harmonics"):
        return None, (lambda p, x: sh_encode(x, degree=degree)), sh_output_dim(degree)
    if encoding in ("hashgrid", "tiledgrid"):
        cfg = HashGridConfig(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="tiled" if encoding == "tiledgrid" else "hash", layout=layout)
        bound = kwargs.get("bound", 1.0)
        return (partial(hash_grid_init, config=cfg),
                lambda p, x: hash_grid_encode(p, x, cfg, bound=bound), cfg.output_dim)
    raise ValueError(f"unknown encoding: {encoding}")
