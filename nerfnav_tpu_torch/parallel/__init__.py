from nerfnav_tpu_torch.parallel.sharding import (
    all_mean,
    all_sum,
    gather_rays,
    make_mesh,
    mesh_rank,
    mesh_size,
    shard_rays,
)

__all__ = ["all_mean", "all_sum", "gather_rays", "make_mesh", "mesh_rank", "mesh_size",
           "shard_rays"]
