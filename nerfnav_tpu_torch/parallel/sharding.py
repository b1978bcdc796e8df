"""Data parallel over a 1-D device mesh: one process per device.

Counterpart of nerfnav_tpu/parallel/sharding.py. JAX runs one program over a
`Mesh` and lets XLA insert the collectives; here each rank of a
torch.distributed process group runs the same program on its block of the
leading (ray) axis, and the collectives are explicit: a gather of rank
blocks, a sum and a gradient mean over the mesh's group. The mesh is a
torch.distributed DeviceMesh with the single dimension "data". Launching the
processes and initialising their group is the caller's job (torchrun, or
torch.multiprocessing with `init_process_group`): NCCL for CUDA tensors,
gloo for CPU ones.
"""

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map_only


def make_mesh(n_devices: int | None = None, axis: str = "data", device_type: str = "cuda"):
    """A 1-D DeviceMesh named (axis,) over the ranks of the initialised
    default process group; n_devices, if given, must be its world size.
    Raises without a process group: there is no one-process mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(init_process_group with nccl for cuda, gloo for cpu)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a process group of {world}")
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis,))


def mesh_size(mesh, axis: str = "data") -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_rank(mesh, axis: str = "data") -> int:
    return mesh.get_local_rank(axis)


def shard_rays(tree, mesh, axis: str = "data"):
    """This rank's contiguous block of every tensor's leading axis (what
    JAX's P("data") lays out); the leading axis must divide by the mesh
    size. Leaves that are no tensor pass through."""
    n, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)

    def block(x):
        if x.shape[0] % n:
            raise ValueError(f"a leading axis of {x.shape[0]} does not divide across {n} ranks")
        b = x.shape[0] // n
        return x[r * b : (r + 1) * b]

    return tree_map_only(torch.Tensor, block, tree)


def gather_rays(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The rank blocks of x concatenated in rank order along the leading
    axis: the inverse of shard_rays (every rank's block has x's shape)."""
    parts = [torch.empty_like(x) for _ in range(mesh_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts)


def all_sum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The sum of x over the mesh's ranks (a new tensor)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def all_mean(tensors, mesh, axis: str = "data"):
    """The mean over the mesh's ranks of each tensor of a list (all float32):
    one all-reduce of their concatenation, SUM divided by the mesh size."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    flat /= mesh_size(mesh, axis)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
