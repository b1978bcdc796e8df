"""Export an npz checkpoint of this package as a torch-ngp checkpoint (.pth).

Counterpart of nerfnav_tpu/scripts/export_torch_ckpt.py, the inverse of
import_torch_ckpt.py: torch-ngp's Trainer, or any tool that reads its
checkpoints, loads the result. Only torch-ngp's own architecture converts:
a checkpoint whose meta records grid layout "corner" and coordinate
convention "ngp" (train with --grid_layout corner --grid_coord_convention
ngp, or start from an imported checkpoint). The EMA params are exported
where the file has them, as torch-ngp evaluates with those.

Usage:
  python -m nerfnav_tpu_torch.scripts.export_torch_ckpt ws/checkpoints/ngp_ep0100.npz \\
      --out ngp_ep0100.pth
"""

import argparse

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _grid(sd, name, tables):
    """Flat embeddings and int32 offsets of per-level tables."""
    tables = [_np(t) for t in tables]
    if any(t.shape[1] != tables[0].shape[1] for t in tables):
        raise ValueError("per-level feature dims differ: not a corner-layout checkpoint "
                         "(cell layout rows are 8 * level_dim wide and cannot be exported)")
    offsets = np.zeros(len(tables) + 1, np.int32)
    offsets[1:] = np.cumsum([t.shape[0] for t in tables])
    sd[f"{name}.embeddings"] = np.concatenate(tables, axis=0)
    sd[f"{name}.offsets"] = offsets


def export_params(params, grid_size: int = 128, density_grid=None):
    """params (lists of tensors or arrays, weights (in, out)) and an optional
    row-major density grid -> a torch-ngp state_dict of numpy arrays."""
    from nerfnav_tpu_torch.ops.morton import rowmajor_to_morton

    sd = {}
    _grid(sd, "encoder", params["encoder"])
    for name in ("sigma_net", "color_net"):
        for i, w in enumerate(params[name]):
            sd[f"{name}.{i}.weight"] = _np(w).T
    if "bg_encoder" in params:
        _grid(sd, "encoder_bg", params["bg_encoder"])
        for i, w in enumerate(params["bg_net"]):
            sd[f"bg_net.{i}.weight"] = _np(w).T
    if density_grid is not None:
        # torch-ngp indexes its density grid by Morton code
        dens = _np(density_grid)
        if dens.shape[1] != grid_size**3:
            raise ValueError(f"density grid of {dens.shape[1]} cells, expected "
                             f"{grid_size**3}: pass --grid_size")
        out = np.zeros_like(dens)
        out[:, rowmajor_to_morton(grid_size)] = dens
        sd["density_grid"] = out
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert an npz checkpoint to torch-ngp .pth")
    ap.add_argument("ckpt", help="npz checkpoint")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--grid_size", type=int, default=128)
    args = ap.parse_args(argv)

    from nerfnav_tpu_torch.training.checkpoint import load_checkpoint_npz

    loaded = load_checkpoint_npz(args.ckpt, device="cpu")
    meta = loaded["meta"]
    grid_meta = meta.get("grid", {})
    # the meta must record torch-ngp's architecture: a checkpoint without a
    # coord_convention entry was trained on the vertex lattice
    if grid_meta.get("layout") != "corner" or grid_meta.get("coord_convention") != "ngp":
        raise SystemExit(
            f"checkpoint grid meta {grid_meta} is not torch-ngp's architecture (needs "
            "recorded layout=corner and coord_convention=ngp; see the module doc)")
    occ = loaded["occupancy"]
    density = None if occ is None else occ.get("density_grid")
    sd = export_params(loaded["ema_params"], args.grid_size, density)
    state = {"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
             "epoch": meta.get("epoch", 0), "global_step": meta.get("global_step", 0),
             "stats": {"checkpoints": []}}
    torch.save(state, args.out)
    print(f"exported {args.ckpt} -> {args.out} "
          f"({len(sd)} tensors{', density grid' if density is not None else ''})")


if __name__ == "__main__":
    main()
