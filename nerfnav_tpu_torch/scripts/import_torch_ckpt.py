"""Import a torch-ngp checkpoint (.pth) as an npz checkpoint of this package.

Counterpart of nerfnav_tpu/scripts/import_torch_ckpt.py, writing the same
npz (training/checkpoint.py's format, which both packages read). A torch-ngp
Trainer checkpoint is {'model': state_dict, 'mean_density', 'epoch', ...};
the mapping is

  encoder.embeddings + encoder.offsets  -> params["encoder"] per-level tables
  sigma_net.{i}.weight (out, in)        -> params["sigma_net"] (in, out) list
  color_net.{i}.weight                  -> params["color_net"]
  encoder_bg.* / bg_net.* (if present)  -> params["bg_encoder"] / ["bg_net"]
  density_grid [CAS, H^3] (Morton)      -> the occupancy state (row-major),
                                           bitfields and blocks rebuilt

The imported model renders with torch-ngp's lattice: --grid_layout corner
--grid_coord_convention ngp (recorded in the checkpoint's meta, which the
loaders check). The config this script builds gives a background network a
placeholder radius of 1: render such a model with the scene's --bg_radius.
The occupancy is rebuilt on the card unless --device cpu is given.

Usage:
  python -m nerfnav_tpu_torch.scripts.import_torch_ckpt ref_ckpt.pth \\
      --out workspace/checkpoints/ngp_ep0001.npz --bound 2.0
"""

import argparse
import math

import numpy as np
import torch


def _state_dict(ckpt):
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt["model"], ckpt
    return ckpt, {}


def _weights(sd, name):
    """The (in, out) weight list of MLP `name`, in layer order."""
    out = []
    while f"{name}.{len(out)}.weight" in sd:
        out.append(np.asarray(sd[f"{name}.{len(out)}.weight"], np.float32).T)
    return out


def _tables(sd, name):
    """Per-level tables of grid `name` from its flat embeddings and offsets."""
    emb = np.asarray(sd[f"{name}.embeddings"], np.float32)
    off = np.asarray(sd[f"{name}.offsets"], np.int64)
    return [emb[off[i]:off[i + 1]] for i in range(len(off) - 1)], np.diff(off)


def import_state_dict(sd, bound: float, base_resolution: int = 16,
                      log2_hashmap_size: int | None = None, grid_size: int = 128,
                      density_thresh: float = 10.0, mean_density: float | None = None,
                      desired_resolution: int | None = None, device="cuda"):
    """A torch-ngp NeRFNetwork state_dict (numpy values) -> (params dict of
    tensors on `device`, NetworkConfig, occupancy state or None)."""
    from nerfnav_tpu_torch.device import resolve_device
    from nerfnav_tpu_torch.models.network import NetworkConfig

    dev = resolve_device(device)
    tables, sizes = _tables(sd, "encoder")
    if log2_hashmap_size is None:
        # capped levels hold exactly 2^log2 rows; an uncapped grid needs the flag
        top = int(sizes.max())
        log2_hashmap_size = int(round(math.log2(top)))
        if 2**log2_hashmap_size != top:
            raise ValueError(
                f"cannot infer log2_hashmap_size from level sizes {sizes}; "
                "pass --log2_hashmap_size explicitly")
    sigma_ws, color_ws, bg_ws = (_weights(sd, n) for n in ("sigma_net", "color_net", "bg_net"))
    if not sigma_ws or not color_ws:
        raise ValueError("state_dict has no sigma_net/color_net weights: "
                         "is this a torch-ngp NeRFNetwork checkpoint?")
    if desired_resolution is None:
        desired_resolution = int(2048 * bound)  # torch-ngp's network default
    cfg = NetworkConfig(
        bound=bound,
        grid_levels=len(tables),
        grid_level_dim=tables[0].shape[1],
        grid_base_resolution=base_resolution,
        # NetworkConfig scales grid_max_resolution by bound
        grid_max_resolution=int(round(desired_resolution / bound)),
        grid_log2_hashmap_size=log2_hashmap_size,
        grid_layout="corner",
        grid_coord_convention="ngp",
        num_layers=len(sigma_ws),
        hidden_dim=sigma_ws[0].shape[1],
        geo_feat_dim=sigma_ws[-1].shape[1] - 1,
        num_layers_color=len(color_ws),
        hidden_dim_color=color_ws[0].shape[1],
        bg_radius=1.0 if bg_ws else -1.0,  # a placeholder: see the module doc
        num_layers_bg=max(len(bg_ws), 2),
        hidden_dim_bg=bg_ws[0].shape[1] if bg_ws else 64,
    )
    if tuple(int(s) for s in sizes) != tuple(cfg.grid.level_sizes):
        raise ValueError(
            f"level-size schedule mismatch: checkpoint {list(sizes)} vs config "
            f"{list(cfg.grid.level_sizes)}: check --bound / --base_resolution / "
            "--log2_hashmap_size against the torch-ngp training flags")
    params = {"encoder": tables, "sigma_net": sigma_ws, "color_net": color_ws}
    if bg_ws:
        bg_tables, bg_sizes = _tables(sd, "encoder_bg")
        if tuple(int(s) for s in bg_sizes) != tuple(cfg.bg_grid.level_sizes):
            raise ValueError(f"bg grid schedule mismatch: {tuple(bg_sizes)} vs "
                             f"{cfg.bg_grid.level_sizes}")
        params["bg_encoder"] = bg_tables
        params["bg_net"] = bg_ws
    params = {k: [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in v]
              for k, v in params.items()}
    occupancy = None
    if "density_grid" in sd:
        occupancy = _import_density_grid(np.asarray(sd["density_grid"], np.float32), bound,
                                         grid_size, density_thresh, mean_density, dev)
    return params, cfg, occupancy


def _import_density_grid(dens_morton, bound, grid_size, density_thresh, mean_density,
                         device="cuda"):
    """torch-ngp's density_grid [CAS, H^3] is indexed by Morton code; the
    port's is row-major (x H + y) H + z. Decode it and rebuild the
    bitfields and blocks on `device`."""
    from nerfnav_tpu_torch.models.occupancy import (
        OccupancyConfig, _finish_update, init_occupancy_state,
    )
    from nerfnav_tpu_torch.ops.morton import rowmajor_to_morton

    cas, n = dens_morton.shape
    if n != grid_size**3:
        raise ValueError(f"density_grid has {n} cells, expected {grid_size**3}")
    cfg = OccupancyConfig(bound=bound, grid_size=grid_size, density_thresh=density_thresh)
    if cfg.cascades != cas:
        raise ValueError(f"checkpoint has {cas} density cascades but bound={bound} "
                         f"implies {cfg.cascades}: pass torch-ngp's --bound")
    state = init_occupancy_state(cfg, device=device)
    grid = torch.from_numpy(dens_morton[:, rowmajor_to_morton(grid_size)]).to(state[
        "density_grid"].device)
    state = _finish_update(state, cfg, grid, grid, None)
    if mean_density is not None:
        state["mean_density"] = torch.tensor(float(mean_density), device=grid.device)
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a torch-ngp .pth checkpoint to npz")
    ap.add_argument("ckpt", help="torch-ngp checkpoint (.pth)")
    ap.add_argument("--out", required=True,
                    help="output npz path (e.g. ws/checkpoints/ngp_ep0001.npz)")
    ap.add_argument("--bound", type=float, required=True,
                    help="the --bound the model was trained with (sets the level "
                         "schedule through desired_resolution)")
    ap.add_argument("--base_resolution", type=int, default=16)
    ap.add_argument("--desired_resolution", type=int, default=None,
                    help="finest-level resolution (torch-ngp's default 2048 * bound)")
    ap.add_argument("--log2_hashmap_size", type=int, default=None)
    ap.add_argument("--grid_size", type=int, default=128)
    ap.add_argument("--density_thresh", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="where the occupancy is rebuilt (cuda, or cpu)")
    args = ap.parse_args(argv)

    from nerfnav_tpu_torch.training import checkpoint as ckpt_lib

    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd_t, extras = _state_dict(ckpt)
    sd = {k: v.detach().cpu().numpy() for k, v in sd_t.items() if hasattr(v, "detach")}
    params, cfg, occupancy = import_state_dict(
        sd, args.bound, args.base_resolution, args.log2_hashmap_size, args.grid_size,
        args.density_thresh, mean_density=extras.get("mean_density"),
        desired_resolution=args.desired_resolution, device=args.device)
    tree = {"params": params, "ema_params": params}
    if occupancy is not None:
        tree["occupancy"] = occupancy
    meta = {"epoch": int(extras.get("epoch", 0)),
            "global_step": int(extras.get("global_step", 0)),
            "grid": cfg.grid_meta(), "imported_from": "torch-ngp"}
    ckpt_lib.save_checkpoint(args.out, tree, meta)
    print(f"imported {args.ckpt} -> {args.out}")
    print(f"  grid: corner {cfg.grid_levels}x{cfg.grid_level_dim} "
          f"@2^{cfg.grid_log2_hashmap_size} (ngp convention)")
    print(f"  background network: {'yes' if 'bg_net' in params else 'no'}")
    print(f"  occupancy: {'yes' if occupancy is not None else 'no'}")
    print("Evaluate with --grid_layout corner --grid_coord_convention ngp"
          + (" and the scene's --bg_radius" if "bg_net" in params else "") + ".")


if __name__ == "__main__":
    main()
