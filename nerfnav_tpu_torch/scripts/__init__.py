"""Command-line converters: torch-ngp checkpoints (.pth) to and from the
package's npz checkpoints (import_torch_ckpt, export_torch_ckpt), and
datasets to transforms.json (colmap2nerf, llff2nerf, hyper2nerf,
tanks2nerf)."""
