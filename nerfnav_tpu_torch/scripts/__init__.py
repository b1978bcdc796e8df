"""Command-line converters between torch-ngp checkpoints (.pth) and the
package's npz checkpoints (import_torch_ckpt, export_torch_ckpt)."""
