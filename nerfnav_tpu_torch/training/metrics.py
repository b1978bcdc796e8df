"""Evaluation metrics: PSNR, and the sRGB transfer curve.

Counterpart of nerfnav_tpu/training/metrics.py (`PSNRMeter`,
`srgb_to_linear`). LPIPS needs pretrained towers and is ROADMAP A11."""

import numpy as np


class PSNRMeter:
    """Accumulates PSNR = -10 log10(MSE) over image pairs."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        """preds, truths: numpy arrays of one image each."""
        preds = np.asarray(preds, dtype=np.float32)
        truths = np.asarray(truths, dtype=np.float32)
        mse = float(np.mean((preds - truths) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        self.V += psnr
        self.N += 1
        return psnr

    def measure(self):
        return self.V / max(self.N, 1)

    def write(self, writer, global_step, prefix=""):
        """Add the PSNR as a scalar to a tensorboard writer, if there is one."""
        if writer is not None:
            writer.add_scalar(f"{prefix}/PSNR", self.measure(), global_step)

    def report(self):
        return f"PSNR = {self.measure():.6f}"


def srgb_to_linear(x):
    """sRGB-encoded [0, 1] values to linear ones (--color_space linear;
    reference metrics.py:122-125)."""
    x = np.clip(x, 0, 1)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
