"""Evaluation metrics: PSNR.

Counterpart of nerfnav_tpu/training/metrics.py (`PSNRMeter`). LPIPS needs
pretrained towers and is ROADMAP A11."""

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

    def report(self):
        return f"PSNR = {self.measure():.6f}"
