"""Evaluation metrics: PSNR, LPIPS, and the sRGB transfer curve.

Counterpart of nerfnav_tpu/training/metrics.py (`PSNRMeter`, `LPIPSMeter`,
`linear_to_srgb`, `srgb_to_linear`). LPIPS needs pretrained weights, which
the user supplies (training/lpips_net.py)."""

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


class LPIPSMeter:
    """Accumulates the LPIPS distance over image pairs (reference
    metrics.py:42-115).

    Weight sources, in the reference's order: `weights_path`, an
    `lpips.LPIPS(net='alex').state_dict()` file (or .npz) the user supplies,
    run by training/lpips_net.py on `device`; else the `lpips` package, if
    it is installed with its weights. With neither, `available` is False
    and update() raises."""

    def __init__(self, net: str = "alex", weights_path: str | None = None, device="cuda"):
        from nerfnav_tpu_torch.device import resolve_device

        self.net = net
        self.clear()
        self._fn = None
        self._port_fn = None
        self.device = resolve_device(device)
        if weights_path is not None:
            from nerfnav_tpu_torch.training.lpips_net import LPIPS

            if net != "alex":
                raise ValueError("the port's LPIPS implements the 'alex' backbone; "
                                 "use the lpips package for vgg/squeeze")
            self._port_fn = LPIPS(weights_path, self.device)
            self.available = True
            return
        try:
            import lpips

            self._fn = lpips.LPIPS(net=net).to(self.device)
            self.available = True
        except Exception:
            self.available = False

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        """preds, truths: (H, W, 3) images in [0, 1]; returns their distance."""
        if not self.available:
            raise RuntimeError(
                "LPIPS needs pretrained weights: pass LPIPSMeter(weights_path=...) with "
                "a saved lpips.LPIPS(net='alex').state_dict() (see "
                "training/lpips_net.py), or install the `lpips` package")
        if self._port_fn is not None:
            v = self._port_fn(preds, truths)
        else:
            import torch

            p, t = (torch.as_tensor(np.asarray(x, np.float32), device=self.device)
                    .permute(2, 0, 1)[None] * 2 - 1 for x in (preds, truths))
            with torch.no_grad():
                v = float(self._fn(p, t).item())
        self.V += v
        self.N += 1
        return v

    def measure(self):
        return self.V / max(self.N, 1)

    def write(self, writer, global_step, prefix=""):
        if writer is not None:
            writer.add_scalar(f"{prefix}/LPIPS ({self.net})", self.measure(), global_step)

    def report(self):
        return f"LPIPS ({self.net}) = {self.measure():.6f}"


def linear_to_srgb(x):
    """Linear [0, 1] values to sRGB-encoded ones (reference utils.py:42-44)."""
    x = np.clip(x, 0, 1)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)


def srgb_to_linear(x):
    """sRGB-encoded [0, 1] values to linear ones (--color_space linear;
    reference metrics.py:122-125)."""
    x = np.clip(x, 0, 1)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
