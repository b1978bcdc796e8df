"""The LPIPS perceptual distance (AlexNet backbone, LPIPS v0.1).

Counterpart of nerfnav_tpu/training/lpips_jax.py (`load_lpips_weights`,
`LPIPS`). The pretrained weights are the user's to supply, as for the JAX
package: an `lpips.LPIPS(net='alex').state_dict()` saved by torch, or the
same arrays in an .npz under the same key names:

    # on a machine with the lpips package and its weights:
    python -c "import lpips, torch; \\
        torch.save(lpips.LPIPS(net='alex').state_dict(), 'lpips_alex.pth')"
    # then:
    LPIPSMeter(net='alex', weights_path='lpips_alex.pth')

Input in [-1, 1] -> scaling layer (shift, scale) -> AlexNet features,
tapping relu1..relu5 (max pools of 3 with stride 2 before convs 2 and 3) ->
unit norm over channels -> squared difference -> a 1x1 linear head per layer
(no bias) -> spatial mean -> sum over layers. Plain conv2d and max_pool2d, as
the JAX package runs it in XLA ops.
"""

import numpy as np
import torch
import torch.nn.functional as F

from nerfnav_tpu_torch.device import resolve_device

# torchvision AlexNet `features` index of each conv -> the LPIPS slice that
# holds it (lpips/pretrained_networks.py alexnet)
_SLICES = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
_STRIDE_PAD = ((4, 2), (1, 2), (1, 1), (1, 1), (1, 1))
# LPIPS v0.1 scaling layer constants (lpips/lpips.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_lpips_weights(path: str):
    """{"convs": [(w OIHW, b)] x 5, "lins": [(1, C)] x 5, "shift", "scale"}
    as float32 numpy arrays, from an .npz or a torch state_dict."""
    if path.endswith(".npz"):
        data = np.load(path)
        sd = {k: data[k] for k in data.files}
    else:
        sd = {k: v.detach().cpu().numpy()
              for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    convs = [(f32(sd[f"net.slice{sl}.{idx}.weight"]), f32(sd[f"net.slice{sl}.{idx}.bias"]))
             for idx, sl in _SLICES.items()]
    lins = [f32(sd[f"lin{i}.model.1.weight"]).reshape(1, -1) for i in range(5)]
    return {"convs": convs, "lins": lins,
            "shift": f32(sd.get("scaling_layer.shift", _SHIFT)).reshape(3),
            "scale": f32(sd.get("scaling_layer.scale", _SCALE)).reshape(3)}


def _unit_norm(f, eps=1e-10):
    return f / (torch.sqrt((f**2).sum(dim=1, keepdim=True)) + eps)


class LPIPSNet(torch.nn.Module):
    """LPIPS distances of (N, 3, H, W) image pairs in [-1, 1]: (N,)."""

    def __init__(self, weights: dict, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.convs = [(t(w), t(b)) for w, b in weights["convs"]]
        self.lins = [t(w) for w in weights["lins"]]
        self.shift = t(weights["shift"])[None, :, None, None]
        self.scale = t(weights["scale"])[None, :, None, None]

    def features(self, x):
        """The five relu taps of the AlexNet trunk."""
        feats = []
        for i, ((w, b), (stride, pad)) in enumerate(zip(self.convs, _STRIDE_PAD)):
            if i in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
            feats.append(x)
        return feats

    def forward(self, a, b):
        fa = self.features((a - self.shift) / self.scale)
        fb = self.features((b - self.shift) / self.scale)
        total = 0.0
        for x, y, lin in zip(fa, fb, self.lins):
            d = (_unit_norm(x) - _unit_norm(y)) ** 2                 # (N, C, H, W)
            total = total + torch.einsum("nchw,oc->nohw", d, lin).mean(dim=(1, 2, 3))
        return total


class LPIPS:
    """The LPIPS distance of two (H, W, 3) images in [0, 1] (numpy or
    tensors), as a float."""

    def __init__(self, weights_path: str, device="cuda"):
        self.net = LPIPSNet(load_lpips_weights(weights_path), device)

    def __call__(self, pred_hwc, gt_hwc):
        dev = self.net.shift.device
        ab = [torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                              dtype=torch.float32, device=dev).permute(2, 0, 1)[None] * 2 - 1
              for x in (pred_hwc, gt_hwc)]
        with torch.no_grad():
            return float(self.net(*ab)[0])
