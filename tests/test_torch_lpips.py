"""nerfnav_tpu_torch's LPIPS net and meter vs the JAX package's, on the CPU.

Both packages load the same AlexNet-width LPIPS weights (convs 64-192-384-256-
256, five 1x1 heads) from one .npz of seeded random arrays under the `lpips`
package's state_dict names, and a torch .pth of the same arrays. Distances
of 64x64 image pairs within 1e-5 (relative).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.training import lpips_jax
from nerfnav_tpu.training.metrics import LPIPSMeter as JMeter
from nerfnav_tpu_torch.training import LPIPSMeter
from nerfnav_tpu_torch.training import lpips_net

torch.set_num_threads(1)

# AlexNet `features` conv index -> (out, in, kernel), lpips slice
ALEX = {0: ((64, 3, 11), 1), 3: ((192, 64, 5), 2), 6: ((384, 192, 3), 3),
        8: ((256, 384, 3), 4), 10: ((256, 256, 3), 5)}


def write_lpips_npz(path, seed=0):
    """An lpips.LPIPS(net='alex') state_dict of seeded arrays (He-scaled
    convs, non-negative heads as trained LPIPS keeps them), as an .npz."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, ((o, i, k), sl) in ALEX.items():
        sd[f"net.slice{sl}.{idx}.weight"] = (rng.normal(size=(o, i, k, k))
                                             * np.sqrt(2.0 / (i * k * k))).astype(np.float32)
        sd[f"net.slice{sl}.{idx}.bias"] = (rng.normal(size=o) * 0.01).astype(np.float32)
    for n, ((o, _, _), _) in enumerate(ALEX.values()):
        sd[f"lin{n}.model.1.weight"] = np.abs(rng.normal(size=(1, o, 1, 1)) * 0.1).astype(
            np.float32)
    sd["scaling_layer.shift"] = np.asarray([-0.030, -0.088, -0.188], np.float32).reshape(
        1, 3, 1, 1)
    sd["scaling_layer.scale"] = np.asarray([0.458, 0.448, 0.450], np.float32).reshape(1, 3, 1, 1)
    np.savez(path, **sd)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    npz = write_lpips_npz(str(d / "alex.npz"))
    pth = str(d / "alex.pth")
    torch.save({k: torch.as_tensor(v) for k, v in np.load(npz).items()}, pth)
    return npz, pth


def _images(seed, n=3):
    rng = np.random.default_rng(seed)
    base = rng.random((64, 64, 3), dtype=np.float32)
    return [np.clip(base + rng.normal(scale=0.1 * (i + 1), size=base.shape), 0, 1).astype(
        np.float32) for i in range(n)]


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_net_matches_jax(weights, fmt):
    """The distance of 64x64 pairs (batched too) within 1e-5 relative, from
    an .npz and from a torch .pth; LPIPS(x, x) = 0."""
    path = weights[0] if fmt == "npz" else weights[1]
    wj = lpips_jax.LPIPS(weights[0])
    net = lpips_net.LPIPSNet(lpips_net.load_lpips_weights(path), device="cpu")
    imgs = _images(1)
    a = torch.as_tensor(np.stack(imgs[:2])).permute(0, 3, 1, 2) * 2 - 1
    b = torch.as_tensor(np.stack(imgs[1:])).permute(0, 3, 1, 2) * 2 - 1
    with torch.no_grad():
        dt = net(a, b).numpy()
    dj = np.asarray(lpips_jax._lpips_distance(wj.weights, jnp.asarray(a.numpy()),
                                              jnp.asarray(b.numpy())))
    assert (dj > 0).all()
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    tool = lpips_net.LPIPS(path, device="cpu")
    assert tool(imgs[0], imgs[0]) == 0.0
    np.testing.assert_allclose(tool(imgs[0], imgs[1]), wj(imgs[0], imgs[1]), rtol=1e-5)
    np.testing.assert_allclose(tool(torch.as_tensor(imgs[0]), imgs[1]), float(dt[0]),
                               rtol=1e-6)


def test_meter_matches_jax(weights):
    """update, measure and report over three pairs against the JAX meter's;
    clear; the 'alex' backbone only."""
    mt = LPIPSMeter(net="alex", weights_path=weights[0], device="cpu")
    mj = JMeter(net="alex", weights_path=weights[0])
    assert mt.available and mj.available
    imgs = _images(2, 4)
    for x in imgs[1:]:
        np.testing.assert_allclose(mt.update(x, imgs[0]), mj.update(x, imgs[0]), rtol=1e-5)
    np.testing.assert_allclose(mt.measure(), mj.measure(), rtol=1e-5)
    assert mt.N == mj.N == 3
    assert mt.report().startswith("LPIPS (alex) = ")
    assert mt.report()[:20] == mj.report()[:20]
    mt.clear()
    assert mt.measure() == 0.0 and mt.N == 0
    with pytest.raises(ValueError, match="alex"):
        LPIPSMeter(net="vgg", weights_path=weights[0], device="cpu")


def test_meter_without_weights_raises(monkeypatch):
    """No weights_path and no lpips package: unavailable, and update raises."""
    monkeypatch.setitem(sys.modules, "lpips", None)  # the import fails
    m = LPIPSMeter(device="cpu")
    assert not m.available
    with pytest.raises(RuntimeError, match="pretrained weights"):
        m.update(np.zeros((8, 8, 3), np.float32), np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_meter_lpips_package_runs_on_its_device(monkeypatch, device):
    """No weights_path, the lpips package installed (a stub here): its
    network and both images go to the meter's device ("meta" stands for a
    device other than the CPU), as (1, 3, H, W) in [-1, 1]."""
    import types

    seen = []

    class StubLPIPS(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.backbone = net
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, p, t):
            seen.append((self.w.device, p.device, t.device, tuple(p.shape)))
            if p.device.type == "meta":
                return torch.tensor(0.25)
            return ((p - t).abs().mean() * self.w)[None]

    monkeypatch.setitem(sys.modules, "lpips", types.SimpleNamespace(LPIPS=StubLPIPS))
    m = LPIPSMeter(net="alex", device=device)
    assert m.available and m._fn.backbone == "alex"
    a, b = _images(1, 2)
    v = m.update(a, b)
    dev = torch.device(device)
    assert seen == [(dev, dev, dev, (1, 3) + a.shape[:2])]
    if device == "cpu":
        np.testing.assert_allclose(v, 2 * np.abs(a - b).mean(), rtol=1e-6)
    assert m.N == 1 and m.measure() == v
