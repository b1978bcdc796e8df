"""The weight bridge: JAX-package params, occupancy and checkpoints -> port.

The JAX package stores params as a pytree (`encoder` level list,
`sigma_net`, `color_net` weight lists, weights (in, out)) and checkpoints as
one .npz of path-keyed leaves (`k:['ema_params']['encoder'][0]`, ...) plus a
`__meta__` JSON blob (nerfnav_tpu/training/checkpoint.py). These functions
read both into the port's layout, so a JAX-trained field renders here.
Writing checkpoints arrives with training (ROADMAP A9).
"""

import json

import numpy as np
import torch

from nerfnav_tpu_torch.device import resolve_device, unported

_PARAM_KEYS = ("encoder", "sigma_net", "color_net")


def _tensor(a, device):
    """numpy (incl. ml_dtypes bfloat16) -> tensor; uint32 -> int64."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    if a.dtype in (np.uint32, np.int32):
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)  # copy: a may be read-only


def params_from_numpy(tree, device="cuda"):
    """JAX params pytree (numpy leaves) -> the port's params dict."""
    dev = resolve_device(device)
    extra = set(tree) - set(_PARAM_KEYS)
    if extra & {"bg_encoder", "bg_net"}:
        raise unported("the background network (bg_encoder / bg_net)", "A3")
    if extra:
        raise ValueError(f"unknown params keys {sorted(extra)}")
    return {k: [_tensor(a, dev) for a in tree[k]] for k in _PARAM_KEYS}


def occupancy_from_numpy(occ, device="cuda"):
    """JAX occupancy state dict (numpy leaves) -> the port's: uint32 block
    words become int64, other leaves keep their values."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in occ.items()}


def _collect(data, prefix, name):
    rows, i = [], 0
    while f"k:{prefix}['{name}'][{i}]" in data.files:
        rows.append(data[f"k:{prefix}['{name}'][{i}]"])
        i += 1
    return rows


def load_checkpoint_npz(path: str, device="cuda"):
    """Read a JAX-package checkpoint .npz.

    Returns {"ema_params": params dict, "occupancy": occupancy dict or None,
    "meta": the saved meta dict}. Full checkpoints give their EMA params
    (what the reference evaluates with); model-only ("best") files give
    their root params."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        info = json.loads(bytes(data["__meta__"].tobytes()).decode())
        prefix = None
        for cand in ("['ema_params']", "['params']", ""):
            if f"k:{cand}['encoder'][0]" in data.files:
                prefix = cand
                break
        if prefix is None:
            raise ValueError(f"{path}: no path-keyed encoder tables")
        tree = {k: _collect(data, prefix, k) for k in _PARAM_KEYS}
        if _collect(data, prefix, "bg_encoder"):
            tree["bg_encoder"] = _collect(data, prefix, "bg_encoder")
        occ_prefix = "k:['occupancy']['"
        occ = {k[len(occ_prefix):-2]: data[k] for k in data.files
               if k.startswith(occ_prefix)}
    return {
        "ema_params": params_from_numpy(tree, device),
        "occupancy": occupancy_from_numpy(occ, device) if occ else None,
        "meta": info.get("meta", {}),
    }
