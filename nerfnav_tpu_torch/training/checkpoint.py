"""Checkpoints in the JAX package's format, both ways, and the weight bridge.

The JAX package stores params as a pytree (`encoder` level list, absent
for a frequency-encoded field, `sigma_net`, `color_net` weight lists,
weights (in, out), and with a background network `bg_encoder` and
`bg_net`) and checkpoints as
one .npz of path-keyed leaves (`k:['ema_params']['encoder'][0]`, ...) plus a
`__meta__` JSON blob (nerfnav_tpu/training/checkpoint.py). This module
writes and reads that format from the port's tensors, so checkpoints cross
in both directions: `save_checkpoint` / `load_checkpoint` take nested dicts,
lists and NamedTuples of tensors, and `adam_to_optax` / `adam_from_optax` map
a torch Adam's moments onto optax's adam state (count, mu, nu under the
params' key paths) and back. uint32 words, carried in int64 here, are
written as uint32 again. `load_checkpoint_npz` reads a JAX checkpoint's
params and occupancy for rendering.
"""

import glob
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from nerfnav_tpu_torch.device import resolve_device

# every params key in the order init_network builds them; the MLPs are
# required, the encoders optional (bg_encoder comes with bg_net)
_PARAM_KEYS = ("encoder", "sigma_net", "color_net", "bg_encoder", "bg_net")
_REQUIRED_KEYS = ("sigma_net", "color_net")


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the update count and the two moment trees."""
    count: torch.Tensor
    mu: dict
    nu: dict


class ScheduleState(NamedTuple):
    """optax's ScaleByScheduleState: the count the learning rate reads."""
    count: torch.Tensor


def _map(tree, fn, path=""):
    """Rebuild `tree` with fn(keystr, leaf) at every tensor leaf; keystr is
    jax.tree_util.keystr of the leaf's path (dict keys, sequence indices,
    NamedTuple attributes)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(getattr(tree, f), fn, f"{path}.{f}") for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def _numpy(key: str, t: torch.Tensor):
    """A leaf as the JAX package stores it: int64 as uint32 (block words)
    or int32 (counters), bf16 as f32."""
    a = t.detach().cpu()
    if a.dtype == torch.int64:
        return a.numpy().astype(np.uint32 if "['blocks" in key else np.int32)
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.numpy()


def save_checkpoint(path: str, tree, meta: dict | None = None):
    """One .npz of path-keyed leaves plus `__meta__` (JAX-package format)."""
    arrays = {}

    def put(key, leaf):
        arrays[f"k:{key}"] = _numpy(key, leaf)

    _map(tree, put)
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"treedef": "nerfnav_tpu_torch", "meta": meta or {}}).encode(),
        dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_checkpoint(path: str, like):
    """Load into the structure of `like`, a tree of tensors: each leaf whose
    key and shape the file holds takes the file's values (in the leaf's
    dtype, on its device); the others keep the template's and are reported.
    Returns (tree, meta, report)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    report = []
    with np.load(path, allow_pickle=False) as data:
        info = json.loads(bytes(data["__meta__"].tobytes()).decode())

        def take(key, tmpl):
            k = f"k:{key}"
            if k in data.files and data[k].shape == tuple(tmpl.shape):
                return _tensor(data[k], tmpl.device).to(tmpl.dtype)
            report.append(f"{k}: missing or shape mismatch, kept template")
            return tmpl

        tree = _map(like, take)
    return tree, info["meta"], report


def _leaves(params):
    return [t for k in sorted(params) for t in params[k]]


def adam_to_optax(optimizer, params):
    """A torch Adam's state over `params` (its param tensors) as optax's adam
    state: (AdamState(count, mu, nu), ScheduleState(count))."""
    states = [optimizer.state.get(p, {}) for p in _leaves(params)]
    count = int(states[0]["step"]) if states[0] else 0

    def moment(name):
        return {k: [optimizer.state[p][name] if optimizer.state.get(p) else torch.zeros_like(p)
                    for p in params[k]] for k in params}

    c = torch.tensor(count, dtype=torch.int64)
    return (AdamState(count=c, mu=moment("exp_avg"), nu=moment("exp_avg_sq")),
            ScheduleState(count=c.clone()))


def adam_from_optax(optimizer, params, opt_state):
    """Set a torch Adam's state over `params` from optax's adam state (as
    adam_to_optax shapes it); a count of 0 leaves the optimizer fresh."""
    adam = opt_state[0]
    count = int(adam.count)
    for k in params:
        for p, mu, nu in zip(params[k], adam.mu[k], adam.nu[k]):
            optimizer.state.pop(p, None)
            if count:
                optimizer.state[p] = {"step": torch.tensor(float(count)),
                                      "exp_avg": mu.detach().clone(),
                                      "exp_avg_sq": nu.detach().clone()}


def check_grid_meta(meta: dict, cfg, path: str):
    """Raise when the checkpoint's recorded grid architecture disagrees with
    cfg's `grid_meta()` (only the keys the file recorded are compared)."""
    saved = (meta or {}).get("grid")
    current = cfg.grid_meta()
    if saved and any(v != saved[k] for k, v in current.items() if k in saved):
        raise ValueError(
            f"checkpoint {path} was trained with grid architecture {saved}, but "
            f"the config is {current}: loading would keep random template params")


def prune_checkpoints(ckpt_dir: str, name: str, max_keep: int = 2):
    """Rolling window: delete the oldest <name>_ep*.npz beyond max_keep."""
    files = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.npz")))
    for f in files[:-max_keep]:
        os.remove(f)


def latest_checkpoint(ckpt_dir: str, name: str):
    files = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.npz")))
    return files[-1] if files else None


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
    if extra:
        raise ValueError(f"unknown params keys {sorted(extra)}")
    missing = [k for k in _REQUIRED_KEYS if k not in tree]
    if missing or ("bg_encoder" in tree) != ("bg_net" in tree):
        raise ValueError(f"params keys {sorted(tree)}: need sigma_net and color_net, "
                         "and bg_encoder with bg_net")
    return {k: [_tensor(a, dev) for a in tree[k]] for k in _PARAM_KEYS if k in tree}


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
            # sigma_net: every field has one (a frequency field no encoder)
            if f"k:{cand}['sigma_net'][0]" in data.files:
                prefix = cand
                break
        if prefix is None:
            raise ValueError(f"{path}: no path-keyed sigma_net weights")
        tree = {k: rows for k in _PARAM_KEYS if (rows := _collect(data, prefix, k))}
        occ_prefix = "k:['occupancy']['"
        occ = {k[len(occ_prefix):-2]: data[k] for k in data.files
               if k.startswith(occ_prefix)}
    return {
        "ema_params": params_from_numpy(tree, device),
        "occupancy": occupancy_from_numpy(occ, device) if occ else None,
        "meta": info.get("meta", {}),
    }
