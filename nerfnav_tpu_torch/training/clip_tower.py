"""The CLIP ViT image tower and the similarity loss of poseless training.

Counterpart of nerfnav_tpu/training/clip_jax.py (`load_clip_vision_weights`,
`clip_image_embed`, `preprocess`, `make_clip_loss_fn`). The pretrained
weights are the user's to supply, as for the JAX package: a CLIPModel or
CLIPVisionModelWithProjection state_dict saved by torch (or the same arrays
in an .npz, under the same Hugging Face key names), with a text embedding
computed offline by the text tower:

    # on a machine that can fetch the model:
    python - <<'PY'
    import numpy as np, torch
    from transformers import CLIPModel, CLIPProcessor
    m = CLIPModel.from_pretrained("openai/clip-vit-base-patch16")
    torch.save(m.state_dict(), "clip_vitb16.pth")
    proc = CLIPProcessor.from_pretrained("openai/clip-vit-base-patch16")
    t = proc(text=["a red chair"], return_tensors="pt")
    np.save("text_embed.npy", m.get_text_features(**t).detach().numpy()[0])
    PY
    # then:
    loss_fn = make_clip_loss_fn("clip_vitb16.pth", "text_embed.npy")
    Trainer(..., clip_loss_fn=loss_fn)   # with opt.rand_pose >= 0

The tower is Hugging Face's CLIPVisionModelWithProjection graph: patch
convolution, class token, learned positions, pre-LN, transformer blocks
(multi-head attention with q scaling, quick_gelu MLP), post-LN on the class
token, projection. The JAX package runs it as plain XLA ops, and so does the
port: torch.matmul, softmax and conv2d, no kernel of its own.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from nerfnav_tpu_torch.device import device_const, resolve_device

# OpenAI CLIP preprocessing constants
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


def _state_dict_arrays(path: str) -> dict:
    """{key: numpy array} of an .npz or of a torch state_dict file."""
    if path.endswith(".npz"):
        data = np.load(path)
        return {k: data[k] for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def load_clip_vision_weights(path: str, num_heads: int | None = None, device="cpu"):
    """(weights, cfg) of a CLIP vision tower saved with Hugging Face key
    names; text-tower keys are ignored. weights holds float32 tensors on
    `device` ("layers" a list of per-block dicts of (weight, bias));
    cfg = {"hidden", "patch", "image_size", "heads"}, heads defaulting to
    hidden / 64 as CLIP's ViTs have it."""
    sd = _state_dict_arrays(path)
    g = lambda k: torch.as_tensor(np.asarray(sd[k], np.float32), device=device)  # noqa: E731
    pe = sd["vision_model.embeddings.patch_embedding.weight"]
    hidden, _, patch, _ = pe.shape
    grid = int(round(math.sqrt(sd["vision_model.embeddings.position_embedding.weight"]
                               .shape[0] - 1)))
    wb = lambda k: (g(k + ".weight"), g(k + ".bias"))  # noqa: E731
    layers = []
    while f"vision_model.encoder.layers.{len(layers)}.layer_norm1.weight" in sd:
        p = f"vision_model.encoder.layers.{len(layers)}."
        layers.append({
            "ln1": wb(p + "layer_norm1"), "ln2": wb(p + "layer_norm2"),
            "q": wb(p + "self_attn.q_proj"), "k": wb(p + "self_attn.k_proj"),
            "v": wb(p + "self_attn.v_proj"), "o": wb(p + "self_attn.out_proj"),
            "fc1": wb(p + "mlp.fc1"), "fc2": wb(p + "mlp.fc2")})
    weights = {
        "patch": g("vision_model.embeddings.patch_embedding.weight"),
        "cls": g("vision_model.embeddings.class_embedding"),
        "pos": g("vision_model.embeddings.position_embedding.weight"),
        "pre_ln": wb("vision_model.pre_layrnorm"),
        "post_ln": wb("vision_model.post_layernorm"),
        "proj": g("visual_projection.weight"),
        "layers": layers,
    }
    cfg = {"hidden": int(hidden), "patch": int(patch), "image_size": grid * int(patch),
           "heads": num_heads if num_heads is not None else max(int(hidden) // 64, 1)}
    return weights, cfg


def _ln(x, wb, eps=1e-5):
    w, b = wb
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _linear(x, wb):
    return x @ wb[0].T + wb[1]


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPVisionTower(torch.nn.Module):
    """HF CLIPVisionModelWithProjection's image_embeds of normalized pixel
    values: (3, S, S) -> (proj_dim,), or batched (B, 3, S, S) -> (B,
    proj_dim). The weights are fixed tensors, not parameters: only the image
    is differentiated."""

    def __init__(self, weights: dict, cfg: dict):
        super().__init__()
        self.weights, self.cfg = weights, cfg

    @classmethod
    def load(cls, path: str, num_heads: int | None = None, device="cuda"):
        """The tower of a weights file, on `device` (the card by default)."""
        return cls(*load_clip_vision_weights(path, num_heads, resolve_device(device)))

    def forward(self, pixel_values):
        single = pixel_values.dim() == 3
        x = pixel_values[None] if single else pixel_values
        w, cfg = self.weights, self.cfg
        c, nh = cfg["hidden"], cfg["heads"]
        hd = c // nh
        h = F.conv2d(x, w["patch"], stride=cfg["patch"])             # (B, C, gh, gw)
        tokens = h.flatten(2).transpose(1, 2)                        # (B, gh*gw, C)
        cls = w["cls"].expand(tokens.shape[0], 1, c)
        x = _ln(torch.cat([cls, tokens], dim=1) + w["pos"], w["pre_ln"])
        b, t, _ = x.shape
        for lw in w["layers"]:
            r = _ln(x, lw["ln1"])
            q = (_linear(r, lw["q"]) * hd**-0.5).reshape(b, t, nh, hd).transpose(1, 2)
            k = _linear(r, lw["k"]).reshape(b, t, nh, hd).transpose(1, 2)
            v = _linear(r, lw["v"]).reshape(b, t, nh, hd).transpose(1, 2)
            att = torch.softmax(q @ k.transpose(-1, -2), dim=-1)     # (B, nh, t, t)
            r = (att @ v).transpose(1, 2).reshape(b, t, c)
            x = x + _linear(r, lw["o"])
            r = _ln(x, lw["ln2"])
            x = x + _linear(_quick_gelu(_linear(r, lw["fc1"])), lw["fc2"])
        emb = _ln(x[:, 0], w["post_ln"]) @ w["proj"].T
        return emb[0] if single else emb


def preprocess(image_hwc, image_size: int):
    """(H, W, 3) float in [0, 1] -> (3, S, S) CLIP-normalized, differentiable.
    jax.image.resize's "bilinear" antialiases when it shrinks, as
    F.interpolate does with antialias=True."""
    img = F.interpolate(image_hwc.permute(2, 0, 1)[None], size=(image_size, image_size),
                        mode="bilinear", align_corners=False, antialias=True)[0]
    mean = device_const(_MEAN, img.device)[:, None, None]
    std = device_const(_STD, img.device)[:, None, None]
    return (img - mean) / std


class CLIPLoss:
    """loss(image (h, w, 3) in [0, 1]) = 1 - cos(tower(image), text): the
    scorer Trainer.clip_loss_fn expects."""

    def __init__(self, tower: CLIPVisionTower, text_embed: torch.Tensor):
        self.tower = tower
        self.text = text_embed / torch.linalg.norm(text_embed)

    def __call__(self, image):
        emb = self.tower(preprocess(image, self.tower.cfg["image_size"]))
        emb = emb / (torch.linalg.norm(emb) + 1e-8)
        return 1.0 - torch.dot(emb, self.text)


def make_clip_loss_fn(weights_path: str, text_embed, num_heads: int | None = None,
                      device="cuda") -> CLIPLoss:
    """The similarity loss of a weights file and a text embedding (a
    (proj_dim,) array or an .npy path, computed offline by the text tower),
    on `device`."""
    tower = CLIPVisionTower.load(weights_path, num_heads, device)
    if isinstance(text_embed, str):
        text_embed = np.load(text_embed)
    dev = tower.weights["proj"].device
    return CLIPLoss(tower, torch.as_tensor(np.asarray(text_embed, np.float32), device=dev))
