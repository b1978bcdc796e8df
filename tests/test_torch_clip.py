"""nerfnav_tpu_torch's CLIP tower and poseless training vs the JAX package's,
on the CPU.

Both packages load the same tiny tower (hidden 32, 2 layers, 4 heads, patch
8, image 32, projection 16) from one .npz of seeded random arrays under the
Hugging Face key names: the loader is the converter. Tolerances: 1e-5 for
embeddings, preprocessed images, losses and the loss's gradient w.r.t. the
image; the poseless Trainer steps from the same numpy poses and the JAX
keys' draws, each from the JAX step's state (the JAX steps march with the
port's march through a host callback): losses 1e-5, gradients 1e-5 of each
tensor's largest entry, params and EMA 1e-5 where GRAD_HELD says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.models import network as jnet
from nerfnav_tpu.models import occupancy as jocc
from nerfnav_tpu.models import renderer as jrend
from nerfnav_tpu.ops import marching as jm
from nerfnav_tpu.training import clip_jax
from nerfnav_tpu.training import Trainer as JTrainer, TrainerOptions as JOpts
from nerfnav_tpu_torch.data.provider import rand_poses
from nerfnav_tpu_torch.training import clip_tower
from nerfnav_tpu_torch.training import trainer as ttrain
from test_torch_parallel import (
    HW, MARCH, N_RAYS, NET, OCC, _draws_from_key, _march_through_port, _port_trainer,
)
from test_torch_march import shell_occupancy
from test_torch_train import _dataset

torch.set_num_threads(1)

# params after an Adam step are held (1e-5) where its gradient is 0 or above
# this share of its tensor's largest entry: Adam divides a step by the
# entry's own scale, so a rounding of 1e-6 of the largest entry moves the
# step of an entry at 1e-3 of it by up to lr x 1e-3 = 1e-5
GRAD_HELD = 1e-3


def write_clip_npz(path, seed=0, hidden=32, layers=2, heads=4, patch=8, image=32, proj=16,
                   inter=64):
    """A CLIPVisionModelWithProjection-shaped .npz of seeded normal arrays
    (scale 0.2; layer norms near 1), with one text-tower key the loaders
    must ignore."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa: E731
    one = lambda n: (1.0 + rng.normal(size=n) * 0.1).astype(np.float32)  # noqa: E731
    tokens = (image // patch) ** 2 + 1
    sd = {"vision_model.embeddings.patch_embedding.weight": f(hidden, 3, patch, patch),
          "vision_model.embeddings.class_embedding": f(hidden),
          "vision_model.embeddings.position_embedding.weight": f(tokens, hidden),
          "vision_model.pre_layrnorm.weight": one(hidden),
          "vision_model.pre_layrnorm.bias": f(hidden),
          "vision_model.post_layernorm.weight": one(hidden),
          "vision_model.post_layernorm.bias": f(hidden),
          "visual_projection.weight": f(proj, hidden),
          "text_model.embeddings.token_embedding.weight": f(8, hidden)}
    for i in range(layers):
        p = f"vision_model.encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = one(hidden), f(hidden)
        for name, (o, n) in {"self_attn.q_proj": (hidden, hidden),
                             "self_attn.k_proj": (hidden, hidden),
                             "self_attn.v_proj": (hidden, hidden),
                             "self_attn.out_proj": (hidden, hidden),
                             "mlp.fc1": (inter, hidden), "mlp.fc2": (hidden, inter)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = f(o, n), f(o)
    np.savez(path, **sd)
    return path


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    return write_clip_npz(str(tmp_path_factory.mktemp("clip") / "clip_tiny.npz"))


def test_tower_matches_jax(tiny_npz, tmp_path):
    """The embedding of two normalized images within 1e-5, batched too; the
    config read from the weights; a torch state_dict loads the same."""
    wj, cfg_j = clip_jax.load_clip_vision_weights(tiny_npz, num_heads=4)
    wt, cfg_t = clip_tower.load_clip_vision_weights(tiny_npz, num_heads=4)
    assert cfg_t == cfg_j == {"hidden": 32, "patch": 8, "image_size": 32, "heads": 4}
    tower = clip_tower.CLIPVisionTower(wt, cfg_t)
    px = np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32)
    embed_j = jax.jit(lambda x: clip_jax.clip_image_embed(wj, cfg_j, x))
    ej = np.stack([np.asarray(embed_j(jnp.asarray(x))) for x in px])
    np.testing.assert_allclose(tower(torch.as_tensor(px[0])).numpy(), ej[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tower(torch.as_tensor(px)).numpy(), ej, rtol=0, atol=1e-5)
    pth = str(tmp_path / "clip_tiny.pth")
    torch.save({k: torch.as_tensor(v) for k, v in np.load(tiny_npz).items()}, pth)
    t2 = clip_tower.CLIPVisionTower.load(pth, num_heads=4, device="cpu")
    assert torch.equal(t2(torch.as_tensor(px)), tower(torch.as_tensor(px)))
    assert clip_tower.load_clip_vision_weights(tiny_npz)[1]["heads"] == 1  # hidden / 64


@pytest.mark.parametrize("src,size", [(64, 224), (64, 32), (24, 32)],
                         ids=["up_64_224", "down_64_32", "up_24_32"])
def test_preprocess_matches_jax(src, size):
    """jax.image.resize's bilinear (antialiased when it shrinks) and the
    normalization, within 1e-5, and its gradient w.r.t. the image."""
    img = np.random.default_rng(src + size).random((src, src, 3), dtype=np.float32)
    w = np.random.default_rng(2).normal(size=(3, size, size)).astype(np.float32)
    pj, gj = jax.value_and_grad(
        lambda x: jnp.sum(clip_jax.preprocess(x, size) * w))(jnp.asarray(img))
    x = torch.as_tensor(img).requires_grad_()
    pt = clip_tower.preprocess(x, size)
    (pt * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(pt.detach().numpy(),
                               np.asarray(clip_jax.preprocess(jnp.asarray(img), size)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float((pt.detach() * torch.as_tensor(w)).sum()), float(pj),
                               rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())


def test_loss_and_image_gradient_match(tiny_npz, tmp_path):
    """1 - cos(embedding, text) and its gradient w.r.t. a 16x16 image within
    1e-5; the text embedding from an array or an .npy; an image scored
    against its own embedding gives 0."""
    text = np.random.default_rng(3).normal(size=16).astype(np.float32)
    np.save(tmp_path / "text.npy", text)
    img = np.random.default_rng(4).random((16, 16, 3), dtype=np.float32)
    fj = clip_jax.make_clip_loss_fn(tiny_npz, text, num_heads=4)
    lj, gj = jax.jit(jax.value_and_grad(fj))(jnp.asarray(img))
    ft = clip_tower.make_clip_loss_fn(tiny_npz, str(tmp_path / "text.npy"), num_heads=4,
                                      device="cpu")
    x = torch.as_tensor(img).requires_grad_()
    lt = ft(x)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())
    own = ft.tower(clip_tower.preprocess(torch.as_tensor(img), 32)).detach().numpy()
    f_own = clip_tower.make_clip_loss_fn(tiny_npz, own, num_heads=4, device="cpu")
    assert abs(float(f_own(torch.as_tensor(img)))) < 1e-6


@pytest.fixture(scope="module")
def jax_clip_trainer(tiny_npz, tmp_path_factory):
    """A JAX Trainer with the JAX tower, reused by both schedules (its
    compiled steps march through the port: tests patch the march first)."""
    ws = tmp_path_factory.mktemp("jclip")
    text = np.random.default_rng(5).normal(size=16).astype(np.float32)
    tj = JTrainer(jnet.NetworkConfig(**NET), jrend.RenderConfig(),
                  JOpts(name="j", workspace=str(ws), num_rays=N_RAYS, iters=200,
                        use_checkpoint="scratch", error_map=True, rand_pose=0),
                  params=jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**NET)),
                  occupancy_cfg=jocc.OccupancyConfig(**OCC), march_cfg=jm.MarchConfig(**MARCH),
                  clip_loss_fn=clip_jax.make_clip_loss_fn(tiny_npz, text, num_heads=4))
    return tj, text


@pytest.mark.parametrize("rand_pose", [0, 2])
def test_poseless_steps_match(rand_pose, jax_clip_trainer, tiny_npz, tmp_path, monkeypatch):
    """Three steps of the train loop's schedule (rand_pose 0: three
    similarity batches; 2: two supervised then one similarity batch) from
    the same params, occupancy, numpy poses and draws: losses 1e-5, params
    and EMA 1e-5 where each step's gradient is held; the clip frame is 16x16
    (sqrt(24 * 24 / 256) = 1.5)."""
    tj, text = jax_clip_trainer
    occ, _ = shell_occupancy(32, 2)
    tj.state = tj._init_state(2)
    tj.state = tj.state._replace(occupancy={**tj.state.occupancy,
                                            **{k: jnp.asarray(v) for k, v in occ.items()}})
    tj.global_step = 0
    inp = {"workspace": str(tmp_path / "t"), "mean_count_host": 0.0,
           "params": jax.tree_util.tree_map(np.asarray, tj.state.params),
           "occupancy": jax.tree_util.tree_map(np.asarray, tj.state.occupancy)}
    tt = _port_trainer(inp, None)
    tt.opt.rand_pose = rand_pose
    tt.clip_loss_fn = clip_tower.make_clip_loss_fn(tiny_npz, text, num_heads=4, device="cpu")
    assert tt.clip_frame(HW, HW) == (1.5, 16, 16)
    _march_through_port(monkeypatch)
    ds = _dataset()
    arrays_j = {k: jnp.asarray(v) for k, v in ds.as_arrays().items()}
    arrays_t = tt._device_arrays(ds)
    rng = np.random.default_rng(11)
    kinds, held, left = [], 0, 0
    for s in range(3):
        mu_prev = [np.asarray(m) for m in jax.tree_util.tree_leaves(tj.state.opt_state[0].mu)]
        key = jax.random.PRNGKey(20 + s)
        if rand_pose == 0 or s % (rand_pose + 1) == rand_pose:
            pose = rand_poses(rng, 1, radius=1.0)[0]
            clip_fn, scale = tj._clip_step_fn(HW, HW)
            tj.state, loss_j = clip_fn(tj.state, jnp.asarray(pose),
                                       arrays_j["intrinsics"] / scale, key)
            k_start, k_phase = jax.random.split(key)
            t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
            draws = ttrain.StepDraws(idx=-1, rays=None, bg=None, march=ttrain.MarchKey(
                u=t(jax.random.uniform(k_start, (256,))),
                phase=t(jax.random.randint(k_phase, (256, 1), 0, 2**30)).long()))
            loss_t, grads = tt.clip_loss_and_grads(tt.state, pose, ds.intrinsics, HW, HW, draws)
            tt.apply_grads(tt.state, grads)
            kinds.append("clip")
        else:
            idx = int(rng.integers(len(ds)))
            draws = _draws_from_key(key, np.asarray(tj.state.error_maps[idx]), idx)
            tj.state, loss_j = tj._step_fn(HW, HW, 4)(tj.state, arrays_j, jnp.asarray(idx), key)
            out = tt.loss_and_grads(tt.state, arrays_t, draws)
            tt.apply(tt.state, out, idx, HW, HW)
            loss_t, grads = out.loss, out.grads
            kinds.append("rays")
        tj.global_step += 1
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        # the JAX step's gradients, from Adam's first moment
        mu = [np.asarray(m) for m in jax.tree_util.tree_leaves(tj.state.opt_state[0].mu)]
        for a, m, m0 in zip(grads, mu, mu_prev):
            b = (m - 0.9 * m0) / 0.1
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
        for i, (a, b, e, eb) in enumerate(zip(
                ttrain._leaves(tt.params), jax.tree_util.tree_leaves(tj.state.params),
                ttrain._leaves(tt.state.ema_params),
                jax.tree_util.tree_leaves(tj.state.ema_params))):
            g = grads[i].numpy()
            keep = (np.abs(g) > GRAD_HELD * np.abs(g).max()) | (g == 0)
            np.testing.assert_allclose(a.detach().numpy()[keep], np.asarray(b)[keep], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(e.numpy()[keep], np.asarray(eb)[keep], rtol=0, atol=1e-5)
            held, left = held + int(keep.sum()), left + int((~keep).sum())
        _sync_to_jax(tt, tj.state)
    assert kinds == (["clip"] * 3 if rand_pose == 0 else ["rays", "rays", "clip"])
    assert tt.global_step == int(tj.state.global_step) == 3
    print(f"rand_pose {rand_pose}: params held at {held} entries, {left} left out")
    assert held > left, (held, left)


def _sync_to_jax(tt, sj):
    """The port's params, EMA, Adam moments and error maps set to the JAX
    state's, so each step starts from the same state (Adam divides a step by
    each entry's own scale, and a gradient's rounding would grow over steps)."""
    to_t = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: torch.as_tensor(np.array(x)), tree)
    with torch.no_grad():
        for tree_t, tree_j in ((tt.params, sj.params), (tt.state.ema_params, sj.ema_params)):
            for a, b in zip(ttrain._leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
                a.copy_(torch.as_tensor(np.array(b)))
        tt.state.error_maps.copy_(torch.as_tensor(np.array(sj.error_maps)))
    adam = sj.opt_state[0]
    ttrain.ckpt_lib.adam_from_optax(tt.state.optimizer, tt.params,
                                    (adam._replace(mu=to_t(adam.mu), nu=to_t(adam.nu)),))


def test_train_loop_takes_poseless_batches(tiny_npz, tmp_path):
    """Trainer.train with rand_pose 2 over 6 steps takes similarity batches
    at steps 2 and 5 (the clip frame's 256 rays render through the march)."""
    text = np.random.default_rng(5).normal(size=16).astype(np.float32)
    inp = {"workspace": str(tmp_path / "t"), "mean_count_host": 0.0,
           "params": jax.tree_util.tree_map(
               np.asarray, jnet.init_network(jax.random.PRNGKey(0), jnet.NetworkConfig(**NET))),
           "occupancy": {**jax.tree_util.tree_map(
               np.asarray, jocc.init_occupancy_state(jocc.OccupancyConfig(**OCC))),
                         **shell_occupancy(32, 2)[0]}}
    tt = _port_trainer(inp, None)
    tt.opt.rand_pose = 2
    tt.clip_loss_fn = clip_tower.make_clip_loss_fn(tiny_npz, text, num_heads=4, device="cpu")
    calls = []
    step = tt.clip_step
    tt.clip_step = lambda *a, **k: calls.append(tt.global_step) or step(*a, **k)
    tt.train(_dataset(), max_epochs=1, steps_per_epoch=6)
    assert calls == [2, 5] and tt.global_step == 6
    assert np.isfinite(tt.stats["loss"][0])


def test_rand_pose_needs_a_loss_fn(tmp_path):
    from nerfnav_tpu_torch.models import network as tnet
    from nerfnav_tpu_torch.models import renderer as trend

    with pytest.raises(RuntimeError, match="clip_loss_fn"):
        ttrain.Trainer(tnet.NetworkConfig(**NET), trend.RenderConfig(),
                       ttrain.TrainerOptions(workspace=str(tmp_path), rand_pose=0),
                       device="cpu")
