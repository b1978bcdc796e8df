"""nerfnav_tpu_torch's interactive viewer against the JAX package's, on the
CPU: the orbit camera and the Halton offsets bit for bit, the viewer's
adaptive state machine on the same (monkeypatched) train and render times,
`Trainer.test_gui` within 1e-5 of the JAX trainer's (xla fp32 field, the
JAX side shading the port's march, see test_torch_render.py::_march_by_port),
`Trainer.train_gui`'s image draws and losses, every widget (the dt_gamma
slider reaches the next train chunk's march) and every endpoint of the web
server.
"""

import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from nerfnav_tpu.gui import viewer as jview
from nerfnav_tpu.training import Trainer as JTrainer
from nerfnav_tpu_torch.gui import viewer as tview
from nerfnav_tpu_torch.models.occupancy import init_occupancy_state
from nerfnav_tpu_torch.training import trainer as ttrainer
from nerfnav_tpu_torch.training.trainer import Trainer as TTrainer
from test_torch_render import POSE, _march_by_port, _net_cfg, _trainers

torch.set_num_threads(1)

OPTS = dict(eval_beam=1, eval_table_dtype="float32", num_rays=64)


class _Frames:
    """A dataset as train_gui reads it: poses, images, intrinsics, H, W."""

    def __init__(self, n=3, hw=16, seed=0):
        rng = np.random.default_rng(seed)
        poses = np.stack([POSE] * n).copy()
        poses[:, 0, 3] += np.linspace(-0.1, 0.1, n)
        self.poses = poses.astype(np.float32)
        self.images = rng.random((n, hw, hw, 3)).astype(np.float32)
        self.intrinsics = np.asarray([hw * 1.4, hw * 1.4, hw / 2, hw / 2], np.float32)
        self.H = self.W = hw

    def __len__(self):
        return len(self.poses)

    def as_arrays(self):
        return {"poses": self.poses, "images": self.images, "intrinsics": self.intrinsics}


def _pair(tmp_path, **opt):
    """A JAX Trainer and its port on the same params and shell occupancy
    (the port's with the rest of a fresh occupancy state, which the sweeps
    of training read)."""
    tj, tt = _trainers(tmp_path, _net_cfg(), 1.0, {**OPTS, **opt})[:2]
    tt.set_occupancy({**init_occupancy_state(tt.occupancy_cfg, device="cpu"), **tt.occupancy})
    return tj, tt


def _port(tmp_path, **opt):
    return _pair(tmp_path, **opt)[1]


# ------------------------------------------------------------------ camera
def test_orbit_camera_matches():
    """Pose, intrinsics and the camera's state after every move of a
    sequence of orbits, zooms and pans: bit-equal."""
    moves = [("orbit", (50, -20)), ("scale", (3,)), ("pan", (200, -40)), ("orbit", (-400, 900)),
             ("pan", (10, 5, 30)), ("scale", (-2.5,)), ("orbit", (0, -700)), ("pan", (0, 0, -9))]
    cj, ct = jview.OrbitCamera(96, 64, r=2.5, fovy=55.0), tview.OrbitCamera(96, 64, r=2.5, fovy=55.0)
    for name, args in [(None, ())] + moves:
        if name:
            getattr(cj, name)(*args)
            getattr(ct, name)(*args)
        np.testing.assert_array_equal(ct.pose, cj.pose)
        np.testing.assert_array_equal(ct.intrinsics, cj.intrinsics)
        np.testing.assert_array_equal(ct.center, cj.center)
        assert (ct.radius, ct.azimuth, ct.elevation) == (cj.radius, cj.azimuth, cj.elevation)
    assert ct.elevation == -1.5  # clipped
    R = ct.pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_halton_offsets_match():
    for i in range(1, 65):
        assert tview._halton_offset(i) == jview._halton_offset(i)
    offs = np.array([tview._halton_offset(i) for i in range(1, 17)])
    assert np.all(offs >= -0.5) and np.all(offs < 0.5)
    assert len({tuple(o) for o in offs}) == 16


# ----------------------------------------------------------- state machine
def _scripted(monkeypatch, cls, calls, render_times, train_times):
    """cls.test_gui / train_gui replaced by stubs that return the scripted
    times (and a frame whose value counts the calls), recording each call."""
    rt, tt = iter(render_times), iter(train_times)

    def test_gui(self, pose, intrinsics, W, H, bg_color=1.0, spp=1, downscale=1.0,
                 crop_aabb=None, pixel_offset=None, frozen=False):
        calls.append(("render", downscale, pixel_offset, crop_aabb, bg_color,
                      np.asarray(pose).tolist(), np.asarray(intrinsics).tolist()))
        img = np.full((H, W, 3), len(calls) / 64.0, np.float32)
        return {"image": img, "time": next(rt)}

    def train_gui(self, train_ds, step=16):
        calls.append(("train", step))
        t = next(tt)
        return {"loss": 0.5, "time": t, "steps_per_sec": step / t}

    monkeypatch.setattr(cls, "test_gui", test_gui)
    monkeypatch.setattr(cls, "train_gui", train_gui)


def test_viewer_state_machine_matches(tmp_path, monkeypatch):
    """The same script of train chunks, passes, camera moves and widgets on
    both viewers, with the same train and render times: the sequences of
    downscale, the frame's scale, spp and train_steps, every call the viewer
    made and every frame it returned are equal."""
    tj, tt = _pair(tmp_path)
    render_times = [0.05, 0.3, 0.12, 0.7, 0.02, 0.4, 0.2, 0.25, 0.01, 1.5, 0.08, 0.9] * 4
    train_times = [1.6, 0.05, 0.9, 2.0, 0.3, 0.001]
    out = {}
    for name, cls, view, tr in (("jax", JTrainer, jview, tj), ("torch", TTrainer, tview, tt)):
        calls, seq, frames = [], [], []
        _scripted(monkeypatch, cls, calls, render_times, train_times)
        gui = view.NeRFGUI(tr, _Frames(), W=40, H=24, radius=2.0, fovy=60.0, max_spp=4)
        for step in ["train", "render", "render", "render", "render", "render", "render",
                     "render", "orbit", "render", "render", "train", "render", "crop", "render",
                     "render", "nodyn", "render", "render", "render", "train", "render",
                     "bg", "render", "train", "render", "render"]:
            if step == "train":
                gui.train_step()
            elif step == "render":
                frames.append(gui.render_frame())
            elif step == "orbit":
                gui.cam.orbit(30, 10)
                gui.touch()
            elif step == "crop":
                gui.set_option("aabb_xmax", 0.25)
            elif step == "nodyn":
                gui.set_option("dynamic_resolution", False)
            elif step == "bg":
                gui.set_option("bg_color", 0.0)
            seq.append((gui.downscale, gui._acc_scale, gui.spp, gui.train_steps))
        out[name] = (calls, seq, frames)
        monkeypatch.undo()
    (cj, sj, fj), (ct, st, ft) = out["jax"], out["torch"]
    assert st == sj and ct == cj
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    scales = {s[1] for s in st}
    assert {0.25, 0.5, 1.0} <= scales and max(s[2] for s in st) == 4
    assert len({s[3] for s in st}) > 2 and len({s[0] for s in st}) > 2


# ------------------------------------------------------------ trainer hooks
def test_test_gui_matches_jax(tmp_path, monkeypatch):
    """test_gui at 16x16, downscale 0.5 (an 8x8 render resized by cv2),
    inside a crop box and at a Halton offset, and at full resolution: the
    image within 1e-5 of the JAX trainer's."""
    tj, tt = _pair(tmp_path)
    _march_by_port(monkeypatch, tt.occupancy)
    intr = np.asarray([16 * 1.4, 16 * 1.4, 8.0, 8.0], np.float32)
    crop = [-0.6, -0.5, -0.7, 0.4, 0.6, 0.3]
    for kw in (dict(downscale=0.5, crop_aabb=crop, pixel_offset=tview._halton_offset(3)),
               dict(downscale=1.0, bg_color=0.0)):
        oj = tj.test_gui(POSE, intr, 16, 16, **kw)
        ot = tt.test_gui(POSE, intr, 16, 16, **kw)
        assert ot["image"].shape == (16, 16, 3) and ot["time"] > 0
        assert (np.asarray(oj["image"]) < 0.5).mean() > 0.05
        np.testing.assert_allclose(ot["image"], oj["image"], rtol=0, atol=1e-5)


def test_train_gui_draws_and_losses(tmp_path, monkeypatch):
    """train_gui draws the JAX trainer's image indices (the JAX step
    stubbed to record them), and its mean loss equals the port's own
    train_step loop from the same generator state, occupancy updates
    included; the mean loss is finite and the step count advances."""
    ds = _Frames()
    tj, ta = _pair(tmp_path)
    tb = _port(tmp_path)
    jidx = []

    def step_fn(H, W, C):
        def run(state, arrays, idx, key):
            jidx.append(int(idx))
            return state, 0.0
        return run

    monkeypatch.setattr(tj, "_step_fn", step_fn)
    monkeypatch.setattr(tj, "_maybe_update_occupancy", lambda: None)
    tidx = []
    draw = ta.draw_step
    monkeypatch.setattr(ta, "draw_step", lambda st, idx, H, W: tidx.append(idx) or draw(st, idx, H, W))
    for step in (5, 7):
        jout = tj.train_gui(ds, step=step)
        out = ta.train_gui(ds, step=step)
        assert jout["time"] > 0 and out["time"] > 0
        rng = np.random.default_rng(tb.opt.seed + tb.global_step)
        arrays = tb._device_arrays(ds)
        total = torch.zeros(())
        for _ in range(step):
            tb._maybe_update_occupancy()
            idx = int(rng.integers(len(ds)))
            total += tb.train_step(tb.state, arrays, tb.draw_step(tb.state, idx, ds.H, ds.W))
        assert out["loss"] == float(total) / step and np.isfinite(out["loss"])
    assert tidx == jidx and len(set(tidx)) > 1
    assert ta.global_step == tb.global_step == tj.global_step == 12
    assert int(ta.occupancy["iter_density"]) == int(tb.occupancy["iter_density"]) == 1
    for a, b in zip(ttrainer._leaves(ta.params), ttrainer._leaves(tb.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ widgets
def test_set_options_match(tmp_path):
    """Every widget on both viewers leaves the same state; an unknown name
    raises KeyError."""
    tj, tt = _pair(tmp_path)
    guis = [view.NeRFGUI(tr, None, W=32, H=32) for view, tr in ((jview, tj), (tview, tt))]
    widgets = [("bg_color", 0.5), ("fovy", 90), ("max_spp", 8), ("aabb_xmin", -0.5),
               ("aabb_ymin", -0.25), ("aabb_zmin", -0.75), ("aabb_xmax", 0.25),
               ("aabb_ymax", 0.5), ("aabb_zmax", 0.8), ("dynamic_resolution", False)]
    for name, value in widgets:
        for g in guis:
            g._dirty = False
            g.set_option(name, value)
        gj, gt = guis
        assert gt._dirty and gj._dirty
        assert (gt.bg_color, gt.cam.fovy, gt.max_spp, gt.aabb, gt._crop, gt.downscale,
                gt.dynamic_resolution) == (gj.bg_color, gj.cam.fovy, gj.max_spp, gj.aabb,
                                           gj._crop, gj.downscale, gj.dynamic_resolution)
    assert guis[1]._crop == [-0.5, -0.25, -0.75, 0.25, 0.5, 0.8] and guis[1].downscale == 1.0
    for g in guis:
        with pytest.raises(KeyError):
            g.set_option("nope", 1)


def test_dt_gamma_reaches_the_next_train_chunk(tmp_path, monkeypatch):
    """The dt_gamma slider replaces the march config and drops every cache
    derived from it: the next train chunk marches at the new dt_gamma (the
    training march config was cached at 0 before), the render plans at it,
    and the JAX viewer's march config holds the same value."""
    tj, tt = _pair(tmp_path)
    ds = _Frames()
    gui = tview.NeRFGUI(tt, ds, W=16, H=16)
    gui.train_steps = 2
    gui.train_step()
    assert tt._train_march_cfg().dt_gamma == 0.0 and tt._train_mcfgs
    seen = []
    real = ttrainer.render_rays_grid
    monkeypatch.setattr(ttrainer, "render_rays_grid",
                        lambda f, occ, mcfg, *a, **k: seen.append(mcfg.dt_gamma) or real(
                            f, occ, mcfg, *a, **k))
    gui.set_option("dt_gamma", 1 / 128)
    jgui = jview.NeRFGUI(tj, None, W=16, H=16)
    jgui.set_option("dt_gamma", 1 / 128)
    assert tt.march_cfg.dt_gamma == tj.march_cfg.dt_gamma == 1 / 128
    gui.train_steps = 2
    out = gui.train_step()
    assert seen == [1 / 128, 1 / 128] and np.isfinite(out["loss"])
    assert tt._eval_march_cfg().dt_gamma == 1 / 128
    frame = gui.render_frame()
    assert frame.shape == (16, 16, 3) and np.isfinite(frame).all()


def test_buttons(tmp_path, monkeypatch):
    """Reset (fresh weights, step 0, the view dirty; training goes on after
    it), the checkpoint button and the mesh button (Trainer.save_mesh at
    its defaults, stubbed: a 256^3 lattice is the card's work, and
    tests/test_torch_mesh.py holds save_mesh)."""
    tt = _port(tmp_path)
    meshes = []
    monkeypatch.setattr(TTrainer, "save_mesh", lambda self, *a, **k: meshes.append((a, k)) or "m.ply")
    ds = _Frames()
    gui = tview.NeRFGUI(tt, ds, W=16, H=16)
    gui.train_steps = 3
    gui.train_step()
    before = tt.params["sigma_net"][0].detach().clone()
    assert tt.global_step == 3
    gui._dirty = False
    assert "reset" in gui.reset_model() and gui._dirty
    assert tt.global_step == 0 and not torch.equal(before, tt.params["sigma_net"][0])
    assert float(tt.occupancy["density_grid"].max()) == 0.0
    assert np.isfinite(gui.train_step()["loss"])
    assert "saved" in gui.save_checkpoint()
    assert (tmp_path / "t" / "checkpoints").exists()
    assert gui.export_mesh() == "mesh saved: m.ply" and meshes == [((), {})]


# ------------------------------------------------------------------- server
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_endpoints(tmp_path, monkeypatch):
    """Every endpoint of the web server, in order, on a free port: the page,
    a 404, orbit / pan / zoom (each moves the camera), frames (a JPEG
    whose decoded shape is the viewer's and whose pixels are the frame's
    up to JPEG's loss; with training on, each frame runs a train chunk),
    /set, the training toggle, reset, the checkpoint and the mesh (
    Trainer.save_mesh stubbed: tests/test_torch_mesh.py holds it)."""
    import cv2

    tt = _port(tmp_path)
    meshes = []
    monkeypatch.setattr(TTrainer, "save_mesh", lambda self, *a, **k: meshes.append(1) or "m.ply")
    gui = tview.NeRFGUI(tt, _Frames(), W=24, H=16)
    gui.train_steps = 2
    gui.TRAIN_BUDGET_S = 1e-9  # every later chunk is 1 step
    port = _free_port()
    requests = [("GET", "/", None), ("GET", "/nothing", None), ("POST", "/orbit", {"dx": 40}),
                ("GET", "/frame", None), ("POST", "/pan", {"dx": 30, "dy": -10}),
                ("POST", "/zoom", {"delta": 2}), ("POST", "/set", {"bg_color": 0, "fovy": 70}),
                ("GET", "/frame", None), ("POST", "/train", {}), ("GET", "/frame", None),
                ("POST", "/reset", {}), ("POST", "/save_ckpt", {}), ("POST", "/save_mesh", {})]
    server = threading.Thread(target=gui.serve, kwargs={"port": port, "steps": len(requests)},
                              daemon=True)
    server.start()
    base = f"http://127.0.0.1:{port}"
    replies, cams = [], []
    for method, path, body in requests:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, method=method)
        for _ in range(50):  # the server thread may not listen yet
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    replies.append((r.status, r.read(), r.headers["Content-Type"]))
                break
            except urllib.error.HTTPError as e:
                replies.append((e.code, b"", None))
                break
            except urllib.error.URLError:
                threading.Event().wait(0.1)
        cams.append((gui.cam.azimuth, gui.cam.radius, gui.cam.center.copy(), tt.global_step))
        if path == "/frame":
            jpg = replies[-1][1]
            assert jpg[:2] == b"\xff\xd8" and replies[-1][2] == "image/jpeg"
            dec = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
            assert dec.shape == (16, 24, 3)
            frame8 = (np.clip(gui._acc, 0, 1) * 255).astype(np.uint8)
            diff = np.abs(cv2.cvtColor(dec, cv2.COLOR_BGR2RGB).astype(int) - frame8)
            assert diff.mean() < 8
    server.join(timeout=60)
    assert not server.is_alive()
    status = [r[0] for r in replies]
    assert status == [200, 404] + [200] * 11
    assert b"<script>" in replies[0][1] and b"nerfnav_tpu_torch viewer" in replies[0][1]
    assert cams[2][0] != 0.0 and cams[5][1] < 2.0 and np.abs(cams[4][2]).sum() > 0
    assert cams[3][3] == 2 and cams[7][3] == 3 and cams[9][3] == 3  # /train stopped training
    assert gui.bg_color == 0.0 and gui.cam.fovy == 70.0 and not gui.training
    assert json.loads(replies[10][1]) == {"status": "model reset"} and tt.global_step == 0
    assert json.loads(replies[11][1]) == {"status": "checkpoint saved"}
    assert json.loads(replies[12][1]) == {"status": "mesh saved: m.ply"} and meshes == [1]


def test_encode_jpeg_channel_order():
    """A red frame decodes red: RGB goes to cv2 as BGR."""
    import cv2

    img = np.zeros((16, 16, 3), np.float32)
    img[..., 0] = 1.0
    dec = cv2.imdecode(np.frombuffer(tview.encode_jpeg(img), np.uint8), cv2.IMREAD_COLOR)
    assert dec[..., 2].min() > 240 and dec[..., :2].max() < 15


def test_render_frame_on_a_trainer_without_grid(tmp_path):
    """The dense path (no occupancy grid) through the viewer: the fast pass
    and a refinement, finite."""
    tt = _trainers(tmp_path, _net_cfg(), 1.0, OPTS, grid=False)[1]
    assert tt.march_cfg is None
    gui = tview.NeRFGUI(tt, None, W=16, H=16)
    gui.set_option("dt_gamma", 0.01)  # no march config: nothing to change
    a = gui.render_frame()
    b = gui.render_frame()
    assert a.shape == b.shape == (16, 16, 3) and np.isfinite(b).all()
    assert gui._acc_scale == 0.5
