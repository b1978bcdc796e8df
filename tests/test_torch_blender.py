"""nerfnav_tpu_torch's Blender observation backend and Blender scripts
against the JAX package's, on the CPU.

A stand-in for Blender, written by the test, answers the agent's file RPC:
it reads pose.json and writes an RGBA PNG (cv2) whose colours and alpha
depend on the pixel and the pose. Both packages' agents must return the same
uint8 image through it (the port reads BGRA with cv2, JAX reads RGBA with
imageio). `simulate.main --sim_backend blender` runs a mission with it on
PATH. Each package's sim/ scripts run with a fake bpy and mathutils in
sys.modules and must leave the same scene settings and curves.
"""

import json
import os
import stat
import sys
import types

import jax
import numpy as np
import pytest
import torch

from nerfnav_tpu.cli import simulate as jsim
from nerfnav_tpu.nav import agent as jagent
from nerfnav_tpu.nav.dynamics import DynamicsConfig as JDyn
from nerfnav_tpu.sim import blender_render as jrender
from nerfnav_tpu.sim import blender_trajectory_viz as jtraj
from nerfnav_tpu_torch.cli import simulate as tsim
from nerfnav_tpu_torch.nav import agent as tagent
from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig as TDyn
from nerfnav_tpu_torch.sim import blender_render as trender
from nerfnav_tpu_torch.sim import blender_trajectory_viz as ttraj

torch.set_num_threads(1)

STAND_IN = """#!{python}
# Blender stand-in: blender -b <blend> -P <script> -- pose.json out.png
import json, sys
import cv2
import numpy as np

argv = sys.argv[sys.argv.index("--") + 1:]
with open(argv[0]) as f:
    req = json.load(f)
t = np.round(np.asarray(req["pose"])[:3, 3] * 100.0)
h, w = req["res_y"], req["res_x"]
y, x = np.mgrid[0:h, 0:w]
rgba = np.zeros((h, w, 4), np.uint8)
rgba[..., 0] = (x * 37 + 3 * t[0]) % 256   # red follows x and the pose
rgba[..., 1] = (y * 11 + 5 * t[1]) % 256   # green follows y
rgba[..., 2] = 40                          # little blue
rgba[..., 3] = (x * 5 + y * 29 + 2 * t[2]) % 256
cv2.imwrite(argv[1], cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGRA))
with open(argv[1] + ".calls", "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
"""

H, W = 20, 28
X0 = np.zeros(12, np.float32)
X0[0:3] = [0.1, -1.6, 0.2]
X0[6:9] = [0.0, 0.0, np.pi / 2]


def _stand_in(d, name="blender"):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(STAND_IN.format(python=sys.executable))
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


def _agents(tmp_path):
    cmd = _stand_in(str(tmp_path / "bin"))
    kw = dict(H=H, W=W, focal=24.0, backend="blender", blend_file="scene.blend", blender_cmd=cmd)
    aj = jagent.Agent(X0, jagent.AgentConfig(dyn=JDyn(dt=0.2), cache_dir=str(tmp_path / "j"),
                                             **kw))
    at = tagent.Agent(X0, tagent.AgentConfig(dyn=TDyn(dt=0.2), cache_dir=str(tmp_path / "t"),
                                             **kw), device="cpu")
    return aj, at


def test_blender_observation_matches_jax(tmp_path):
    """get_img at one pose through the stand-in: the same request file, the
    same argv (each package's own render script by default), and the same
    uint8 image, the RGBA PNG composited on white; the image is not its
    channel swap."""
    import cv2

    aj, at = _agents(tmp_path)
    pose = tagent.body_state_to_camera_pose(torch.as_tensor(X0)).numpy()
    ij, it = aj.get_img(pose), at.get_img(pose)
    assert it.dtype == np.uint8 and it.shape == (H, W, 3)
    np.testing.assert_array_equal(it, ij)
    with open(tmp_path / "t" / "pose.json") as f, open(tmp_path / "j" / "pose.json") as g:
        assert json.load(f) == json.load(g)
    calls = [json.loads(open(tmp_path / d / "obs.png.calls").read()) for d in ("j", "t")]
    for c, d, pkg in zip(calls, ("j", "t"), ("nerfnav_tpu", "nerfnav_tpu_torch")):
        assert c[:2] == ["-b", "scene.blend"] and c[2] == "-P" and c[4] == "--"
        assert c[3].endswith(os.path.join(pkg, "sim", "blender_render.py"))
        assert os.path.exists(c[3])
        assert c[5:] == [str(tmp_path / d / "pose.json"), str(tmp_path / d / "obs.png")]
    rgba = cv2.cvtColor(cv2.imread(str(tmp_path / "t" / "obs.png"), cv2.IMREAD_UNCHANGED),
                        cv2.COLOR_BGRA2RGBA).astype(np.float32) / 255.0
    want = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
    np.testing.assert_array_equal(it, (np.clip(want, 0, 1) * 255).astype(np.uint8))
    assert np.abs(it.astype(int) - it[..., ::-1].astype(int)).mean() > 20


def test_blender_agent_step_matches_jax(tmp_path, monkeypatch):
    """Agent.step under the blender backend: the propagated state within
    1e-5 of the JAX agent's (tests/test_torch_nav_estimator.py's agent
    bar), and each observation the stand-in's image at that state's pose,
    equal across the packages. The JAX dynamics and pose run jitted: op by
    op they compile for seconds."""
    monkeypatch.setattr(jagent, "drone_dynamics",
                        jax.jit(jagent.drone_dynamics, static_argnums=2))
    monkeypatch.setattr(jagent, "body_state_to_camera_pose",
                        jax.jit(jagent.body_state_to_camera_pose))
    aj, at = _agents(tmp_path)
    action = np.asarray([10.5, 0.3, -0.2, 0.1], np.float32)
    for _ in range(2):
        ij, sj, pj = aj.step(action)
        it, st, pt = at.step(action)
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(it, at.get_img(pt))
    assert np.abs(st - X0).max() > 1e-3


def test_blender_failure_raises(tmp_path):
    """A Blender run that fails raises (check=True); an unknown backend is
    refused."""
    import subprocess

    cfg = tagent.AgentConfig(H=4, W=4, backend="blender", blend_file="b.blend",
                             blender_cmd="false", cache_dir=str(tmp_path / "c"))
    with pytest.raises(subprocess.CalledProcessError):
        tagent.Agent(X0, cfg, device="cpu").get_img(np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="backend"):
        tagent.Agent(X0, tagent.AgentConfig(backend="mujoco"), device="cpu")


def test_simulate_main_blender_backend(tmp_path, monkeypatch):
    """`simulate.main --analytic --sim_backend blender --blend_file ...` with
    the stand-in on PATH as `blender`, a flag set the JAX CLI parses the
    same: every step's observation comes from the stand-in (one call a
    step) and the mission's estimates stay finite."""
    bin_dir = str(tmp_path / "bin")
    _stand_in(bin_dir)
    monkeypatch.setenv("PATH", bin_dir + os.pathsep + os.environ["PATH"])
    monkeypatch.chdir(tmp_path)
    argv = ["scene", "--analytic", "--device", "cpu", "--sim_backend", "blender",
            "--blend_file", "scene.blend", "--steps", "3", "--open_loop_steps", "1",
            "--obs_res", "32", "--obs_focal", "32", "--epochs_init", "5", "--epochs_update", "3",
            "--estimator_batch", "64", "--poi_backend", "corners", "--workspace",
            str(tmp_path / "ws")]
    vj = vars(jsim.build_sim_parser().parse_args([a for a in argv if a not in ("--device",
                                                                                  "cpu")]))
    vt = vars(tsim.build_sim_parser().parse_args(argv))
    assert vt.pop("device") == "cpu" and vt == vj
    history = tsim.main(argv)
    assert len(history) == 3 and all(np.isfinite(e).all() for _, e in history)
    with open(tmp_path / "sim_img_cache" / "obs.png.calls") as f:
        calls = [json.loads(line) for line in f]
    assert len(calls) == 3 and all(c[1] == "scene.blend" for c in calls)


# ------------------------------------------------------------ Blender scripts
class _Rec:
    """A fake bpy object: attribute writes are recorded; `new` / `link`
    calls of the containers add to the log."""

    def __init__(self, log, name):
        object.__setattr__(self, "_log", log)
        object.__setattr__(self, "_name", name)

    def __setattr__(self, k, v):
        self._log.append(("set", self._name, k, _plain(v)))
        object.__setattr__(self, k, v)


def _plain(v):
    if isinstance(v, _Rec):
        return v._name
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


class _Points(list):
    """A spline's points: indexable, grown by add(n)."""

    def __init__(self, log, name):
        super().__init__([_Rec(log, f"{name}.p0")])
        self._log, self._name = log, name

    def add(self, n):
        start = len(self)
        self.extend(_Rec(self._log, f"{self._name}.p{start + i}") for i in range(n))


def _fake_blender(log, with_camera):
    """(bpy, mathutils) fakes that record what a script does to the scene."""
    def container(kind):
        def new(name, *a, **k):
            obj = _Rec(log, f"{kind}:{name}")
            log.append(("new", kind, name, [_plain(x) for x in a], k))
            if kind == "curves":
                def spline(t):
                    log.append(("spline", name, t))
                    return types.SimpleNamespace(points=_Points(log, name))
                object.__setattr__(obj, "splines", types.SimpleNamespace(new=spline))
            if kind == "collections":
                object.__setattr__(obj, "objects", types.SimpleNamespace(
                    link=lambda o: log.append(("link", name, _plain(o)))))
            return obj
        return types.SimpleNamespace(new=new)

    scene = _Rec(log, "scene")
    object.__setattr__(scene, "render", _Rec(log, "render"))
    object.__setattr__(scene.render, "image_settings", _Rec(log, "image_settings"))
    object.__setattr__(scene, "camera", _Rec(log, "camera:existing") if with_camera else None)
    object.__setattr__(scene, "collection", types.SimpleNamespace(
        objects=types.SimpleNamespace(link=lambda o: log.append(("link", "scene", _plain(o)))),
        children=types.SimpleNamespace(
            link=lambda c: log.append(("link_child", "scene", _plain(c))))))
    bpy = types.ModuleType("bpy")
    bpy.context = types.SimpleNamespace(scene=scene)
    bpy.data = types.SimpleNamespace(**{k: container(k) for k in (
        "cameras", "objects", "collections", "curves")})
    bpy.ops = types.SimpleNamespace(render=types.SimpleNamespace(
        render=lambda **k: log.append(("render", k))))
    mathutils = types.ModuleType("mathutils")
    mathutils.Matrix = lambda rows: ("Matrix", [list(map(float, r)) for r in rows])
    return bpy, mathutils


def _run_script(monkeypatch, module, argv, with_camera=True):
    log = []
    bpy, mathutils = _fake_blender(log, with_camera)
    monkeypatch.setitem(sys.modules, "bpy", bpy)
    monkeypatch.setitem(sys.modules, "mathutils", mathutils)
    monkeypatch.setattr(sys, "argv", argv)
    module.main()
    return log


@pytest.mark.parametrize("with_camera", [True, False])
def test_blender_render_script_matches_jax(tmp_path, monkeypatch, with_camera):
    """blender_render.py on a request: the camera (made when the scene has
    none), its matrix, resolution, transparency, colour mode, file format,
    path and the render call, equal to the JAX package's copy's."""
    pose = np.eye(4)
    pose[:3, 3] = [0.5, -1.25, 2.0]
    req = tmp_path / "pose.json"
    req.write_text(json.dumps({"pose": pose.tolist(), "res_x": 64, "res_y": 48, "trans": False,
                               "mode": "RGB"}))
    argv = ["blender", "-b", "s.blend", "-P", "x.py", "--", str(req), str(tmp_path / "o.png")]
    got = _run_script(monkeypatch, trender, argv, with_camera)
    want = _run_script(monkeypatch, jrender, argv, with_camera)
    assert got == want
    sets = {(e[1], e[2]): e[3] for e in got if e[0] == "set"}
    assert sets[("render", "resolution_x")] == 64 and sets[("render", "film_transparent")] is False
    assert sets[("image_settings", "file_format")] == "PNG" and ("render", {"write_still": True}) in got
    assert any(e[0] == "new" and e[1] == "cameras" for e in got) != with_camera


def test_blender_trajectory_script_matches_jax(tmp_path, monkeypatch):
    """blender_trajectory_viz.py over a planner's init and replan pose
    files (one too short to draw, one not JSON): the collection, every curve
    and its NURBS points, equal to the JAX package's copy's."""
    rng = np.random.default_rng(0)
    for kind, names in (("init", ["init_0.json", "init_1.json", "notes.txt"]),
                        ("replan", ["replan_0_0.json", "replan_1_0.json"])):
        d = tmp_path / f"{kind}_poses" / "sim"
        d.mkdir(parents=True)
        for i, name in enumerate(names):
            n = 1 if name == "init_1.json" else 4 + i
            poses = np.concatenate([np.broadcast_to(np.eye(3), (n, 3, 3)),
                                    rng.normal(size=(n, 3, 1))], -1)
            (d / name).write_text(json.dumps({"poses": poses.tolist()}))
    argv = ["blender", "s.blend", "-P", "v.py", "--", str(tmp_path), "sim"]
    got = _run_script(monkeypatch, ttraj, argv)
    want = _run_script(monkeypatch, jtraj, argv)
    assert got == want
    curves = [e for e in got if e[0] == "new" and e[1] == "curves"]
    assert [c[2] for c in curves] == ["init_0.json", "replan_0_0.json", "replan_1_0.json"]
    cos = [e[3] for e in got if e[0] == "set" and e[2] == "co"]
    assert len(cos) == 4 + 4 + 5 and all(c[3] == 1.0 for c in cos)
    assert ("link_child", "scene", "collections:nav_trajectories_sim") in got
