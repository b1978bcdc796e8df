"""nerfnav_tpu_torch/utils/profiling.py on the CPU: device_timer fills
out[name] (and passes CPU results through: there is no device to wait for),
trace writes a Chrome trace of the block and the counters of its spans.

The program's spans and counters: without a profiler a span is the shared
no-op and nothing is counted; under torch.profiler a tiny grid step (with
its sweep) and a tiny dense step emit the training path's spans, nested as
the program nests them, in the profiler's events and in `ranges()` on the
events' clock; the shade's counters match the render; nothing syncs on the
CPU; and the step's loss and parameters are bit-identical with and without
the profiler. The card case (skipped without CUDA) counts a host read as one
sync and a kernel as none."""

import json
import os

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nerfnav_tpu_torch.models.network import NetworkConfig
from nerfnav_tpu_torch.models.occupancy import OccupancyConfig, _finish_update
from nerfnav_tpu_torch.models.renderer import RenderConfig
from nerfnav_tpu_torch.ops.marching import MarchConfig
from nerfnav_tpu_torch.training import trainer as ttrain
from nerfnav_tpu_torch.utils import profiling
from nerfnav_tpu_torch.utils.profiling import device_timer, trace

torch.set_num_threads(1)

HW = 16
N_RAYS = 128
NET = dict(bound=2.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
           grid_max_resolution=32, grid_layout="cell", density_scale=10.0)
MARCH = dict(bound=2.0, grid_size=32, max_steps=256, samples_per_ray=16, min_near=0.05)
OCC = dict(bound=2.0, grid_size=32, update_chunk=8192, density_thresh=50.0, min_near=0.05)

# each span of the training path and the span it opens in (None: none)
PARENT = {"train.draw": None, "train.step": None, "train.rays": "train.step",
          "render.march": "train.step", "render.shade": "train.step",
          "render.composite": "train.step", "train.backward": "train.step",
          "train.apply": "train.step", "train.sweep": None,
          "occupancy.query": "train.sweep", "occupancy.finish": "train.sweep"}
GRID_ONLY = {"render.march", "train.sweep", "occupancy.query", "occupancy.finish"}


def test_device_timer_fills_out(capsys):
    out = {}
    with device_timer("matmul", out) as box:
        x = torch.ones((64, 64))
        box["result"] = {"y": x @ x, "rest": [x.sum(), None]}
    assert out["matmul"] > 0.0
    assert "[timer] matmul:" in capsys.readouterr().out
    with device_timer("nothing registered"):
        pass


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as path:
        torch.ones((32, 32)).matmul(torch.ones((32, 32)))
    assert path == os.path.join(str(tmp_path / "tr"), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


# ------------------------------------------------------ spans and counters
def _arrays(n=2, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        c, s = np.cos(0.4 * i), np.sin(0.4 * i)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = [-3.0 * s, 0.05, -3.0 * c]
    return {"poses": torch.as_tensor(poses),
            "images": torch.as_tensor(rng.random((n, HW, HW, 4), dtype=np.float32)),
            "intrinsics": torch.tensor([HW * 1.2, HW * 1.2, HW / 2, HW / 2])}


def _trainer(tmp_path, grid):
    """A tiny Trainer sweeping every 2 steps; the grid one starts from an
    occupancy grid with a ball of radius 0.5 on, which about a fifth of the
    rays cross, so the point budget comes in at the first sweep after a
    step."""
    opt = ttrain.TrainerOptions(name="p", workspace=str(tmp_path), num_rays=N_RAYS, iters=100,
                                use_checkpoint="scratch", update_extra_interval=2)
    if not grid:
        return ttrain.Trainer(NetworkConfig(**NET), RenderConfig(num_steps=16, upsample_steps=8),
                              opt, device="cpu")
    tr = ttrain.Trainer(NetworkConfig(**NET), RenderConfig(), opt,
                        occupancy_cfg=OccupancyConfig(**OCC), march_cfg=MarchConfig(**MARCH),
                        device="cpu")
    occ, cfg = tr.occupancy, tr.occupancy_cfg
    h = cfg.grid_size
    cells = torch.arange(h**3)
    ijk = torch.stack([cells // (h * h), (cells // h) % h, cells % h], -1)
    ball = ((ijk.float() + 0.5) / h * 2.0 - 1.0).norm(dim=-1) < 0.5
    tmp = torch.where(ball, 100.0, 0.0).expand(cfg.cascades, -1)
    tr.set_occupancy({**occ, **_finish_update(occ, cfg, occ["density_grid"], tmp)})
    return tr


def _loop(tr, arrays, steps, rng, shaded=None):
    """Trainer.train's loop body `steps` times; returns the losses. shaded
    collects (point budget, the render's n_samples) of each step."""
    losses = []
    for _ in range(steps):
        tr._maybe_update_occupancy()
        budget = tr._current_budget()
        draws = tr.draw_step(tr.state, int(rng.integers(2)), HW, HW)
        losses.append(tr.train_step(tr.state, arrays, draws))
        if shaded is not None and tr.march_cfg is not None:
            shaded.append((budget, shaded.pop()))
    return losses


@pytest.fixture(scope="module", params=["grid", "dense"])
def runs(request, tmp_path_factory):
    """Two equal trainers through 4 steps (sweeps at steps 0 and 2), the
    second through steps 2-3 under torch.profiler: what each ran and
    counted."""
    grid = request.param == "grid"
    arrays = _arrays()
    out = {"grid": grid}
    for traced in (False, True):
        tr = _trainer(tmp_path_factory.mktemp(request.param), grid)
        rng = np.random.default_rng(7)
        losses = _loop(tr, arrays, 2, rng)
        shaded = []
        render0 = ttrain.render_rays_grid

        def render(*a, **k):
            res = render0(*a, **k)
            shaded.append(res["n_samples"])
            return res

        ttrain.render_rays_grid = render
        try:
            before = profiling.counters()
            if traced:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    losses += _loop(tr, arrays, 2, rng, shaded)
                out["events"] = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                                 for e in prof.profiler.kineto_results.events()
                                 if e.name().startswith(profiling.PREFIX)
                                 and e.device_type() == DeviceType.CPU]
                out["counters"] = profiling.counters_since(before)
                out["shaded"] = shaded
                out["ranges"] = profiling.ranges()
            else:
                losses += _loop(tr, arrays, 2, rng, shaded)
                out["untraced_counters_moved"] = profiling.counters() != before
        finally:
            ttrain.render_rays_grid = render0
        out["traced" if traced else "plain"] = (
            [float(x) for x in losses], [t.detach().clone() for t in ttrain._leaves(tr.params)])
    return out


def test_span_is_a_shared_no_op_without_a_profiler(runs):
    assert profiling.span("train.step") is profiling.span("render.march") is profiling._OFF
    before = profiling.counters()
    with profiling.span("x"):
        profiling.count("n", 1)
    assert profiling.counters() == before
    assert not runs["untraced_counters_moved"]


def test_traced_steps_emit_the_spans_nested(runs):
    want = set(PARENT) - (set() if runs["grid"] else GRID_ONLY)
    events = runs["events"]
    names = {n[len(profiling.PREFIX):] for n, _, _ in events}
    assert names == want
    assert set(runs["counters"]) == want
    for name, s, e in events:
        parent = PARENT[name[len(profiling.PREFIX):]]
        inside = [n for n, ps, pe in events
                  if n != name and ps <= s and e <= pe]
        if parent is None:
            assert not inside, (name, inside)
        else:
            assert profiling.PREFIX + parent in inside, (name, inside)
    # two steps, a sweep on the grid path
    assert runs["counters"]["train.step"]["calls"] == 2
    if runs["grid"]:
        assert runs["counters"]["train.sweep"]["calls"] == 1


def test_ranges_are_on_the_clock_of_the_profilers_events(runs):
    """Each program range lies inside its profiler event of the same name
    (the record_function opens before the clock is read and closes after),
    within a millisecond."""
    events = sorted(runs["events"], key=lambda e: e[1])
    ranges = [r for r in runs["ranges"] if r[1] >= events[0][1] - 1_000_000]
    assert len(ranges) == len(events)
    for (n, s, e), (rn, rs, re) in zip(events, sorted(ranges, key=lambda r: r[1])):
        assert profiling.PREFIX + rn == n
        assert s - 1_000_000 <= rs <= re <= e + 1_000_000


def test_no_host_syncs_on_the_cpu(runs):
    assert all(c["host_syncs"] == 0 for c in runs["counters"].values())


def test_profiler_leaves_loss_and_params_bit_identical(runs):
    (l0, p0), (l1, p1) = runs["plain"], runs["traced"]
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("runs", ["grid"], indirect=True)
def test_grid_shade_counts_valid_samples_and_slots(runs):
    shade = runs["counters"]["render.shade"]
    budgets = [b for b, _ in runs["shaded"]]
    valid = [int(n) for _, n in runs["shaded"]]
    assert all(b is not None for b in budgets)      # the packed shade ran
    assert shade["valid_samples"] == sum(valid)
    assert shade["shaded_slots"] == sum(budgets)
    assert shade["filled_slots"] == sum(min(v, b) for v, b in zip(valid, budgets))


@pytest.mark.parametrize("value", [3, torch.tensor(3), lambda: torch.tensor(3)])
def test_count_charges_the_innermost_span(value):
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("test.outer"), profiling.span("test.inner"):
            profiling.count("things", value)
        profiling.count("loose", 2)
    got = profiling.counters_since(before)
    assert got["test.inner"] == {"calls": 1, "host_syncs": 0, "things": 3}
    assert got["test.outer"] == {"calls": 1, "host_syncs": 0}
    assert got[None] == {"loose": 2}


def test_device_counts_fold_without_losing_any():
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]), profiling.span("test.fold"):
        for i in range(3 * profiling._FOLD + 5):
            profiling.count("i", torch.tensor(i))
    n = 3 * profiling._FOLD + 5
    assert profiling.counters_since(before)["test.fold"]["i"] == n * (n - 1) // 2
    assert len(profiling._counters["test.fold"]["i"][1]) <= profiling._FOLD


def test_trace_writes_the_counters_of_its_spans(tmp_path):
    with trace(str(tmp_path / "tr")):
        with profiling.span("test.traced"):
            profiling.count("rows", 5)
    with open(tmp_path / "tr" / "counters.json") as f:
        assert json.load(f) == {"test.traced": {"calls": 1, "host_syncs": 0, "rows": 5}}


def test_host_syncs_are_counted_on_the_card():
    """On a CUDA card: a host read inside a span counts one sync there and
    a kernel none, the site is this file, and a kernel issued inside a span
    runs within the span's range on the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda's sync debug mode needs one")
    t = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("test.card"):
            with profiling.span("test.read"):
                float(t.sum())
            with profiling.span("test.kernel"):
                (t * 2).sum()
            with profiling.span("test.sleep"):
                torch.cuda._sleep(10_000_000)
                torch.cuda.synchronize()
    got = profiling.counters_since(before)
    assert got["test.read"]["host_syncs"] == 1
    assert got["test.kernel"]["host_syncs"] == 0
    assert got["test.card"]["host_syncs"] == 0
    assert [s.split(":")[0] for s in profiling.sync_sites()["test.read"]] == [
        "test_torch_profiling.py"]
    assert torch.cuda.get_sync_debug_mode() == 0
    # the longest kernel is the ~6 ms spin of torch.cuda._sleep
    ks, ke = max(((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()),
                 key=lambda k: k[1] - k[0])
    (_, rs, re), = [r for r in profiling.ranges() if r[0] == "test.sleep"][-1:]
    assert ke - ks > 1_000_000 and rs <= ks < ke <= re


# ------------------------------------------------------------- mip-NeRF
MIP_PARENT = {"train.draw": None, "train.step": None, "train.rays": "train.step",
              "render.coarse": "train.step", "render.resample": "train.step",
              "render.fine": "train.step", "render.ipe": ("render.coarse", "render.fine"),
              "render.shade": ("render.coarse", "render.fine"),
              "render.composite": ("render.coarse", "render.fine"),
              "train.backward": "train.step", "train.apply": "train.step"}


@pytest.fixture(scope="module")
def mip_run(tmp_path_factory):
    """A tiny mip-NeRF Trainer through 2 steps under torch.profiler."""
    from nerfnav_tpu_torch.models.network import MipNerfConfig

    cfg = MipNerfConfig(net_width=32, net_width_condition=16, max_deg_point=4, deg_view=2,
                        num_samples=8)
    opt = ttrain.TrainerOptions(name="m", workspace=str(tmp_path_factory.mktemp("mip")),
                                num_rays=N_RAYS, use_checkpoint="scratch", bg_train="white")
    tr = ttrain.Trainer(cfg, RenderConfig(), opt, device="cpu")
    arrays = _arrays()
    rng = np.random.default_rng(3)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _loop(tr, arrays, 2, rng)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.PREFIX) and e.device_type() == DeviceType.CPU]
    return {"cfg": cfg, "events": events, "counters": profiling.counters_since(before),
            "device_values": {s: profiling._counters[s]["mlp_samples"][1]
                              for s in ("render.coarse", "render.fine")}}


def test_mip_spans_nest_in_the_step(mip_run):
    events = mip_run["events"]
    assert {n[len(profiling.PREFIX):] for n, _, _ in events} == set(MIP_PARENT)
    for name, s, e in events:
        parent = MIP_PARENT[name[len(profiling.PREFIX):]]
        inside = {n[len(profiling.PREFIX):] for n, ps, pe in events
                  if n != name and ps <= s and e <= pe}
        if parent is None:
            assert not inside, (name, inside)
        else:
            parents = parent if isinstance(parent, tuple) else (parent,)
            assert inside & set(parents), (name, inside)
    c = mip_run["counters"]
    assert c["render.coarse"]["calls"] == c["render.fine"]["calls"] == 2
    assert c["render.resample"]["calls"] == 2
    assert c["render.ipe"]["calls"] == c["render.shade"]["calls"] == 4


def test_mip_counts_the_mlp_samples_per_step(mip_run):
    """Each level's span counts N x num_samples a step, exactly; at the
    benchmark cell's sizes that is 2 x 4096 x 128 a step."""
    import json

    c, cfg = mip_run["counters"], mip_run["cfg"]
    for level in ("render.coarse", "render.fine"):
        assert c[level]["mlp_samples"] == 2 * N_RAYS * cfg.num_samples
        assert "mlp_samples" not in c["render.shade"]
    with open(os.path.join(os.path.dirname(__file__), "..", "perfbench", "configs",
                           "mipnerf-blender.json")) as f:
        cell = json.load(f)
    assert cell["num_levels"] * cell["num_rays"] * cell["num_samples"] == 2 * 4096 * 128


def test_mip_counting_adds_no_host_sync(mip_run):
    """The counts are host numbers from the shapes: no device value to read
    back, and no sync in any span."""
    assert mip_run["device_values"] == {"render.coarse": [], "render.fine": []}
    assert all(v["host_syncs"] == 0 for v in mip_run["counters"].values())
