"""Training traffic: the step loop of nerfnav_tpu_torch's `Trainer.train`.

Set-up renders the scene on the device from the analytic field of the
traffic file (`perfbench/scene.py`), makes the field's weights from the seed
at torch-ngp's initialisation (hash tables U(-1e-4, 1e-4), bias-free layers
U(-1/sqrt(fan_in), 1/sqrt(fan_in))), builds the Trainer from the
configuration's command-line flags through the program's own `make_configs`,
marks the cells no training camera sees as `Trainer.train` does, and drives
the loop from step 0: `_maybe_update_occupancy`, the image drawn by numpy,
`draw_step`, `train_step`, the loss read every `update_extra_interval`
steps. The first `CHECKED_STEPS` steps, with the first sweep, are recorded
for the correctness check. With the traffic's `check_at`, the loop runs on
to that step (on the grid path, 256: the first partial sweep, with the
point budget in force since step 16) and records `CHECKED_STEPS` more, the
steps the window takes; it then runs on to `warm_steps`. The window
continues the same loop; no checkpoint is written. The window's schedule is
the program's own: partial sweeps every 16 steps and the march's dt
multiplier falling from 8 to 4 at step 1500; the run prints its steps in
each phase.

Correctness (`check`): the reference (`perfbench/reference/ngp.py`) follows
each set of checked steps from the same state, images, poses and draws.
From the seed, the state is the seeded weights and a fresh Adam; at
`check_at` it is the program's weights, Adam moments and step count and
density grid there (the reference cannot follow 256 steps at these sizes;
the start from the seed is checked by itself). The numbers, the later set's
named `late_...`:
- `loss`: the first step's |loss - reference| / reference (the later
  steps' losses carry Adam's sign noise: with eps 1e-15 a gradient at the
  level of rounding moves its parameter by +-lr);
- `grad`: the first step's gradient as Adam holds it ((its first moment
  after the step - beta1 x before) / (1 - beta1)), per parameter tensor
  |norm - reference norm| / max(reference norm, median tensor's), the
  worst tensor;
- `change`: the same of each tensor's change over the three steps, over the
  tensors whose reference gradient is above 1/1000 of the median tensor's,
  the median tensor (the worst one carries the same sign noise);
- on the grid path, `march`: the share of the three steps' rays whose kept
  samples differ from the reference march on the program's occupancy grid;
  `budget`: the share of the steps whose point budget differs from the
  configuration's rule on the running mean of valid samples (the reference
  shades the first that many valid samples, ray by ray, as the program
  does);
  `density`: the sweep's density grid (full from the seed, partial at
  `check_at`), max |program - reference| / (|reference| + mean density);
  `occupancy`: the share of cells whose occupancy bit disagrees with the
  program's own density against the carve bar (the packing and the bar,
  checked by themselves: a fresh field's densities all sit next to the bar,
  so which side of it a cell falls is rounding); `unseen` (from the seed):
  the share of cells whose "no camera sees it" mark differs.
"""

from collections import Counter
from contextlib import contextmanager
import statistics
import time

import numpy as np
import torch

from perfbench import scene
from perfbench.weights import make_params
from perfbench.reference import ngp as ref
from perfbench.run import Check, Window

CHECKED_STEPS = 3


def _same(name, program, reference):
    if program != reference:
        raise RuntimeError(f"the program's {name} {program} is not the configuration's "
                           f"{reference}")


def check_program_config(c, cfg, mcfg, occ_cfg, topt):
    """The program's expansion of the flags against the configuration file."""
    _same("grid resolutions", list(cfg.grid.resolutions), ref.level_resolutions(c))
    _same("table rows", list(cfg.grid.level_sizes), ref.level_rows(c))
    _same("layout", cfg.grid.layout, c["grid_layout"])
    _same("coordinate convention", cfg.grid.coord_convention, c["grid_coord_convention"])
    _same("sigma net", [cfg.pos_dim, cfg.hidden_dim, 1 + cfg.geo_feat_dim], c["sigma_net"])
    _same("color net", [cfg.dir_dim + cfg.geo_feat_dim, cfg.hidden_dim_color,
                        cfg.hidden_dim_color, 3], c["color_net"])
    _same("mlp backend", cfg.mlp_backend, "fused")
    _same("density scale", cfg.density_scale, c["density_scale"])
    _same("lr, iters, rays", (topt.lr, topt.iters, topt.num_rays),
          (c["lr"], c["iters"], c["num_rays"]))
    if mcfg is not None:
        _same("march", (mcfg.max_steps, mcfg.samples_per_ray, mcfg.dt_gamma, mcfg.min_near,
                        mcfg.coarse_factor, mcfg.coarse_step_mult, mcfg.coarse_segments,
                        mcfg.grid_size),
              (c["max_steps"], c["samples_per_ray"], c["dt_gamma"], c["min_near"],
               c["occ_coarse_factor"], c["coarse_step_mult"], c["coarse_segments"],
               c["occ_grid_size"]))
        _same("occupancy", (occ_cfg.grid_size, occ_cfg.density_thresh, occ_cfg.decay,
                            occ_cfg.n_full_updates, occ_cfg.cascades),
              (c["occ_grid_size"], c["occ_density_thresh"], c["occ_decay"],
               c["occ_full_updates"], 1))
        _same("dt anneal", [list(t) for t in topt.dt_anneal], c["dt_anneal"])
        _same("sweep interval", topt.update_extra_interval, c["update_extra_interval"])
        _same("point budget", (topt.point_budget, topt.point_budget_margin,
                               list(topt.point_budget_fracs)),
              (True, c["point_budget_margin"], c["point_budget_fracs"]))
        # the reference's sweep: max(decayed, queried), no clamp, debounce or
        # hysteresis
        _same("sweep rule", (occ_cfg.ema_sampled_only, occ_cfg.ema_toward_query,
                             occ_cfg.density_write_clamp, occ_cfg.occ_debounce,
                             occ_cfg.occ_hysteresis), (False, False, 0.0, False, 0.0))


class Cell:
    def __init__(self, ctx):
        from nerfnav_tpu_torch.cli.flags import build_parser, make_configs
        from nerfnav_tpu_torch.models.occupancy import mark_untrained_grid
        from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions

        self.ctx, c, tf = ctx, ctx.config, ctx.traffic
        dev = self.device = ctx.device
        self.spans = ctx.spans
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        hw = tf["hw"]
        self.H = self.W = hw
        focal = scene.fov_focal(tf["focal_800"], hw)
        poses = torch.as_tensor(scene.sphere_views(tf["views"], tf["radius"] * c["scale"]),
                                device=dev)
        intr = scene.intrinsics_of(focal, hw, hw)
        images = scene.rgba_views(scene.FIELDS[tf["field"]], poses, intr, hw, hw,
                                  tf["scene_samples"])
        self.arrays = {"poses": poses, "images": images,
                       "intrinsics": torch.tensor(intr, device=dev)}
        self.p0 = make_params(c, gen, dev)

        opt = build_parser("perfbench").parse_args(["scene", *c["flags"], *tf["flags"]])
        cfg, rcfg, occ_cfg, mcfg = make_configs(opt)
        topt = TrainerOptions(name="perfbench", workspace=str(ctx.scratch / "workspace"),
                              lr=opt.lr, iters=opt.iters, num_rays=opt.num_rays,
                              seed=ctx.seed, update_extra_interval=opt.update_extra_interval,
                              use_checkpoint="scratch")
        check_program_config(c, cfg, mcfg, occ_cfg, topt)
        self.grid = mcfg is not None
        self.tr = Trainer(cfg, rcfg, topt, params=self.p0, occupancy_cfg=occ_cfg,
                          march_cfg=mcfg, device=dev)
        if self.grid:
            self.tr.set_occupancy(mark_untrained_grid(
                self.tr.state.occupancy, occ_cfg, poses, self.arrays["intrinsics"], hw, hw))
        self.rng = np.random.default_rng(ctx.seed)
        self.interval = topt.update_extra_interval
        if self.grid and self.interval < CHECKED_STEPS:
            raise ValueError(f"the checked steps hold one sweep: update_extra_interval "
                             f"{self.interval} is under {CHECKED_STEPS}")
        self.losses = []
        self.sweeps = 0
        self._rec = None
        self.syncs = []
        self.done = 0       # steps run (the program's count, where it counts right)
        self.records = [self._checked_steps()]
        if tf.get("check_at"):
            while self.done < tf["check_at"]:
                self.step()
            self.records.append(self._checked_steps())
        while self.done < tf["warm_steps"]:
            self.step()
        self._sync()

    # ------------------------------------------------------------ the loop
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """One pass of Trainer.train's loop body. Returns (the point budget;
        the points each cascade's sweep queried, or [] without a sweep)."""
        tr, spans = self.tr, self.spans
        sweep = []
        if self.grid and tr.global_step % self.interval == 0:
            # the first n_full_updates sweeps query every cell, the later
            # ones half of them
            n = tr.occupancy_cfg.n_cells
            partial = self.sweeps >= tr.occupancy_cfg.n_full_updates
            sweep = [n // 2 if partial else n] * tr.occupancy_cfg.cascades
            with spans("sweep"):
                tr._maybe_update_occupancy()
            self.sweeps += 1
        idx = int(self.rng.integers(len(self.arrays["poses"])))
        budget = tr._current_budget()
        at = tr.global_step
        with spans("draw"):
            draws = tr.draw_step(tr.state, idx, self.H, self.W)
        with spans("step"):
            loss = tr.train_step(tr.state, self.arrays, draws)
        self.losses.append(loss)
        self.done += 1
        if tr.global_step % self.interval == 0:
            with spans("loss_read"):
                float(loss)
            self.syncs.append(time.perf_counter())
        if self._rec is not None:
            self._rec["steps"].append({"idx": idx, "draws": draws, "loss": loss.detach(),
                                       "at": at, "budget": budget})
        return budget, sweep

    def _checked_steps(self):
        """Run the next CHECKED_STEPS steps and record them for the check:
        the state before them (parameters, Adam's moments and step count),
        the running mean of valid samples, which the sweep among them hands
        to the point budget), each step's draws, loss, march and point
        budget, the sweep (its draws and the density grid before and after
        it), the first gradient as Adam holds it and the parameters after
        them."""
        mc = self.tr.state.mean_count
        rec = {"steps": [], "p0": _leaves_copy(self.tr), "adam0": self._adam_state(),
               "mean_count": 0.0 if mc is None else float(mc)}
        b1 = self.tr.state.optimizer.param_groups[0]["betas"][0]
        with self._recording(rec):
            for i in range(CHECKED_STEPS):
                self.step()
                if i == 0:
                    m1 = self._adam_state()[0]
                    rec["g1"] = [(a - b1 * b) / (1 - b1) for a, b in zip(m1, rec["adam0"][0])]
        rec["params3"] = _leaves_copy(self.tr)
        return rec

    def _adam_state(self):
        """(first moments, second moments, steps taken) of the program's
        Adam, per parameter tensor; zeros where it holds none."""
        opt = self.tr.state.optimizer
        m, v, t = [], [], 0
        for p in ref.leaves(self.tr.state.params):
            st = opt.state.get(p, {})
            m.append(st["exp_avg"].clone() if "exp_avg" in st else torch.zeros_like(p))
            v.append(st["exp_avg_sq"].clone() if "exp_avg_sq" in st else torch.zeros_like(p))
            if "step" in st:
                t = int(st["step"])
        return m, v, t

    @contextmanager
    def _recording(self, rec):
        """Record the steps' marches and the sweep among them, by wrapping
        the program's march and its sweep draws."""
        import nerfnav_tpu_torch.ops.marching as marching
        import nerfnav_tpu_torch.training.trainer as trainer_mod

        march0, draw0 = marching.march, trainer_mod.draw_update
        rec["marches"] = []

        def march(*a, **k):
            m = march0(*a, **k)
            rec["marches"].append({key: m[key].clone() for key in ("z", "dt", "valid")})
            return m

        def draw_update(*a, **k):
            draws = draw0(*a, **k)
            d = draws[0]
            rec["sweep"] = {"jitter": d.jitter.clone(), "rand_cells": d.rand_cells,
                            "u": d.u, "grid_before":
                            self.tr.state.occupancy["density_grid"][0].clone()}
            return draws

        march.calls = march0.calls
        marching.march, trainer_mod.draw_update = march, draw_update
        self._rec = rec
        try:
            yield
        finally:
            marching.march, trainer_mod.draw_update = march0, draw0
            self._rec = None
        if "sweep" in rec:
            occ = self.tr.state.occupancy
            rec["sweep"]["grid_after"] = occ["density_grid"][0].clone()
            rec["sweep"]["bits_after"] = occ["bitfield"][0].clone()

    # ----------------------------------------------------------- the window
    def window(self, seconds, traced):
        tf, c = self.ctx.traffic, self.ctx.config
        self._sync()
        trace = None
        steps = 0
        n0 = len(self.losses)
        at0 = self.tr.global_step
        budgets, mults = Counter(), Counter()
        self.syncs = []
        proc0 = time.process_time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or (traced and trace is None):
            if traced and trace is None and steps >= tf["trace_after"] \
                    and self.tr.global_step % self.interval == 0:
                trace = self._traced_steps(traced, tf["trace_steps"])
                steps += tf["trace_steps"]
                continue
            mults[self.tr._dt_mult()] += 1
            budgets[self.step()[0]] += 1
            steps += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        notes = _host_notes(self.syncs, (time.process_time() - proc0) / elapsed)
        notes.update(steps=[at0, self.tr.global_step], dt_mult_steps=dict(mults),
                     budget_steps={str(k): n for k, n in budgets.items()})
        losses = torch.stack(self.losses[n0:])
        failed = int((~torch.isfinite(losses)).sum())
        metrics = {tf["metric"]: steps * c["num_rays"] / elapsed}
        return Window(metrics=metrics, attempted=steps, failed=failed, trace=trace,
                      notes=notes)

    def _traced_steps(self, traced, n):
        """n steps under the profiler; counts the samples each step shaded
        (the valid samples its march kept, within the point budget, as the
        training render reports them) and the points each sweep queried."""
        c = self.ctx.config
        recs, shaded = [], []
        with _counting(shaded), traced() as tr:
            for _ in range(n):
                recs.append(self.step())
        if self.grid:
            samples = [min(int(k), b) if b else int(k) for b, k in shaded]
        else:           # the dense path: every sample is shaded
            samples = [c["num_rays"] * c["num_steps"]] * n
        tr.counters = {"steps": n, "samples": samples,
                       "sweep_points": [p for _, sweep in recs for p in sweep],
                       "sweep_chunk": self.tr.occupancy_cfg.update_chunk if self.grid else 0,
                       "t0": tr.t0, "t1": tr.t0 + tr.window_s}
        return tr

    def release(self):
        """Free the program's state; the records stay for the check."""
        self.tr = None
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def check(self):
        """The program's recorded readings against the reference's: the
        steps from the seed (the names as they are) and, with `check_at`,
        the steps from the program's state there (the names `late_...`)."""
        checks = []
        with _no_tf32():
            for rec, prefix in zip(self.records, ("", "late_")):
                prog = self.program_readings(rec)
                refr = self.reference_readings(rec, ref.PRECISIONS["config"], prog.get("bits"))
                checks += compare(prog, refr, self.ctx.traffic["limits"], prefix)
        return checks

    def control(self):
        """The control: the reference in the control's precision in the
        program's place, against the reference."""
        checks = []
        with _no_tf32():
            for rec, prefix in zip(self.records, ("", "late_")):
                ctrl = self.reference_readings(rec, ref.PRECISIONS["control"])
                refr = self.reference_readings(rec, ref.PRECISIONS["config"], ctrl.get("bits"))
                checks += compare(ctrl, refr, self.ctx.traffic["limits"], prefix)
        return checks

    def program_readings(self, rec):
        out = {"losses": [float(st["loss"]) for st in rec["steps"]], "g1": rec["g1"],
               "params3": rec["params3"], "marches": rec["marches"],
               "budgets": [st["budget"] for st in rec["steps"]]}
        if self.grid:
            sw = rec["sweep"]
            out.update(unseen=sw["grid_before"] < 0, grid=sw["grid_after"],
                       bits=_unpack(sw["bits_after"]))
        return out

    def reference_readings(self, rec, prec, march_bits=None):
        """The same readings from the reference, from the same state, scene
        and draws; its march runs on march_bits (the program's occupancy,
        whose sweep is compared by itself) or on its own. From the seed the
        reference marks the unseen cells itself; later it starts from the
        program's density grid, weights and Adam state."""
        c, arrays = self.ctx.config, self.arrays
        H, W = self.H, self.W
        leaves0 = rec["p0"]
        out = {}
        if self.grid:
            sw = rec["sweep"]
            p_sweep = ref.with_leaves(self.p0, leaves0)
            if sw["rand_cells"] is None:
                unseen = ref.unseen_cells(arrays["poses"], arrays["intrinsics"], H, W, c)
                grid, bits = ref.full_sweep(p_sweep, torch.where(unseen, -1.0, 0.0),
                                            sw["jitter"], c, prec)
                out["unseen"] = unseen
            else:
                grid, bits = ref.partial_sweep(p_sweep, sw["grid_before"], sw["rand_cells"],
                                               sw["u"], sw["jitter"], c, prec)
            out.update(grid=grid, bits=bits, thresh_cap=c["occ_density_thresh"])
            march_bits = bits if march_bits is None else march_bits
        cur = [t.detach().clone() for t in leaves0]
        budget = ref.point_budget(c, rec["mean_count"]) if self.grid else None
        grads, losses, marches = [], [], []
        for st in rec["steps"]:
            d = st["draws"]
            o, dirs = ref.pixel_rays(arrays["poses"][st["idx"]], arrays["intrinsics"], W,
                                     d.rays.inds)
            px = arrays["images"][st["idx"]].reshape(H * W, -1)[d.rays.inds]
            gt = px[:, :3] * px[:, 3:] + d.bg * (1.0 - px[:, 3:]) if px.shape[1] == 4 else px
            if self.grid:
                z, dt, valid = ref.march(o, dirs, march_bits, c, st["at"], d.march.u,
                                         d.march.phase)
                marches.append({"z": z, "dt": dt, "valid": valid})
                valid = ref.within_budget(valid, budget)
            else:
                z, dt = ref.dense_samples(o, dirs, d.jitter, c)
                valid = torch.ones_like(z, dtype=torch.bool)
            p = ref.with_leaves(self.p0, [t.clone().requires_grad_() for t in cur])
            img = ref.render_samples(p, o, dirs, z, dt, valid, d.bg, c, prec)
            loss = ((img - gt) ** 2).mean()
            grads.append([g.detach() for g in torch.autograd.grad(loss, ref.leaves(p))])
            losses.append(float(loss.detach()))
            cur = ref.adam(leaves0, grads, c, rec["adam0"])
        out.update(losses=losses, g1=grads[0], params3=cur, marches=marches,
                   leaves0=leaves0, budgets=[budget] * len(grads))
        return out

def compare(prog, refr, limits, prefix=""):
    """The compared numbers (see the module's docstring), each beside its
    limit; `prefix` names the set of checked steps."""
    checks = []

    def add(name, value):
        checks.append(Check(prefix + name, value, limits[prefix + name]))

    if "grid" in refr:
        seen = refr["grid"] >= 0
        mean = refr["grid"].clamp(min=0).mean()
        dens = ((prog["grid"] - refr["grid"]).abs() / (refr["grid"].abs() + mean))[seen]
        if "unseen" in refr:
            add("unseen", float((prog["unseen"] != refr["unseen"]).float().mean()))
        add("density", float(dens.max()) if dens.numel() else 0.0)
        add("occupancy", _bits_off(prog["grid"], prog["bits"], refr["thresh_cap"]))
    # the first step only: Adam's eps of 1e-15 turns rounding-level
    # gradients into +-lr steps, so the later steps' losses carry that noise
    a, b = prog["losses"][0], refr["losses"][0]
    add("loss", abs(a - b) / abs(b))
    g_ref = [float(t.norm()) for t in refr["g1"]]
    add("grad", _worst_gap([float(t.norm()) for t in prog["g1"]], g_ref))
    med = statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med]
    leaves0 = refr["leaves0"]
    d_ref = [float((refr["params3"][i] - leaves0[i]).norm()) for i in keep]
    d_prog = [float((prog["params3"][i] - leaves0[i]).norm()) for i in keep]
    add("change", statistics.median(_gaps(d_prog, d_ref)))
    if refr["marches"]:
        differ = rays = 0
        for pm, rm in zip(prog["marches"], refr["marches"]):
            rays += len(rm["valid"])
            if pm["valid"].shape != rm["valid"].shape:
                differ += len(rm["valid"])
                continue
            same = ((pm["valid"] == rm["valid"]).all(-1)
                    & ((pm["z"] - rm["z"]).abs() <= 1e-5).all(-1)
                    & ((pm["dt"] - rm["dt"]).abs() <= 1e-5).all(-1))
            differ += int((~same).sum())
        add("march", differ / max(rays, 1))
        add("budget", sum(a != b for a, b in zip(prog["budgets"], refr["budgets"]))
            / len(refr["budgets"]))
    return checks


def _bits_off(grid, bits, cap, band=1e-5):
    """The share of cells whose occupancy bit disagrees with their own
    density against the carve bar min(mean of the clamped grid, cap), among
    the cells more than `band` (relative) away from the bar: at a fresh
    field nearly every density sits next to the bar, and which side a cell
    takes there is rounding, not a result."""
    thresh = grid.clamp(min=0.0).mean().clamp(max=cap)
    far = (grid - thresh).abs() > band * thresh
    return float(((grid > thresh) != bits)[far].float().sum() / grid.numel())


def _gaps(prog, refs):
    """Per tensor |a - b| / max(b, the median of b)."""
    med = statistics.median(refs)
    return [abs(a - b) / max(b, med, 1e-30) for a, b in zip(prog, refs)]


def _worst_gap(prog, refs):
    return max(_gaps(prog, refs))


def _unpack(bits):
    """A little-endian byte bitfield (m,) uint8 -> (8 m,) bool."""
    shifts = torch.arange(8, device=bits.device)
    return ((bits.long()[:, None] >> shifts) & 1).bool().reshape(-1)


def _leaves_copy(tr):
    return [t.detach().clone() for t in ref.leaves(tr.state.params)]


@contextmanager
def _counting(sink):
    """Append (point budget, valid samples before the budget) of each
    training render to sink, as the program's render reports them."""
    import nerfnav_tpu_torch.training.trainer as trainer_mod

    render0 = trainer_mod.render_rays_grid

    def render(*a, **k):
        out = render0(*a, **k)
        sink.append((k.get("sample_budget"), out["n_samples"]))
        return out

    trainer_mod.render_rays_grid = render
    try:
        yield
    finally:
        trainer_mod.render_rays_grid = render0


def _host_notes(syncs, own_cores):
    """What the host did during the window, for reading its spread: the
    wall time between the loop's sync points (ms) and the cores this
    process kept busy."""
    blocks = sorted(1e3 * (b - a) for a, b in zip(syncs, syncs[1:]))
    notes = {"own_cores": own_cores}
    if len(blocks) > 1:
        q = statistics.quantiles(blocks, n=10)
        med = statistics.median(blocks)
        notes["block_ms"] = {"n": len(blocks), "p10": q[0], "median": med, "p90": q[-1],
                             "max": blocks[-1],
                             "over_1.5x": sum(b > 1.5 * med for b in blocks)}
    return notes


@contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
