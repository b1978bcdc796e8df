"""Training traffic for mip-NeRF: the step loop of nerfnav_tpu_torch's
`Trainer.train` with the program's `--mipnerf` field.

Set-up renders the scene on the device from the analytic field of the
traffic file (`perfbench/scene.py`) at NeRF-synthetic's cameras (the
traffic's radius and focal), makes mip-NeRF's weights from the seed
(Glorot-uniform weights, zero biases, `seeded_params`), builds the Trainer
from the configuration's command-line flags through the program's own
`make_configs` (checked against the configuration file), and drives the loop
from step 0: the image drawn by numpy, `draw_step`, `train_step`, the loss
read every `loss_read_interval` steps (the host's one wait). The first
`CHECKED_STEPS` steps are recorded for the correctness check; the loop runs
on to `warm_steps`, and the window continues it.

Correctness (`check`): the reference (`perfbench/reference/mipnerf.py`)
follows the checked steps from the seeded weights and a fresh Adam, with
the same images, pixels and draws:
- `loss`: the first step's |loss - reference| / reference;
- `grad`: the first step's gradient as Adam holds it ((its first moment
  after the step - beta1 x before) / (1 - beta1)), per parameter tensor
  |norm - reference norm| / max(reference norm, median tensor's), the
  worst tensor;
- `change`: the same of each tensor's change over the three steps, over the
  tensors whose reference gradient is above 1/1000 of the median tensor's,
  the median tensor;
- `resample`: each checked step's fine depths against the reference's
  blurred resample of the program's coarse weights at the same coarse
  depths and draws, max |program - reference| / (far - near).
"""

import math
import statistics
import time

import numpy as np
import torch

from perfbench import scene
from perfbench.drivers.train import _gaps, _host_notes, _worst_gap
from perfbench.reference import mipnerf as ref
from perfbench.roofline_mip import layer_dims
from perfbench.run import Check, Window

CHECKED_STEPS = 3
# the program's configuration fields that the configuration file states
SAME_KEYS = ("min_deg_point", "max_deg_point", "deg_view", "net_depth", "net_width",
             "net_depth_condition", "net_width_condition", "skip_layer", "density_bias",
             "rgb_padding", "num_samples", "num_levels", "resample_padding", "near", "far",
             "coarse_loss_mult", "lr_init", "lr_final", "lr_delay_steps", "lr_delay_mult",
             "max_steps", "adam_eps")


def seeded_params(c, gen, device):
    """Glorot-uniform weights U(-sqrt(6 / (in + out)), ...), drawn on the
    device in one call, and zero biases, in the program's layout."""
    dims = layer_dims(c)
    flat = torch.rand((sum(a * b for v in dims.values() for a, b in v),), generator=gen,
                      device=device)
    out, at = {}, 0
    for key, layers in dims.items():
        out[key] = []
        for a, b in layers:
            lim = math.sqrt(6.0 / (a + b))
            out[key] += [(flat[at:at + a * b].reshape(a, b) * 2.0 - 1.0) * lim,
                         torch.zeros(b, device=device)]
            at += a * b
    return out


def check_program_config(c, cfg, topt):
    """The program's expansion of the flags against the configuration file."""
    got = {k: getattr(cfg, k) for k in SAME_KEYS}
    got.update(adam_betas=list(cfg.adam_betas), mlp_backend=cfg.mlp_backend,
               num_rays=topt.num_rays, bg_train=topt.bg_train)
    want = {k: c[k] for k in SAME_KEYS}
    want.update(adam_betas=c["adam_betas"], mlp_backend="xla", num_rays=c["num_rays"],
                bg_train="white" if c["white_bkgd"] else "random")
    if got != want:
        raise RuntimeError(f"the program's configuration {got} is not the file's {want}")


class Cell:
    def __init__(self, ctx):
        from nerfnav_tpu_torch.cli.flags import build_parser, make_configs
        from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions

        self.ctx, c, tf = ctx, ctx.config, ctx.traffic
        dev = self.device = ctx.device
        self.spans = ctx.spans
        opt = build_parser("perfbench").parse_args(["scene", *c["flags"], *tf["flags"]])
        cfg, rcfg, _, _ = make_configs(opt)
        topt = TrainerOptions(name="perfbench", workspace=str(ctx.scratch / "workspace"),
                              num_rays=opt.num_rays, seed=ctx.seed, use_checkpoint="scratch",
                              bg_train="white" if c["white_bkgd"] else "random")
        check_program_config(c, cfg, topt)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        hw = tf["hw"]
        self.H = self.W = hw
        poses = torch.as_tensor(scene.sphere_views(tf["views"], tf["radius"]), device=dev)
        intr = scene.intrinsics_of(scene.fov_focal(tf["focal_800"], hw), hw, hw)
        images = scene.rgba_views(scene.FIELDS[tf["field"]], poses, intr, hw, hw,
                                  tf["scene_samples"])
        self.arrays = {"poses": poses, "images": images,
                       "intrinsics": torch.tensor(intr, device=dev)}
        self.p0 = seeded_params(c, gen, dev)
        self.tr = Trainer(cfg, rcfg, topt, params=self.p0, device=dev)
        self.rng = np.random.default_rng(ctx.seed)
        self.interval = tf["loss_read_interval"]
        self.losses = []
        self._rec = None
        self.syncs = []
        self.done = 0
        self.records = [self._checked_steps()]
        while self.done < tf["warm_steps"]:
            self.step()
        self._sync()

    # ------------------------------------------------------------ the loop
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """One pass of Trainer.train's loop body."""
        tr, spans = self.tr, self.spans
        idx = int(self.rng.integers(len(self.arrays["poses"])))
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
            self._rec["steps"].append({"idx": idx, "draws": draws, "loss": loss.detach()})

    def _checked_steps(self):
        """Run the next CHECKED_STEPS steps and record them: the parameters
        and Adam's state before them, each step's draws, loss and render
        (coarse depths and weights, fine depths), the first gradient as
        Adam holds it and the parameters after them."""
        import nerfnav_tpu_torch.training.trainer as trainer_mod

        rec = {"steps": [], "renders": [], "p0": _leaves_copy(self.tr),
               "adam0": self._adam_state()}
        b1 = self.tr.state.optimizer.param_groups[0]["betas"][0]
        render0 = trainer_mod.render_rays_mip

        def render(*a, **k):
            out = render0(*a, **k)
            rec["renders"].append({"t_coarse": out["t"][0].detach().clone(),
                                   "w_coarse": out["weights"][0].detach().clone(),
                                   "t_fine": out["t"][1].detach().clone()})
            return out

        trainer_mod.render_rays_mip = render
        self._rec = rec
        try:
            for i in range(CHECKED_STEPS):
                self.step()
                if i == 0:
                    m1 = self._adam_state()[0]
                    rec["g1"] = [(a - b1 * b) / (1 - b1) for a, b in zip(m1, rec["adam0"][0])]
        finally:
            trainer_mod.render_rays_mip = render0
            self._rec = None
        rec["params3"] = _leaves_copy(self.tr)
        return rec

    def _adam_state(self):
        opt = self.tr.state.optimizer
        m, v, t = [], [], 0
        for p in ref.leaves(self.tr.state.params):
            st = opt.state.get(p, {})
            m.append(st["exp_avg"].clone() if "exp_avg" in st else torch.zeros_like(p))
            v.append(st["exp_avg_sq"].clone() if "exp_avg_sq" in st else torch.zeros_like(p))
            if "step" in st:
                t = int(st["step"])
        return m, v, t

    # ----------------------------------------------------------- the window
    def window(self, seconds, traced):
        tf, c = self.ctx.traffic, self.ctx.config
        self._sync()
        trace = None
        steps = 0
        n0 = len(self.losses)
        at0 = self.tr.global_step
        self.syncs = []
        proc0 = time.process_time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or (traced and trace is None):
            if traced and trace is None and steps >= tf["trace_after"]:
                trace = self._traced_steps(traced, tf["trace_steps"])
                steps += tf["trace_steps"]
                continue
            self.step()
            steps += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        notes = _host_notes(self.syncs, (time.process_time() - proc0) / elapsed)
        notes.update(steps=[at0, self.tr.global_step])
        losses = torch.stack(self.losses[n0:])
        failed = int((~torch.isfinite(losses)).sum())
        metrics = {tf["metric"]: steps * c["num_rays"] / elapsed}
        return Window(metrics=metrics, attempted=steps, failed=failed, trace=trace,
                      notes=notes)

    def _traced_steps(self, traced, n):
        with traced() as tr:
            for _ in range(n):
                self.step()
        tr.counters = {"steps": n, "t0": tr.t0, "t1": tr.t0 + tr.window_s}
        return tr

    def release(self):
        """Free the program's state; the records stay for the check."""
        self.tr = None
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def check(self):
        """The program's recorded readings against the reference's."""
        rec = self.records[0]
        return compare(self.program_readings(rec),
                       self.reference_readings(rec, ref.PRECISIONS["config"]),
                       self.ctx.config, self.ctx.traffic["limits"])

    def control(self):
        """The control: the reference in the control's precision in the
        program's place, against the reference."""
        rec = self.records[0]
        return compare(self.reference_readings(rec, ref.PRECISIONS["control"]),
                       self.reference_readings(rec, ref.PRECISIONS["config"]),
                       self.ctx.config, self.ctx.traffic["limits"])

    def program_readings(self, rec):
        return {"losses": [float(st["loss"]) for st in rec["steps"]], "g1": rec["g1"],
                "params3": rec["params3"], "renders": rec["renders"]}

    def reference_readings(self, rec, prec):
        """The same readings from the reference, from the same state,
        images, pixels and draws."""
        c, arrays = self.ctx.config, self.arrays
        params0 = ref.with_leaves(self.p0, rec["p0"])
        cur = [t.detach().clone() for t in rec["p0"]]
        grads, losses, renders = [], [], []
        for st in rec["steps"]:
            d = st["draws"]
            o, dirs, radii = ref.cone_rays(arrays["poses"][st["idx"]], arrays["intrinsics"],
                                           self.H, self.W, d.rays.inds)
            px = arrays["images"][st["idx"]].reshape(self.H * self.W, -1)[d.rays.inds]
            gt = px[:, :3] * px[:, 3:] + d.bg * (1.0 - px[:, 3:])
            loss, g, ts, ws = ref.loss_and_grads(ref.with_leaves(params0, cur), o, dirs, radii,
                                                 d.jitter, d.u, d.bg, gt, c, prec)
            grads.append(g)
            losses.append(loss)
            renders.append({"t_coarse": ts[0], "w_coarse": ws[0], "t_fine": ts[1]})
            cur = ref.adam(rec["p0"], grads, c, rec["adam0"])
        return {"losses": losses, "g1": grads[0], "params3": cur, "renders": renders,
                "leaves0": rec["p0"], "draws": [st["draws"] for st in rec["steps"]]}


def compare(prog, refr, c, limits):
    """The compared numbers (see the module's docstring), each beside its
    limit."""
    checks = []

    def add(name, value):
        checks.append(Check(name, value, limits[name]))

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
    worst = 0.0
    with ref.no_tf32():
        for r, d in zip(prog["renders"], refr["draws"]):
            if r["w_coarse"].shape[0] != len(d.jitter):     # rays left out: all of it
                worst = c["far"] - c["near"]
                continue
            t_coarse = ref.coarse_edges(len(d.jitter), d.jitter, c, d.jitter.device)
            t_fine = ref.resample(t_coarse, r["w_coarse"], d.u, c)
            worst = max(worst, float((r["t_fine"] - t_fine).abs().max()))
    add("resample", worst / (c["far"] - c["near"]))
    return checks


def _leaves_copy(tr):
    return [t.detach().clone() for t in ref.leaves(tr.state.params)]
