"""One MPC tick: filter update, waypoint pop, replan and the next action.

Counterpart of nerfnav_tpu/nav/fused.py (`FusedMPC`). The reference runs
everything after the host feature front end as one jitted program per tick.
Here the tick runs eagerly in the same sequence, with no host read after the
front end: the dynamics predict, covariance propagation and conditioning,
the LM solve (its accept/reject and damping are selects), the posterior, the
divergence fallback (a torch.where, not a branch), the re-root and pop
(`active` is a host int), one replan chunk from a fresh Adam state, and the
flatness rollup to the next action. Capturing the tick in a CUDA graph is
ROADMAP D3.
"""

import torch

from nerfnav_tpu_torch.nav.math_utils import vec_to_rot_matrix
from nerfnav_tpu_torch.nav.planner import calc_everything


class FusedMPC:
    """Binds an `Estimator` (GN path) and a static-horizon `Planner`. The
    host state of both (xt, sig, iteration; states, initial_accel, active,
    start_state) is kept up to date, so their own methods keep working
    mid-mission."""

    def __init__(self, filt, traj, H: int, W: int, n_replan: int | None = None):
        if not traj.cfg.static_horizon:
            raise ValueError("FusedMPC needs PlannerConfig.static_horizon "
                             "(the pop keeps every shape)")
        if filt.cfg.optimizer != "gn":
            raise ValueError("FusedMPC fuses the GN/LM filter path")
        if traj.workspace:
            raise ValueError("FusedMPC is the headless loop; per-epoch artifacts "
                             "need the unfused Planner")
        self.filt, self.traj = filt, traj
        self.H, self.W = H, W
        self.n_replan = int(n_replan or traj.cfg.epochs_update)
        # this tick's front-end timings and LM / replan losses (None after a
        # tick without keypoints)
        self.last_timings = self.last_losses = self.last_plan_losses = None

    def cycle(self, pop: bool, xt, action, sig, pool, gt, sel, states, initial_accel,
              end_state, active: int):
        """The tick after the front end. Returns (x, sig, LM losses, start
        state, states, initial_accel, replan losses, next action)."""
        filt, traj = self.filt, self.traj
        x_pred, sig_pred_c, x, sig_post, losses = filt.gn_fused(xt, action, sig, pool, gt, sel)
        # estimate_state's divergence fallback, as a select
        ok = torch.isfinite(x).all() & torch.isfinite(losses[-1])
        x_used = torch.where(ok, x, x_pred)
        sig_used = torch.where(ok, sig_post, sig_pred_c)
        R = vec_to_rot_matrix(x_used[6:9])
        start = torch.cat([x_used[0:6], R.reshape(-1), x_used[9:12]])
        if pop:  # the vacated tail row is dead: index >= active hovers at goal
            states = torch.roll(states, -1, dims=0)
        states, initial_accel, plan_losses, _ = traj.run_epochs(
            states, initial_accel, start, end_state, self.n_replan, 0, active)
        with torch.no_grad():
            out = calc_everything(start, end_state, states, initial_accel, traj.cfg,
                                  active=active)
        return (x_used, sig_used, losses, start, states, initial_accel, plan_losses,
                out["actions"][0])

    def step(self, obs_img, action):
        """One control tick, the unfused sequence [estimate_state ->
        update_state -> learn_update -> get_next_action] in one pass.
        Returns (x_est, next action) as device tensors."""
        filt, traj = self.filt, self.traj
        if filt.xt is None:
            raise RuntimeError("call set_initial_state first")
        self.last_timings = self.last_losses = self.last_plan_losses = None
        _, _, pool, gt, t_walls = filt._front_end(obs_img)
        if pool is None:
            # a tick without features: the prior, through the unfused path
            x_est = filt.estimate_state(obs_img, None, action)
            traj.update_state(x_est)
            traj.learn_update(filt.iteration)
            return torch.as_tensor(x_est, device=filt.device), traj.get_next_action()
        pop = traj.active > 1
        active = traj.active - 1 if pop else traj.active
        action = torch.as_tensor(action, dtype=torch.float32, device=filt.device)
        (x, sig, losses, start, states, accel, plan_losses, action_next) = self.cycle(
            pop, filt.xt, action, filt.sig, pool, gt, filt.draw_sel(), traj.states,
            traj.initial_accel, traj.end_state, active)
        self.last_timings = t_walls
        filt.xt, filt.sig = x, sig
        filt.iteration += 1
        filt.last_losses = self.last_losses = losses
        traj.start_state, traj.states, traj.initial_accel = start, states, accel
        traj.active = active
        traj.epoch += self.n_replan
        self.last_plan_losses = plan_losses
        return x, action_next
