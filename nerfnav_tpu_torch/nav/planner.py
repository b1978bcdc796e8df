"""Trajectory planner: A*-seeded differential-flatness optimization through
the NeRF density.

Counterpart of nerfnav_tpu/nav/planner.py. Decision variables are T interior
waypoints [pos, yaw] and `initial_accel` (2,), which ties the first two steps
to the start state. `calc_everything` rolls the waypoints up into full
rigid-body states and actions (body z from the required acceleration, x from
the yaw heading, omega from the SO(3) log of R_t^T R_{t+1} / dt, torques
J alpha + omega x J omega, thrust m |accel - g|); the cost is control effort
plus the density met by a 10x10x5 body cloud swept along the trajectory.
`a_star_init` seeds the waypoints from A* on a max-pooled density grid, and
`learn_init` / `learn_update` run Adam with gradient clipping.

The reference's `lax.scan` chunk is a loop of eager epochs here: loss,
backward, optax's clip_by_global_norm(10) and Adam (nav/optim.py) on the
two tensors, with every loss kept on the device until the chunk ends.
The static-horizon MPC mode's `active` waypoint count is a host int, known
without reading the device.
"""

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const, resolve_device
from nerfnav_tpu_torch.models.renderer import linspace
from nerfnav_tpu_torch.nav.astar import astar
from nerfnav_tpu_torch.nav.dynamics import next_rotation
from nerfnav_tpu_torch.nav.math_utils import rot_matrix_to_vec, vec_to_rot_matrix
from nerfnav_tpu_torch.nav.optim import adam_init, adam_update, clip_by_global_norm


@dataclass(frozen=True)
class PlannerConfig:
    T: int = 20                      # steps in the horizon
    dt: float = 0.1
    mass: float = 1.0
    g: float = 10.0
    inertia: tuple = (0.01, 0.01, 0.02)
    body_extent: tuple = ((-0.05, 0.05), (-0.05, 0.05), (-0.02, 0.02))
    body_nbins: tuple = (10, 10, 5)  # 10x10x5 body cloud
    lr: float = 1e-3
    epochs_init: int = 2500
    epochs_update: int = 250
    fade_out_epoch: int = 0
    fade_out_sharpness: float = 10.0
    bound: float = 1.0               # planning volume [-bound, bound]^3
    astar_fine: int = 100            # density sample resolution
    astar_coarse: int = 20           # after max-pooling
    astar_thresh: float = 0.3
    w_thrust: float = 1000.0 / 1e6
    w_torque: float = 0.01 / 1e6
    w_collision: float = 1.0
    save_every: int = 50
    # True keeps every array at T and masks past the live waypoint count
    # `active`; False pops and shrinks T as the reference does
    static_horizon: bool = True


def _safe_norm(v, dim=-1, keepdim=False, eps=1e-12):
    """Norm with a finite gradient at 0 (the trajectory starts and ends at
    exactly zero velocity)."""
    return torch.sqrt((v * v).sum(dim=dim, keepdim=keepdim) + eps)


def body_points(cfg: PlannerConfig, device="cpu"):
    """The robot's body point cloud (B, 3) in the body frame."""
    axes = [np.linspace(lo, hi, n) for (lo, hi), n in zip(cfg.body_extent, cfg.body_nbins)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return torch.as_tensor(grid, dtype=torch.float32, device=device)


def calc_everything(start_state, end_state, states, initial_accel, cfg: PlannerConfig,
                    active=None):
    """Differential flatness: waypoints [pos, yaw] -> full rigid-body states.

    start_state/end_state: (18,) [pos, vel, R.flatten(), omega]; states
    (T, 4); initial_accel (2,). Returns pos (T+5, 3), vel (T+5, 3), accel
    (T+4, 3), rot (T+4, 3, 3), omega (T+3, 3), actions (T+2, 4).

    active: the static horizon's live waypoint count (an int). Rows of
    `states` from `active` on hover at the goal (pos = end_pos, vel = end_v)
    and the terminal-velocity constraint moves to step 4 + active; with
    active == T (or None) this is the full-horizon rollup."""
    dev, dt, m = states.device, cfg.dt, cfg.mass
    e3 = device_const((0.0, 0.0, 1.0), dev)
    g_vec = -cfg.g * e3
    start_pos, start_v = start_state[0:3], start_state[3:6]
    start_R = start_state[6:15].reshape(3, 3)
    start_omega = start_state[15:18]
    end_pos, end_v = end_state[0:3], end_state[3:6]

    # the first two accelerations act along the known body z of R0 and R1
    # with the free magnitudes initial_accel; the first positions follow
    R1 = next_rotation(start_R, start_omega, dt)
    a0 = (start_R @ e3) * initial_accel[0] + g_vec
    a1 = (R1 @ e3) * initial_accel[1] + g_vec
    p0 = start_pos
    p1 = p0 + start_v * dt
    p2 = p1 + (start_v + a0 * dt) * dt
    p3 = p2 + (start_v + (a0 + a1) * dt) * dt

    if active is None:
        wpos, wyaw = states[:, :3], states[:, 3]
    else:
        w_mask = torch.arange(states.shape[0], device=dev) < active
        wpos = torch.where(w_mask[:, None], states[:, :3], end_pos[None])
        wyaw = torch.where(w_mask, states[:, 3], 0.0)
    pos = torch.cat([torch.stack([p0, p1, p2, p3]), wpos, end_pos[None]], dim=0)

    vel_fd = torch.cat([(pos[1:] - pos[:-1]) / dt, end_v[None]], dim=0)
    if active is None:
        vel = vel_fd
    else:
        seq = torch.arange(vel_fd.shape[0], device=dev)
        vel = torch.where((seq < 4 + active)[:, None], vel_fd, end_v[None])

    accel = (vel[1:] - vel[:-1]) / dt
    needed = accel - g_vec[None]
    thrust = m * _safe_norm(needed)

    z_b = needed / _safe_norm(needed, keepdim=True, eps=1e-8)
    yaw = torch.cat([torch.zeros(3, device=dev), wyaw, torch.zeros(1, device=dev)])
    heading = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
    y_b = torch.linalg.cross(z_b, heading)
    y_b = y_b / _safe_norm(y_b, keepdim=True, eps=1e-8)
    x_b = torch.linalg.cross(y_b, z_b)
    rot = torch.stack([x_b, y_b, z_b], dim=-1)
    rot = torch.cat([start_R[None], R1[None], rot[2:]], dim=0)

    rel = torch.einsum("sij,sik->sjk", rot[:-1], rot[1:])  # R_t^T R_{t+1}
    omega = rot_matrix_to_vec(rel) / dt
    alpha = (omega[1:] - omega[:-1]) / dt
    J = torch.diag(device_const(cfg.inertia, dev))
    torques = alpha @ J.T + torch.linalg.cross(omega[:-1], omega[:-1] @ J.T)
    actions = torch.cat([thrust[: torques.shape[0], None], torques], dim=-1)
    return {"pos": pos, "vel": vel, "accel": accel, "rot": rot, "omega": omega,
            "actions": actions}


def total_cost(start_state, end_state, states, initial_accel, density_fn,
               cfg: PlannerConfig, body, fade_mask=None, active=None):
    """Control effort plus the body cloud's density along the trajectory.

    With `active`, cost rows past the arrival step are masked and the mean
    is over the active step count. Returns (loss, calc_everything output)."""
    out = calc_everything(start_state, end_state, states, initial_accel, cfg, active=active)
    dev = states.device
    # thrust over all T+4 intervals: the tail without torque still pays it
    fz_all = cfg.mass * _safe_norm(out["accel"] - device_const((0.0, 0.0, -cfg.g), dev))
    torque2 = (out["actions"][:, 1:] ** 2).sum(dim=-1)
    s_all = fz_all.shape[0]
    nt = torque2.shape[0]
    if active is not None:
        torque2 = torch.where(torch.arange(nt, device=dev) < active + 2, torque2, 0.0)
    control = cfg.w_thrust * fz_all**2
    control = torch.cat([control[:nt] + cfg.w_torque * torque2**2, control[nt:]])

    S = out["rot"].shape[0]
    world = torch.einsum("sij,bj->sbi", out["rot"], body) + out["pos"][:S, None, :]
    sigma = density_fn(world.reshape(-1, 3)).reshape(S, -1)
    speed = _safe_norm(out["vel"][:S])
    collision = cfg.w_collision * sigma.mean(dim=-1) * speed

    per_step = control + collision[:s_all]
    if fade_mask is not None:
        per_step = per_step * fade_mask[: per_step.shape[0]]
    if active is None:
        return per_step.mean(), out
    live = (torch.arange(s_all, device=dev) < active + 4).to(per_step.dtype)
    return (per_step * live).sum() / (active + 4), out


class Planner:
    def __init__(self, start_state, end_state, cfg: PlannerConfig, density_fn,
                 workspace: str | None = None, exp_name: str = "plan", device="cuda"):
        """density_fn: (N, 3) tensor -> (N,) density, on `device`."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.density_fn = density_fn
        self.start_state = torch.as_tensor(np.asarray(start_state, np.float32), device=self.device)
        self.end_state = torch.as_tensor(np.asarray(end_state, np.float32), device=self.device)
        self.body = body_points(cfg, self.device)
        self.workspace = workspace
        self.exp_name = exp_name
        if workspace:
            for sub in ("init_poses", "init_costs", "replan_poses", "replan_costs"):
                os.makedirs(os.path.join(workspace, sub, exp_name), exist_ok=True)
        # straight-line waypoints until a_star_init replaces them
        alphas = linspace(0.0, 1.0, cfg.T + 2, self.device)[1:-1, None]
        pos = self.start_state[None, 0:3] * (1 - alphas) + self.end_state[None, 0:3] * alphas
        self.states = torch.cat([pos, torch.zeros((cfg.T, 1), device=self.device)], dim=-1)
        self.initial_accel = device_const((cfg.g, cfg.g), self.device).clone()
        self.epoch = 0
        self.active = cfg.T  # live waypoints (static horizon)

    def _active_arg(self):
        """`active` for the planner math: None in legacy mode, whose arrays
        hold exactly the live horizon."""
        return self.active if self.cfg.static_horizon else None

    # ----------------------------------------------------------------- A*
    def a_star_init(self):
        """Density on an astar_fine^3 lattice, max-pooled to astar_coarse^3,
        thresholded, A* from the start cell to the goal cell, and the path
        resampled to T waypoints. Returns the cell path."""
        cfg = self.cfg
        n, c = cfg.astar_fine, cfg.astar_coarse
        lin = np.linspace(-cfg.bound, cfg.bound, n)
        grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
        with torch.no_grad():
            sigma = self.density_fn(torch.as_tensor(grid, dtype=torch.float32,
                                                    device=self.device))
        sigma = sigma.float().cpu().numpy().reshape(n, n, n)
        k = n // c
        occupied = sigma.reshape(c, k, c, k, c, k).max(axis=(1, 3, 5)) > cfg.astar_thresh

        def to_cell(p):
            cell = ((np.asarray(p) + cfg.bound) / (2 * cfg.bound) * c).astype(int)
            return tuple(np.clip(cell, 0, c - 1))

        def to_world(cell):
            return (np.asarray(cell) + 0.5) / c * 2 * cfg.bound - cfg.bound

        start = to_cell(self.start_state[0:3].cpu().numpy())
        goal = to_cell(self.end_state[0:3].cpu().numpy())
        # the robot is at its endpoints by definition
        occupied[start] = False
        occupied[goal] = False
        path = astar(occupied, start, goal)
        if path is None:
            raise RuntimeError("A* found no path between start and goal")
        pts = np.stack([to_world(cl) for cl in path])
        dists = np.concatenate([[0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=-1))])
        total = max(dists[-1], 1e-6)
        targets = np.linspace(0, total, cfg.T + 2)[1:-1]
        wp = np.stack([np.interp(targets, dists, pts[:, i]) for i in range(3)], -1)
        self.states = torch.cat([torch.as_tensor(wp, dtype=torch.float32, device=self.device),
                                 torch.zeros((cfg.T, 1), device=self.device)], dim=-1)
        return path

    # ------------------------------------------------------------ learning
    def _fade_masks(self, n, ep0, live_t):
        """(n, T+4) progressive collision fade-in per epoch, or None when
        fading is off. The front sweeps the live step count live_t."""
        cfg = self.cfg
        if cfg.fade_out_epoch <= 0:
            return None
        ep = ep0 + np.arange(n, dtype=np.float32)
        progress = np.minimum(ep / np.float32(cfg.fade_out_epoch), np.float32(1.0))
        progress = torch.as_tensor(progress * np.float32(live_t), device=self.device)
        steps = torch.arange(cfg.T + 4, device=self.device)
        return torch.sigmoid((progress[:, None] - steps) * cfg.fade_out_sharpness)

    def run_epochs(self, states, initial_accel, start_state, end_state, n: int, ep0: int,
                   active: int, opt=None):
        """n epochs of clipped Adam, the counterpart of one jitted scan
        chunk. opt: the Adam state (count, mu, nu) a previous chunk returned,
        or None for a fresh one. Returns (states, initial_accel, losses (n,)
        on the device, opt); reads nothing back to the host."""
        cfg = self.cfg
        use_active = cfg.static_horizon
        fade = self._fade_masks(n, ep0, (active + 4) if use_active else (cfg.T + 4))
        # optax's leaf order: the params dict's sorted keys
        params = [initial_accel.detach().clone(), states.detach().clone()]
        opt = adam_init(params) if opt is None else opt
        losses = []
        for i in range(n):
            for p in params:
                p.requires_grad_(True)
            loss, _ = total_cost(start_state, end_state, params[1], params[0], self.density_fn,
                                 cfg, self.body, None if fade is None else fade[i],
                                 active=active if use_active else None)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                params, opt = adam_update([p.detach() for p in params],
                                          clip_by_global_norm(grads, 10.0), opt, cfg.lr)
            losses.append(loss.detach())
        return params[1], params[0], torch.stack(losses), opt

    def _learn(self, epochs: int, tag: str):
        losses = []
        # artifacts land on epochs 0, save_every, 2 save_every, ...; a
        # headless solve runs as one chunk
        chunk = max(1, min(self.cfg.save_every, epochs)) if self.workspace else epochs
        states, accel, opt = self.states, self.initial_accel, None
        try:
            ep = 0
            while ep < epochs:
                n = 1 if ep == 0 and self.workspace else min(chunk, epochs - ep)
                states, accel, chunk_losses, opt = self.run_epochs(
                    states, accel, self.start_state, self.end_state, n, ep, self.active, opt)
                losses.extend(chunk_losses.double().cpu().tolist())
                ep += n
                self.epoch += n
                if self.workspace:
                    self._save_artifacts(tag, ep - 1, states, accel, losses[-1])
        except KeyboardInterrupt:
            pass  # an early stop keeps the current solution
        self.states, self.initial_accel = states, accel
        return losses

    def learn_init(self):
        """The initial solve, cfg.epochs_init epochs."""
        return self._learn(self.cfg.epochs_init, "init")

    def learn_update(self, iteration: int = 0):
        """A replan, cfg.epochs_update epochs."""
        return self._learn(self.cfg.epochs_update, f"replan_{iteration}")

    # ----------------------------------------------------------------- MPC
    def update_state(self, est_state):
        """Re-root at a state estimate ((12,) or (18,)) and pop the reached
        waypoint."""
        est_state = torch.as_tensor(est_state, dtype=torch.float32, device=self.device)
        if est_state.shape[0] == 12:
            R = vec_to_rot_matrix(est_state[6:9])
            est_state = torch.cat([est_state[0:6], R.reshape(-1), est_state[9:12]])
        self.start_state = est_state
        if self.cfg.static_horizon:
            if self.active > 1:
                # the vacated tail row is dead: index >= active hovers at goal
                self.states = torch.roll(self.states, -1, dims=0)
                self.active -= 1
        elif self.states.shape[0] > 1:
            self.states = self.states[1:]
            self.cfg = dataclasses.replace(self.cfg, T=self.cfg.T - 1)

    def get_next_action(self):
        out = calc_everything(self.start_state, self.end_state, self.states,
                              self.initial_accel, self.cfg, active=self._active_arg())
        return out["actions"][0]

    def get_full_states(self):
        """The full rollup; in static-horizon mode cut to the live rows."""
        out = calc_everything(self.start_state, self.end_state, self.states,
                              self.initial_accel, self.cfg, active=self._active_arg())
        if self.cfg.static_horizon and self.active < self.cfg.T:
            out = self._trim(out)
        return out

    def _trim(self, out):
        """Cut the hover-at-goal rows: live lengths are pos a+5, vel a+5,
        accel/rot a+4, omega a+3, actions a+2 (a = active waypoints)."""
        a = self.active
        keep = {"pos": a + 5, "vel": a + 5, "accel": a + 4, "rot": a + 4,
                "omega": a + 3, "actions": a + 2}
        return {k: (v[: keep[k]] if k in keep else v) for k, v in out.items()}

    # ------------------------------------------------------------ artifacts
    def _save_artifacts(self, tag, ep, states, initial_accel, loss):
        """JSON pose and cost dumps."""
        with torch.no_grad():
            out = calc_everything(self.start_state, self.end_state, states, initial_accel,
                                  self.cfg, active=self._active_arg())
        if self.cfg.static_horizon and self.active < self.cfg.T:
            out = self._trim(out)
        kind = "init" if tag == "init" else "replan"
        pose_dir = os.path.join(self.workspace, f"{kind}_poses", self.exp_name)
        cost_dir = os.path.join(self.workspace, f"{kind}_costs", self.exp_name)
        rot = out["rot"].cpu().numpy()
        pos = out["pos"][: rot.shape[0]].cpu().numpy()
        poses = np.concatenate([rot, pos[:, :, None]], axis=-1).tolist()
        with open(os.path.join(pose_dir, f"{tag}_{ep}.json"), "w") as f:
            json.dump({"poses": poses}, f)
        with open(os.path.join(cost_dir, f"{tag}_{ep}.json"), "w") as f:
            json.dump({"loss": loss}, f)

    def save_progress(self, path):
        """The planner's state as an .npz (the JAX package's format)."""
        np.savez(path, states=self.states.detach().cpu().numpy(),
                 initial_accel=self.initial_accel.detach().cpu().numpy(),
                 start_state=self.start_state.cpu().numpy(),
                 end_state=self.end_state.cpu().numpy(), active=np.asarray(self.active))

    def load_progress(self, path):
        """Restore a save_progress file of either package and either horizon
        mode: a static-horizon file's dead tail rows past `active` are
        dropped for a legacy planner, a legacy file is padded to T for a
        static one."""
        data = np.load(path)
        dev = self.device
        states = torch.as_tensor(data["states"], device=dev)
        active = int(data["active"]) if "active" in data else states.shape[0]
        active = min(active, states.shape[0])
        self.initial_accel = torch.as_tensor(data["initial_accel"], device=dev)
        self.start_state = torch.as_tensor(data["start_state"], device=dev)
        self.end_state = torch.as_tensor(data["end_state"], device=dev)
        if self.cfg.static_horizon:
            T = self.cfg.T
            if active > T:
                raise ValueError(
                    f"progress file has {active} live waypoints but this planner's "
                    f"static horizon is T={T}; construct the Planner with cfg.T >= "
                    f"{active} to load it")
            if states.shape[0] > T:
                states = states[:T]  # dead static-file tail rows
            elif states.shape[0] < T:  # legacy file: pad dead (masked) rows
                states = torch.cat([states, states[-1:].expand(T - states.shape[0], -1)])
            self.states = states
            self.active = active
        else:
            states = states[:active]  # drop dead static-file tail rows
            if states.shape[0] != self.cfg.T:
                self.cfg = dataclasses.replace(self.cfg, T=states.shape[0])
            self.states = states
            self.active = states.shape[0]
