"""Quadrotor rigid-body dynamics.

Counterpart of nerfnav_tpu/nav/dynamics.py: the 12-dim state [pos, vel,
rotvec, omega] advanced one Euler step by [thrust, torque], the rotation by
the exponential map, omega_dot = J^-1 (tau - omega x J omega); `next_rotation`;
and the 18-dim open-loop `Simulator`. `drone_dynamics` is plain tensor math,
so the pose filter takes its 12x12 Jacobian with torch.func.jacfwd.
"""

from dataclasses import dataclass

import numpy as np
import torch

from nerfnav_tpu_torch.device import device_const, resolve_device
from nerfnav_tpu_torch.nav.math_utils import rot_matrix_to_vec, vec_to_rot_matrix


@dataclass(frozen=True)
class DynamicsConfig:
    mass: float = 1.0
    g: float = 10.0
    inertia: tuple = (0.01, 0.01, 0.02)  # diagonal J
    dt: float = 0.1


def drone_dynamics(state, action, cfg: DynamicsConfig):
    """One Euler step. state: (12,) [pos, vel, rotvec, omega]; action: (4,)
    [thrust, tau_x, tau_y, tau_z]. Returns the next (12,) state."""
    pos, vel, rv, omega = state[0:3], state[3:6], state[6:9], state[9:12]
    thrust, torque = action[0], action[1:]
    R = vec_to_rot_matrix(rv)
    J = torch.diag(device_const(cfg.inertia, state.device))
    e3 = device_const((0.0, 0.0, 1.0), state.device)

    accel = (thrust / cfg.mass) * (R @ e3) - cfg.g * e3
    next_pos = pos + vel * cfg.dt
    next_vel = vel + accel * cfg.dt
    next_R = R @ vec_to_rot_matrix(omega * cfg.dt)
    # solve_ex: no info check, so no host sync
    omega_dot = torch.linalg.solve_ex(J, torque - torch.linalg.cross(omega, J @ omega)).result
    next_omega = omega + omega_dot * cfg.dt
    return torch.cat([next_pos, next_vel, rot_matrix_to_vec(next_R), next_omega])


def next_rotation(R, omega, dt):
    """R_{t+1} = R_t exp(skew(omega) dt)."""
    return R @ vec_to_rot_matrix(omega * dt)


class Simulator:
    """Open-loop 18-dim rollout: state [pos(3), vel(3), R(9), omega(3)] as
    host numpy, advanced by actions through `drone_dynamics` on `device`."""

    def __init__(self, start_state, cfg: DynamicsConfig = DynamicsConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.states = [np.asarray(start_state, np.float32)]

    @property
    def state(self):
        return self.states[-1]

    def advance(self, action):
        s = torch.as_tensor(self.states[-1], device=self.device)
        rv = rot_matrix_to_vec(s[6:15].reshape(3, 3))
        x12 = torch.cat([s[0:3], s[3:6], rv, s[15:18]])
        a = torch.as_tensor(np.asarray(action, np.float32), device=self.device)
        nxt = drone_dynamics(x12, a, self.cfg)
        R_next = vec_to_rot_matrix(nxt[6:9])
        s18 = torch.cat([nxt[0:6], R_next.reshape(-1), nxt[9:12]]).cpu().numpy()
        self.states.append(s18.astype(np.float32))
        return s18

    def body_to_world(self, points):
        """(N, 3) body points -> world at the current state."""
        s = self.states[-1]
        R = s[6:15].reshape(3, 3)
        return points @ R.T + s[0:3]
