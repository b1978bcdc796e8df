"""6-DoF optimization-based pose filter.

Counterpart of nerfnav_tpu/nav/estimator.py. Each update predicts the
12-dim state through the dynamics (Jacobian by torch.func.jacfwd),
propagates the covariance, and fits the state to the observed pixels in the
interest regions around keypoints: rendered-vs-observed mse plus the
Mahalanobis prior. Two solvers share the objective:

- "gn" (default): Levenberg-Marquardt. J comes from torch.func.jacfwd of the
  residuals of a fixed Jacobian subset of the rays (12 forward tangents
  through the renderer, batched by vmap); accept/reject is evaluated on the
  full batch, and the accept test and the damping update are torch.where
  selects, so the solve reads nothing back to the host. The Gauss-Newton
  matrix 2 J^T J gives the posterior covariance.
- "adam": the reference's first-order descent, cfg.n_iters steps, with the
  posterior from the measurement Hessian (torch.func.hessian).

The reference draws each update's pixel batch from a PRNG key; here the
draws (`sel`, indices into the interest-pixel pool) come from a
torch.Generator on the device and are passed into the solve, so a test can
inject the JAX draws. The feature front end (keypoints, interest mask,
pixel pool) runs on the host; `find_poi` imports cv2 when called, and the
mask dilation is scipy's. With a workspace, each update writes its state and
errors as JSON and, with `render_viz`, the triptych of nav/viz.py (the
observation, the keypoints and the render at the posterior pose) as
estimator_data/viz_NNNN.png.
"""

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import hessian, jacfwd

from nerfnav_tpu_torch.device import resolve_device
from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig, drone_dynamics
from nerfnav_tpu_torch.nav.math_utils import calc_se3_err, nearest_pd
from nerfnav_tpu_torch.nav.optim import adam_init, adam_update


def find_poi(img_uint8: np.ndarray, max_features: int = 100, backend: str = "sift",
             downscale: int = 1):
    """Keypoint pixel coords (M, 2) int32 [x, y]; Shi-Tomasi corners are
    added when the detector finds fewer than 8. backend: "sift" | "orb" |
    "corners"; downscale: detect on a strided subsample and scale back."""
    import cv2

    s = max(1, int(downscale))
    gray = cv2.cvtColor(img_uint8[::s, ::s], cv2.COLOR_RGB2GRAY)
    xy = np.zeros((0, 2), np.float32)
    try:
        if backend == "orb":
            kps = cv2.ORB_create(nfeatures=max_features * 2).detect(gray, None)
        elif backend == "corners":
            kps = []
        else:
            kps = cv2.SIFT_create().detect(gray, None)
        xy = np.array([kp.pt for kp in kps], dtype=np.float32).reshape(-1, 2)
    except cv2.error:
        pass
    if len(xy) < 8:
        corners = cv2.goodFeaturesToTrack(gray, max_features, 0.01, 8)
        if corners is not None:
            xy = np.concatenate([xy, corners.reshape(-1, 2)], axis=0)
    xy = np.unique((xy * s).astype(np.int32), axis=0)
    if len(xy) > max_features:
        xy = xy[np.random.default_rng(0).choice(len(xy), max_features, replace=False)]
    return xy


def interest_region_mask(hw, poi_xy, kernel_size=5, dil_iter=3):
    """(H, W) bool: a kernel_size square at each keypoint, dilated dil_iter
    times by a kernel_size square (zero border), as cv2.dilate does."""
    from scipy.ndimage import binary_dilation

    H, W = hw
    mask = np.zeros((H, W), bool)
    half = kernel_size // 2
    for x, y in poi_xy:
        mask[max(y - half, 0) : y + half + 1, max(x - half, 0) : x + half + 1] = True
    if not mask.any():
        return mask
    return binary_dilation(mask, structure=np.ones((kernel_size, kernel_size), bool),
                           iterations=dil_iter, border_value=0)


@dataclass
class EstimatorConfig:
    lr: float = 1e-3
    n_iters: int = 300            # Adam steps
    batch_size: int = 1024
    optimizer: str = "gn"         # "gn" (Levenberg-Marquardt) | "adam"
    gn_iters: int = 15
    lm_lambda0: float = 1e-2
    gn_jac_batch: int = 256       # rays of the batch that J is built from
    kernel_size: int = 5
    dilate_iter: int = 3
    poi_backend: str = "sift"
    poi_downscale: int = 1
    pool_size: int = 16384        # fixed-size interest-pixel pool
    sig0: float = 1.0
    q_diag: float = 1e-4
    measurement_weight: float = 1e3
    sig_max_eig: float = 1e3
    hess_reg: float = 1e-6
    render_viz: bool = False      # a triptych per update (nav/viz.py; matplotlib)


class Estimator:
    def __init__(self, cfg: EstimatorConfig, dyn_cfg: DynamicsConfig, render_fn, get_rays_fn,
                 state_to_pose, workspace: str | None = None, get_rays_at_fn=None,
                 march_fn=None, render_frozen_fn=None, device="cuda", seed: int = 0):
        """render_fn(rays_o, rays_d) -> {"image": (N, 3)}; get_rays_fn(pose
        4x4) -> {"rays_o", "rays_d"} (H*W, 3); state_to_pose(x12) -> (4, 4)
        camera-to-world; get_rays_at_fn(pose, flat pixel inds) -> rays at
        those pixels only. march_fn + render_frozen_fn (GN only, with
        get_rays_at_fn): march once per update at the predicted pose, then
        shade that fixed (z, dt, valid) lattice every LM iteration.
        The closures run on `device`; `seed` seeds the pixel draws."""
        self.cfg = cfg
        self.dyn_cfg = dyn_cfg
        self.device = resolve_device(device)
        self.render_fn = render_fn
        self.get_rays_fn = get_rays_fn
        self.get_rays_at_fn = get_rays_at_fn
        self.march_fn = march_fn
        self.render_frozen_fn = render_frozen_fn
        if (march_fn is not None) != (render_frozen_fn is not None):
            raise ValueError("frozen-march mode needs BOTH march_fn and render_frozen_fn")
        if march_fn is not None and get_rays_at_fn is None:
            raise ValueError("frozen-march mode requires get_rays_at_fn")
        if march_fn is not None and cfg.optimizer != "gn":
            raise ValueError("frozen-march mode is a GN/LM-path feature "
                             "(the Adam path resamples pixels per iteration)")
        self.state_to_pose = state_to_pose
        self.workspace = workspace
        if workspace:
            os.makedirs(os.path.join(workspace, "estimator_data"), exist_ok=True)
        self.xt = None  # (12,) current estimate, on the device
        self.sig = torch.eye(12, device=self.device) * cfg.sig0
        self.Q = torch.eye(12, device=self.device) * cfg.q_diag
        self.iteration = 0
        self.last_timings = None
        self.last_losses = None  # this update's LM losses (None without an LM solve)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _predict(self, x, action):
        """(f(x), df/dx) of the dynamics step."""
        dyn = self.dyn_cfg

        def f(s):
            y = drone_dynamics(s, action, dyn)
            return y, y

        A, x_pred = jacfwd(f, has_aux=True)(x)
        return x_pred, A

    def _condition(self, sig):
        """Host nearest-PD projection with eigenvalues clipped to
        [1e-9, sig_max_eig], so one degenerate update cannot destabilize the
        later predictions. Returns a float32 tensor on the device."""
        sig = nearest_pd(np.asarray(sig))
        w, Q = np.linalg.eigh(sig)
        w = np.clip(w, 1e-9, self.cfg.sig_max_eig)
        return torch.as_tensor(((Q * w) @ Q.T).astype(np.float32), device=self.device)

    def set_initial_state(self, x0):
        self.xt = torch.as_tensor(np.asarray(x0, np.float32), device=self.device)

    def draw_sel(self, n_draws=None):
        """Indices into the pixel pool, uniform over its cfg.pool_size
        slots: (batch_size,), or (n_draws, batch_size)."""
        shape = (self.cfg.batch_size,) if n_draws is None else (n_draws, self.cfg.batch_size)
        return torch.randint(0, self.cfg.pool_size, shape, generator=self.gen,
                             device=self.device)

    # ------------------------------------------------------------- internals
    def _rays(self, pose, inds):
        if self.get_rays_at_fn is not None:
            rays = self.get_rays_at_fn(pose, inds)
            return rays["rays_o"], rays["rays_d"]
        rays = self.get_rays_fn(pose)
        return rays["rays_o"][inds], rays["rays_d"][inds]

    def measurement_loss(self, x, pool_inds, gt_pixels, x_pred, sig_inv, sel):
        """measurement_weight * mse(render, observed) + the Mahalanobis
        prior (x - x_pred)^T sig_inv (x - x_pred), on the pool pixels sel."""
        ro, rd = self._rays(self.state_to_pose(x), pool_inds[sel])
        mse = ((self.render_fn(ro, rd)["image"] - gt_pixels[sel]) ** 2).mean()
        d = x - x_pred
        return self.cfg.measurement_weight * mse + d @ sig_inv @ d

    def opt_run(self, x, opt_state, pool_inds, gt_pixels, x_pred, sig_inv, sels):
        """cfg.n_iters Adam steps, step i on the draws sels[i]. opt_state:
        (count, mu, nu) or None for a fresh one. Returns (x, opt_state,
        losses (n_iters,))."""
        opt_state = adam_init([x]) if opt_state is None else opt_state
        losses = []
        for i in range(self.cfg.n_iters):
            xg = x.detach().requires_grad_(True)
            loss = self.measurement_loss(xg, pool_inds, gt_pixels, x_pred, sig_inv, sels[i])
            (grad,) = torch.autograd.grad(loss, [xg])
            with torch.no_grad():
                (x,), opt_state = adam_update([x.detach()], [grad], opt_state, self.cfg.lr)
            losses.append(loss.detach())
        return x, opt_state, torch.stack(losses)

    def hess_fn(self, x, pool_inds, gt_pixels, x_pred, sig_inv, sel):
        """The 12x12 Hessian of measurement_loss at x (forward over reverse)."""
        return hessian(self.measurement_loss)(x, pool_inds, gt_pixels, x_pred, sig_inv, sel)

    def residuals_of(self, x, inds, gt, x_pred, sig_chol, frozen_zdv=None):
        """Residuals r with sum(r^2) == measurement_loss: photometric rows
        scaled so their square-sum is measurement_weight * mse, then the
        whitened prior rows sig_chol^T (x - x_pred), sig_inv = C C^T.
        frozen_zdv: (z, dt, valid) marched at the predicted pose, or None."""
        ro, rd = self._rays(self.state_to_pose(x), inds)
        if frozen_zdv is not None:
            out = self.render_frozen_fn(ro, rd, *frozen_zdv)
        else:
            out = self.render_fn(ro, rd)
        scale = float(np.sqrt(np.float32(self.cfg.measurement_weight / (gt.shape[0] * 3.0))))
        r_photo = ((out["image"] - gt) * scale).reshape(-1)
        return torch.cat([r_photo, sig_chol.T @ (x - x_pred)])

    def gn_core(self, x0, pool_inds, gt_pixels, x_pred, sig_chol, sel):
        """Levenberg-Marquardt on the residuals of the pool pixels sel
        (fixed for the whole solve): per iteration J^T from jacfwd on the
        first gn_jac_batch rays, (J^T J + lam I) delta = -J^T r, accept when
        the full batch's loss falls and x stays finite, lam halves on accept
        and quadruples on reject. Returns (x, losses (gn_iters,), 2 J^T J)."""
        cfg = self.cfg
        inds, gt = pool_inds[sel], gt_pixels[sel]
        bj = min(cfg.gn_jac_batch, cfg.batch_size)
        inds_j, gt_j = inds[:bj], gt[:bj]
        zdv = zdv_j = None
        if self.march_fn is not None:
            # one march at the predicted pose (x0 == x_pred); the lattice
            # is a constant of the solve and of the linearization
            with torch.no_grad():
                ro, rd = self._rays(self.state_to_pose(x0), inds)
                m = self.march_fn(ro, rd)
            zdv = (m["z"].detach(), m["dt"].detach(), m["valid"])
            zdv_j = tuple(a[:bj] for a in zdv)

        def full_loss(x):
            with torch.no_grad():
                return (self.residuals_of(x, inds, gt, x_pred, sig_chol, zdv) ** 2).sum()

        def jac_rows(x):
            def f(v):
                r = self.residuals_of(v, inds_j, gt_j, x_pred, sig_chol, zdv_j)
                return r, r

            with torch.no_grad():
                J, r = jacfwd(f, has_aux=True)(x)
            return r, J.T  # (m_j,), (12, m_j)

        eye = torch.eye(12, device=x0.device)
        x = x0
        lam = torch.full((), cfg.lm_lambda0, device=x0.device)
        f0 = full_loss(x0)
        losses = []
        for _ in range(cfg.gn_iters):
            r_j, Jt = jac_rows(x)
            g = Jt @ r_j
            delta = torch.linalg.solve_ex(Jt @ Jt.T + lam * eye, -g).result
            x_new = x + delta
            f1 = full_loss(x_new)
            accept = (f1 < f0) & torch.isfinite(x_new).all()
            x = torch.where(accept, x_new, x)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 4.0, max=1e7))
            f0 = torch.where(accept, f1, f0)
            losses.append(f0)
        _, Jt = jac_rows(x)
        return x, torch.stack(losses), 2.0 * (Jt @ Jt.T)

    def gn_fused(self, xt, action, sig, pool_inds, gt_pixels, sel):
        """The whole GN filter update after the front end: predict and its
        Jacobian, covariance propagation, eigenvalue-clipped conditioning,
        the LM solve and the posterior from the GN information matrix.
        Returns (x_pred, sig_pred conditioned, x_post, sig_post, losses); the
        caller falls back to the prediction when the solve diverged."""
        cfg = self.cfg
        x_pred, A = self._predict(xt, action)
        sig_pred = A @ sig @ A.T + self.Q
        w, V = torch.linalg.eigh(0.5 * (sig_pred + sig_pred.T))
        w = torch.clamp(w, 1e-9, cfg.sig_max_eig)
        sig_pred_c = (V * w) @ V.T
        sig_chol = V * torch.rsqrt(w)  # sig_inv = C C^T
        x, losses, JtJ2 = self.gn_core(x_pred, pool_inds, gt_pixels, x_pred, sig_chol, sel)
        Hs = JtJ2 + cfg.hess_reg * torch.eye(12, device=xt.device)
        w2, V2 = torch.linalg.eigh(0.5 * (Hs + Hs.T))
        inv_w = torch.clamp(1.0 / torch.clamp(w2, min=1e-12), 1e-9, cfg.sig_max_eig)
        sig_post = (V2 * inv_w) @ V2.T
        return x_pred, sig_pred_c, x, sig_post, losses

    def render_from_pose(self, pose, H, W, chunk=4096):
        """Full-frame render at a pose, (H, W, 3) numpy."""
        rays = self.get_rays_fn(torch.as_tensor(np.asarray(pose, np.float32),
                                                device=self.device))
        ro, rd = rays["rays_o"], rays["rays_d"]
        with torch.no_grad():
            outs = [self.render_fn(ro[i : i + chunk], rd[i : i + chunk])["image"]
                    for i in range(0, ro.shape[0], chunk)]
        return torch.cat(outs).cpu().numpy().reshape(H, W, 3)

    # ------------------------------------------------------------ public API
    def _front_end(self, obs_img):
        """Host front end: image dtype handling, keypoints, interest mask and
        the fixed-size pixel pool (wrapped when short). Returns (img_f, poi,
        rays_pool, gt_pixels, t_walls); rays_pool and gt_pixels are None
        when fewer than 3 keypoints are found."""
        t_walls = {}
        t0 = time.perf_counter()
        H, W = obs_img.shape[:2]
        if obs_img.dtype == np.uint8:
            img_u8 = np.asarray(obs_img)
            img_f = img_u8.astype(np.float32) / 255.0
        else:
            img_f = np.asarray(obs_img, np.float32)
            img_u8 = (np.clip(img_f, 0, 1) * 255).astype(np.uint8)
        t_walls["img_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        poi = find_poi(img_u8, backend=self.cfg.poi_backend, downscale=self.cfg.poi_downscale)
        t_walls["poi_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if len(poi) < 3:
            return img_f, poi, None, None, t_walls
        mask = interest_region_mask((H, W), poi, self.cfg.kernel_size, self.cfg.dilate_iter)
        flat = np.flatnonzero(mask.reshape(-1))
        pool_count = min(len(flat), self.cfg.pool_size)
        pool = np.zeros(self.cfg.pool_size, np.int64)
        pool[:pool_count] = flat[:pool_count]
        if pool_count < self.cfg.pool_size:  # pad by wrapping
            pool[pool_count:] = flat[np.arange(self.cfg.pool_size - pool_count) % len(flat)]
        gt_pixels = torch.as_tensor(img_f.reshape(-1, 3)[pool], device=self.device)
        rays_pool = torch.as_tensor(pool, device=self.device)
        t_walls["mask_pool_ms"] = (time.perf_counter() - t0) * 1e3
        return img_f, poi, rays_pool, gt_pixels, t_walls

    def estimate_state(self, obs_img, obs_pose_gt, action):
        """One filter step. obs_img: (H, W, 3) float in [0, 1] or uint8;
        obs_pose_gt: (4, 4) true camera pose (for the error report) or None;
        action: (4,) applied control. Returns the posterior 12-dim state as
        numpy."""
        if self.xt is None:
            raise RuntimeError("call set_initial_state first")
        action = torch.as_tensor(np.asarray(action, np.float32), device=self.device)
        self.last_losses = None
        img_f, poi, rays_pool, gt_pixels, t_walls = self._front_end(obs_img)
        if rays_pool is None:
            # no features: the prediction is the estimate
            x_pred, A = self._predict(self.xt, action)
            self.xt = x_pred
            self.sig = self._condition((A @ self.sig @ A.T + self.Q).cpu().numpy())
            self.iteration += 1
            return self.xt.cpu().numpy()
        t0 = time.perf_counter()
        if self.cfg.optimizer == "gn":
            x_pred, sig_pred_c, x, sig_post, losses = self.gn_fused(
                self.xt, action, self.sig, rays_pool, gt_pixels, self.draw_sel())
            loss = losses[-1]
            self.last_losses = losses
            # the same predicate FusedMPC selects on
            if not bool(torch.isfinite(x).all() & torch.isfinite(loss)):
                self.xt, self.sig = x_pred, sig_pred_c
                self.iteration += 1
                return self.xt.cpu().numpy()
            self.sig, self.xt = sig_post, x
            self.iteration += 1
            t_walls["solve_ms"] = (time.perf_counter() - t0) * 1e3
        else:
            x_pred, A = self._predict(self.xt, action)
            A = A.cpu().numpy()
            sig_pred = A @ self.sig.cpu().numpy() @ A.T + self.Q.cpu().numpy()
            sig_inv = torch.as_tensor(np.linalg.inv(sig_pred), device=self.device)
            x, _, losses = self.opt_run(x_pred, None, rays_pool, gt_pixels, x_pred, sig_inv,
                                        self.draw_sel(self.cfg.n_iters))
            loss = losses[-1]
            if not bool(torch.isfinite(x).all()):
                self.xt = x_pred
                self.sig = self._condition(sig_pred)
                self.iteration += 1
                return self.xt.cpu().numpy()
            Hs = self.hess_fn(x, rays_pool, gt_pixels, x_pred, sig_inv,
                              self.draw_sel()).detach().cpu().numpy()
            Hs_pd = nearest_pd(Hs) + self.cfg.hess_reg * np.eye(12)
            self.sig = self._condition(np.linalg.inv(Hs_pd))
            self.xt = x.detach()
            self.iteration += 1

        t_walls.setdefault("solve_ms", (time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        if self.workspace or obs_pose_gt is not None:
            pose_est = self.state_to_pose(self.xt).cpu().numpy()
            rot_err, trans_err = (None, None)
            if obs_pose_gt is not None:
                rot_err, trans_err = calc_se3_err(pose_est, np.asarray(obs_pose_gt))
            if self.workspace and self.cfg.render_viz:
                from nerfnav_tpu_torch.nav.viz import estimator_triptych

                H, W = img_f.shape[:2]
                estimator_triptych(
                    img_f, self.render_from_pose(pose_est, H, W), poi,
                    title=(f"Time step: {self.iteration}. Trans. error: {trans_err} m. "
                           f"Rotate. error: {rot_err} deg."),
                    path=os.path.join(self.workspace, "estimator_data",
                                      f"viz_{self.iteration:04d}.png"))
            if self.workspace:
                path = os.path.join(self.workspace, "estimator_data",
                                    f"step_{self.iteration:04d}.json")
                with open(path, "w") as f:
                    json.dump({"state": self.xt.cpu().numpy().tolist(),
                               "sig": self.sig.cpu().numpy().tolist(),
                               "action": action.cpu().numpy().tolist(),
                               "loss": float(loss), "rot_err_deg": rot_err,
                               "trans_err": trans_err}, f)
        t_walls["artifacts_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_timings = {k: round(v, 1) for k, v in t_walls.items()}
        return self.xt.cpu().numpy()
