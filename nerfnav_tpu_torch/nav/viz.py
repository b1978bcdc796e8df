"""Matplotlib plots of the nav stack: the trajectory map and the estimator's
triptych.

Counterpart of nerfnav_tpu/nav/viz.py:
- `QuadPlot`: a 3-D map of the trajectory line, the robot's body point cloud
  swept along it and an RGB axis triad per state, beside a twin-axis data
  graph.
- `estimator_triptych`: the observation, the keypoint mask and the render at
  the posterior pose, keypoints painted green; the pose filter writes one per
  update with `EstimatorConfig(render_viz=True)`.

Tensors are taken as they come, on any device (a Planner's states live on the
card in production), and copied to the host. matplotlib is imported when a
plot is made, on the Agg backend when there is no DISPLAY; the nav stack does
not need it otherwise, and a missing matplotlib raises there.
"""

import os

import numpy as np
import torch


def _plt():
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x):
    """x as a numpy array; a tensor is detached and copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _body_to_world(out, points):
    """(P, 3) body points swept through calc_everything states -> (S, P, 3)."""
    rot = _host(out["rot"])                   # (S, 3, 3)
    pos = _host(out["pos"])[: rot.shape[0]]
    return np.einsum("sij,pj->spi", rot, _host(points)) + pos[:, None, :]


class QuadPlot:
    """The 3-D trajectory, body cloud and axis triads, with a data graph.

    `trajectory` takes a Planner (nav/planner.py) or a calc_everything dict
    ({"pos", "rot", ...}) of numpy arrays or tensors.
    """

    def __init__(self, body_points=None):
        plt = _plt()
        self.fig = plt.figure(figsize=(16, 8))
        self.ax_map = self.fig.add_subplot(1, 2, 1, projection="3d")
        self.ax_graph = self.fig.add_subplot(1, 2, 2)
        self.ax_graph_right = self.ax_graph.twinx()
        if body_points is None:
            # the reference's body cloud: a 10 x 10 x 5 lattice
            xs = np.linspace(-0.05, 0.05, 10)
            zs = np.linspace(-0.02, 0.02, 5)
            body_points = np.stack(np.meshgrid(xs, xs, zs, indexing="ij"), axis=-1).reshape(-1, 3)
        self.robot_body = np.asarray(_host(body_points), np.float32)
        self.fig.tight_layout()

    @staticmethod
    def _states_of(traj):
        if isinstance(traj, dict):
            return traj
        return traj.get_full_states()

    def trajectory(self, traj, color="g", show_cloud=True):
        out = {k: _host(v) for k, v in self._states_of(traj).items()}
        ax = self.ax_map
        pos = out["pos"]
        ax.plot(pos[:, 0], pos[:, 1], pos[:, 2], color if isinstance(color, str) else "g")

        if show_cloud:
            cloud = _body_to_world(out, self.robot_body)      # (S, P, 3)
            for i, state_body in enumerate(cloud):
                c = color[i] if isinstance(color, (list, tuple)) else color
                ax.plot(state_body[:, 0], state_body[:, 1], state_body[:, 2],
                        c + ".", ms=72.0 / ax.figure.dpi, alpha=0.5)

        # an RGB axis triad per state
        size = 0.05
        triad = np.array([[0, 0, 0], [size, 0, 0], [0, size, 0], [0, 0, size]], np.float32)
        world = _body_to_world(out, triad)                    # (S, 4, 3)
        for state_axis in world:
            for i, c in enumerate("rgb", start=1):
                seg = state_axis[[0, i]]
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=c)
        return self

    def plot_data(self, *args, right=False, **kwargs):
        (self.ax_graph_right if right else self.ax_graph).plot(
            *[_host(a) if isinstance(a, torch.Tensor) else a for a in args], **kwargs)
        return self

    def save(self, path):
        self.fig.savefig(path, dpi=100)
        return path

    def show(self):
        _plt().show()

    def close(self):
        _plt().close(self.fig)


def estimator_triptych(gt_img, render_img, poi_xy=None, title=None, path=None):
    """The ground truth / features / render figure: the keypoint pixels
    (poi_xy, (M, 2) [x, y]) painted green on the observation and on the
    render, the middle panel the keypoint mask. Images in [0, 1] or [0, 255].
    Returns the figure; with `path` it is saved and closed.

    The reference draws it every few steps of its pose optimization; the
    filter here solves in one call, so it is drawn once per update, at the
    posterior pose.
    """
    plt = _plt()
    gt = np.array(_host(gt_img), np.float32, copy=True)
    rd = np.array(_host(render_img), np.float32, copy=True)
    if gt.max() > 1.5:
        gt = gt / 255.0
    if rd.max() > 1.5:
        rd = rd / 255.0
    feats = np.zeros(gt.shape[:2], np.float32)
    if poi_xy is not None and len(poi_xy):
        xy = np.asarray(_host(poi_xy), np.int64)
        x = np.clip(xy[:, 0], 0, gt.shape[1] - 1)
        y = np.clip(xy[:, 1], 0, gt.shape[0] - 1)
        green = np.array([0.0, 1.0, 0.0], np.float32)
        gt[y, x] = green
        rd[y, x] = green
        feats[y, x] = 1.0

    fig, axarr = plt.subplots(1, 3, figsize=(15, 5))
    if title:
        fig.suptitle(title)
    for ax, img, name in zip(axarr, (gt, feats, rd),
                             ("Ground Truth", "Features", "NeRF Render")):
        ax.imshow(img, cmap=None if img.ndim == 3 else "gray")
        ax.set_title(name)
        ax.axis("off")
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig
