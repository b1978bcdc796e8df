"""calibrate.py's readings for the mipnerf-train-blender cell, with its two
faults beside calibrate.py's:

    python3 -m perfbench.calibrate_mip --workload mipnerf-train-blender \
        --seeds 11 12 13 --control 21 22 23 --fault mip_half_batch --fault-seeds 31 32 33

- `mip_half_batch`: the training step renders half of its rays (with their
  draws) and takes the loss's means over them;
- `no_resample`: the fine level renders the coarse level's intervals (the
  blurred resample left out).
"""

import sys

from perfbench import calibrate


def mip_half_batch():
    from nerfnav_tpu_torch.training import trainer as tm

    orig = tm.Trainer.loss_and_grads

    def loss_and_grads(self, state, arrays, draws):
        h = len(draws.bg) // 2
        rays = type(draws.rays)(*[None if v is None else v[:h] for v in draws.rays])
        return orig(self, state, arrays, draws._replace(
            rays=rays, bg=draws.bg[:h], jitter=draws.jitter[:h], u=draws.u[:h]))

    tm.Trainer.loss_and_grads = loss_and_grads
    return lambda: setattr(tm.Trainer, "loss_and_grads", orig)


def no_resample():
    from nerfnav_tpu_torch.models import renderer

    orig = renderer.resample_along_rays
    renderer.resample_along_rays = lambda t, weights, u, padding: t
    return lambda: setattr(renderer, "resample_along_rays", orig)


FAULTS = {"mip_half_batch": mip_half_batch, "no_resample": no_resample}


def main(argv=None):
    calibrate.FAULTS.update(FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
