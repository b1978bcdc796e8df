"""Readings that the correctness limits are set from, on the card.

    python3 -m perfbench.calibrate --workload <name> --seeds 11 12 ... \
        [--control 21 22 23] [--fault half_batch --fault-seeds 31 32 33] [--seconds 2]

For each seed of --seeds, one cell of the workload as a run makes it (set-up,
a window of --seconds, the check), in one process: its compared numbers are
the program's lower readings. For each seed of --control, the same with the
control in the program's place (the reference one precision lower than the
configuration states) against the reference: its numbers are the upper
readings. With --fault, the program runs
with that fault planted in its timed path (`FAULTS`). Prints one JSON line
per run; the limits in the traffic file are set from them by hand.
"""

import argparse
import json
import sys

from perfbench import run


def half_batch():
    """The training step shades half of its rays and takes the loss's mean
    over them."""
    from nerfnav_tpu_torch.training import trainer as tm

    orig = tm.Trainer.loss_and_grads

    def loss_and_grads(self, state, arrays, draws):
        h = len(draws.bg) // 2

        def cut(v):
            return v[:h] if hasattr(v, "shape") and len(v.shape) and v.shape[0] == 2 * h else v

        rays = type(draws.rays)(*[cut(v) if v is not None else None for v in draws.rays])
        march = draws.march and type(draws.march)(*[cut(v) for v in draws.march])
        saved = self.opt.num_rays
        self.opt.num_rays = h
        try:
            return orig(self, state, arrays, draws._replace(
                rays=rays, bg=cut(draws.bg), march=march,
                jitter=None if draws.jitter is None else cut(draws.jitter)))
        finally:
            self.opt.num_rays = saved

    tm.Trainer.loss_and_grads = loss_and_grads
    return lambda: setattr(tm.Trainer, "loss_and_grads", orig)


def unchanged_state():
    """The training step computes its loss and leaves every parameter and
    the optimizer as they were."""
    from nerfnav_tpu_torch.training import trainer as tm

    orig = tm.Trainer.train_step

    def train_step(self, state, arrays, draws):
        return self.loss_and_grads(state, arrays, draws).loss

    tm.Trainer.train_step = train_step
    return lambda: setattr(tm.Trainer, "train_step", orig)


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state}


def one(args, seed, device, bench, mode, overrides=None):
    """One cell's compared numbers: mode "program" or "control"."""
    from perfbench.trace import Spans

    w, config, traffic = run.cell_spec(bench, args.workload)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    driver = run.load_module(run.HERE / "drivers" / f"{traffic['driver']}.py",
                             f"perfbench_driver_{traffic['driver']}")
    ctx = run.Ctx(name=args.workload, config=config, traffic=traffic, seed=seed,
                  device=device, spans=Spans(), trace=False)
    cell = driver.Cell(ctx)
    cell.window(args.seconds, None)
    cell.release()
    checks = cell.check() if mode == "program" else cell.control()
    return {c.name: c.value for c in checks}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        print(json.dumps({"mode": "program", "seed": seed,
                          **one(args, seed, device, bench, "program")}), flush=True)
    for seed in args.control:
        print(json.dumps({"mode": "control", "seed": seed,
                          **one(args, seed, device, bench, "control")}), flush=True)
    if args.fault:
        undo = FAULTS[args.fault]()
        try:
            for seed in args.fault_seeds:
                print(json.dumps({"mode": args.fault, "seed": seed,
                                  **one(args, seed, device, bench, "program")}), flush=True)
        finally:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
