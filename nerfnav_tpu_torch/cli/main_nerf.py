"""Training CLI: train, evaluate and render a transforms.json scene.

    python -m nerfnav_tpu_torch.cli.main_nerf <scene> --cuda_ray --ff   # grid, dt_gamma 1/128
    python -m nerfnav_tpu_torch.cli.main_nerf <scene> --ff              # dense, 512 samples
    python -m nerfnav_tpu_torch.cli.main_nerf <scene> -O --ff           # the flagship grid
    python -m nerfnav_tpu_torch.cli.main_nerf <scene> ... --test        # eval + test path
    python -m nerfnav_tpu_torch.cli.main_nerf <scene> -O --ff --gui     # viewer on :7860
    python -m nerfnav_tpu_torch.cli.main_nerf <scene> --mipnerf         # mip-NeRF on white

Counterpart of nerfnav_tpu/cli/main_nerf.py, with the same flags (shared in
cli/flags.py). Training runs max(iters // steps_per_epoch, 1) epochs of
max(len(train), 100) steps and evaluates the val split; `--test` resumes the
checkpoint (`--ckpt`), evaluates the val split and writes the test path's
(else the val split's) frames, depth maps and video under
<workspace>/results. `--rand_pose` trains from random orbit poses scored by
the CLIP tower of `--clip_weights` against `--clip_text_embed`
(training/clip_tower.py; both files are the user's). `--gui` serves the
interactive viewer (gui/viewer.py) on 127.0.0.1:7860 at --W x --H, --radius,
--fovy and --max_spp, training as it renders; forward the port over SSH to
view it. Runs on the card unless `--device cpu` asks for the CPU.
"""

import sys


def make_trainer(opt):
    """(Trainer, DatasetOptions) from parsed flags, on opt.device."""
    from nerfnav_tpu_torch.cli.flags import make_configs
    from nerfnav_tpu_torch.data.provider import DatasetOptions
    from nerfnav_tpu_torch.device import resolve_device
    from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions

    if (opt.clip_weights is None) != (opt.clip_text_embed is None):
        raise SystemExit(
            "--clip_weights and --clip_text_embed come as a pair (the .npy text "
            "embedding is precomputed with the text tower; see training/clip_tower.py)")
    device = resolve_device(opt.device)
    clip_loss_fn = None
    if opt.clip_weights is not None:
        from nerfnav_tpu_torch.training.clip_tower import make_clip_loss_fn

        clip_loss_fn = make_clip_loss_fn(opt.clip_weights, opt.clip_text_embed,
                                         device=device)
    cfg, rcfg, occ_cfg, march_cfg = make_configs(opt, for_nav=False)
    ds_opt = DatasetOptions(
        path=opt.path, scale=opt.scale, offset=tuple(opt.offset),
        color_space=opt.color_space, downscale=opt.downscale, fp16=opt.fp16,
        error_map=opt.error_map)
    topt = TrainerOptions(
        name="ngp", workspace=opt.workspace, lr=opt.lr, iters=opt.iters,
        lr_iters=opt.lr_iters, num_rays=opt.num_rays, use_checkpoint=opt.ckpt,
        seed=opt.seed, error_map=opt.error_map,
        update_extra_interval=opt.update_extra_interval, tensorboard=True,
        bg_train=cfg.train_background,
        eval_table_dtype=opt.eval_table_dtype, eval_scan=opt.eval_scan,
        eval_occ_ladder=opt.eval_occ_ladder, eval_frame_phase_a=opt.eval_frame_phase_a,
        stride_phase=opt.stride_phase, eval_coarse_segments=opt.eval_coarse_segments,
        eval_coarse_anchors=opt.eval_coarse_anchors, eval_first_k=opt.eval_first_k,
        eval_proxy=opt.eval_proxy, rand_pose=opt.rand_pose, clip_text=opt.clip_text,
        **({"eval_beam": opt.eval_beam} if opt.eval_beam else {}))
    trainer = Trainer(cfg, rcfg, topt, occupancy_cfg=occ_cfg, march_cfg=march_cfg,
                      clip_loss_fn=clip_loss_fn, device=device)
    return trainer, ds_opt


def main(argv=None):
    """Train (or with --test, evaluate and render); returns the Trainer
    (reference main_nerf.py:11-93)."""
    from nerfnav_tpu_torch.cli.flags import build_parser
    from nerfnav_tpu_torch.data.provider import NeRFDataset

    opt = build_parser("nerfnav_tpu_torch NeRF training").parse_args(argv)
    trainer, ds_opt = make_trainer(opt)
    val_ds = NeRFDataset(ds_opt, split="val")
    if opt.test:
        trainer._maybe_resume()
        trainer.evaluate(val_ds)
        try:
            test_ds = NeRFDataset(ds_opt, split="test")
        except FileNotFoundError:
            test_ds = val_ds  # no test split: render the val path instead
        trainer.test(test_ds, write_video=True)
        return trainer
    train_ds = NeRFDataset(ds_opt, split="train")
    if opt.gui:
        from nerfnav_tpu_torch.gui import NeRFGUI

        NeRFGUI(trainer, train_ds, W=opt.W, H=opt.H, radius=opt.radius, fovy=opt.fovy,
                max_spp=opt.max_spp).serve(port=7860)
        return trainer
    steps_per_epoch = max(len(train_ds), 100)
    max_epochs = max(opt.iters // steps_per_epoch, 1)
    trainer.train(train_ds, valid_ds=val_ds, max_epochs=max_epochs,
                  steps_per_epoch=steps_per_epoch)
    trainer.evaluate(val_ds)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
