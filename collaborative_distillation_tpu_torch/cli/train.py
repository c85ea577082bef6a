"""Training CLI: collaborative distillation of the 16x students on the GPU.

    python -m collaborative_distillation_tpu_torch.cli.train \
        --mode wct_se --stage 5 --pretrained_init \
        --content_train data/COCO/train2014/

The reference package's training CLI (the original ``main.py`` flag surface
and the ``wct_sd_kd2sd`` mode) on PyTorch, plus ``--device`` (``cuda``
unless ``--device cpu`` is given; without CUDA it raises before any work).
Checkpoints are in the reference's layout, so ``--resume`` takes one
written by either package, float32 or ``--bf16``. ``--bf16`` is the
reference's mixed precision: the step in bfloat16 (the bf16 kernels on the
card), float32 master weights, Adam state and losses. ``--data_parallel``
above 1 is refused: it is ROADMAP.md Queue 1 item 3.2.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data.pipeline import ImageFolderDataset, Loader
from ..models.specs import decoder_spec, encoder_spec
from ..models.vgg import init_params
from ..models.zoo import default_weights_root, load_stage_params
from ..train.trainer import TrainConfig, Trainer
from ..utils.image import jpeg_or_png, save_image_grid
from ..utils.logging import Experiment, LossMeter, Throughput, resolve_path
from ..wct.engine import resolve_device

DP_ITEM = ("ROADMAP.md Queue 1 item 3.2 (training): data parallelism over "
           "torch.distributed/NCCL, one process per card")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--content_train", type=str, default="data/COCO/train2014/")
    ap.add_argument("--style_train", type=str, default="data/WikiArt/train",
                    help="accepted for the reference CLI's sake; the distillation "
                         "losses are content-only, so it is unused")
    ap.add_argument("--pretrained_init", action="store_true",
                    help="init students from the L1-pruned base checkpoints")
    ap.add_argument("--shorter_side", type=int, default=300)
    ap.add_argument("-b", "--batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr_final", type=float, default=0.0,
                    help="cosine-decay lr to this value over --lr_decay_steps")
    ap.add_argument("--lr_decay_steps", type=int, default=0,
                    help="cosine decay horizon; defaults to --max_steps; "
                         "0 with no --max_steps = constant lr")
    ap.add_argument("--resume", type=str, default="",
                    help="checkpoint to resume from (either package's)")
    ap.add_argument("--BE", type=str, default="", help="big encoder weights (.npz)")
    ap.add_argument("--BD", type=str, default="", help="big decoder weights (.npz)")
    ap.add_argument("--SE", type=str, default="", help="small encoder weights (.npz)")
    ap.add_argument("--SD", type=str, default="", help="small decoder weights (.npz)")
    ap.add_argument("--lw_feat", type=float, default=10)
    ap.add_argument("--lw_pixl", type=float, default=1)
    ap.add_argument("--lw_perc", type=float, default=1)
    ap.add_argument("--lw_kd", type=float, default=1)
    ap.add_argument("--save_interval", type=int, default=100)
    ap.add_argument("--print_interval", type=int, default=10)
    ap.add_argument("--epoch", type=int, default=20)
    ap.add_argument("-p", "--project_name", type=str, default="")
    ap.add_argument("--speedup", type=int, default=16)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--screen", action="store_true")
    ap.add_argument("--updim_relu", action="store_true")
    ap.add_argument("--mode", type=str, required=True,
                    choices=["wct_se", "wct_sd", "wct_sd_kd2sd"])
    ap.add_argument("--stage", type=int, required=True, choices=[0, 1, 2, 3, 4, 5],
                    help="pyramid stage to train; 0 = all five stages 5..1 in turn "
                         "(per-stage --BE/--BD/--SE/--SD/--resume do not apply then)")
    ap.add_argument("--aug", type=str, default="flip", choices=("flip", "strong"),
                    help="content augmentation: 'flip' = crop + hflip (the "
                         "reference's); 'strong' adds scale jitter, the dihedral "
                         "group, channel permutation and intensity jitter")
    ap.add_argument("--cache_data", action="store_true",
                    help="cache decoded+resized training images in RAM (small folders)")
    ap.add_argument("--max_steps", type=int, default=0,
                    help="stop after N steps (0 = run all epochs)")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: bf16 forward/backward, f32 master "
                         "weights + Adam state (losses accumulate in f32)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="cards for data parallelism; above 1 is refused (ROADMAP.md "
                         "Queue 1 item 3.2)")
    ap.add_argument("--weights_root", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.data_parallel > 1:
        raise SystemExit(f"--data_parallel {args.data_parallel}: the port trains on one "
                         f"card; see {DP_ITEM}")
    resolve_device(args.device)
    if args.stage == 0:
        if args.BE or args.BD or args.SE or args.SD or args.resume:
            raise SystemExit("--stage 0 (all stages) uses the default per-stage weight "
                             "paths; explicit --BE/--BD/--SE/--SD/--resume apply to a "
                             "single stage only")
        for k in (5, 4, 3, 2, 1):
            rc = _run_stage(args, k)
            if rc:
                return rc
        return 0
    return _run_stage(args, args.stage)


def _run_stage(args, k: int) -> int:
    exp = Experiment(args.project_name or f"{args.mode}_s{k}",
                     debug=args.debug, to_screen=args.screen or args.debug)
    try:
        return _train(args, k, args.weights_root or default_weights_root(), exp)
    finally:
        exp.close()


def _train(args, k: int, root: str, exp: Experiment) -> int:
    log = exp.log
    log(f"args: {vars(args)}")
    be_spec = encoder_spec("original", k)
    bd_spec = decoder_spec("original", k)
    se_spec = encoder_spec("16x", k, aux=True)
    be_path = resolve_path(args.BE) or os.path.join(root, "original", f"e{k}.npz")
    bd_path = resolve_path(args.BD) or os.path.join(root, "original", f"d{k}.npz")
    # wct_sd with --lw_perc 0 never evaluates the teacher encoder: it needs
    # no teacher weights at all
    need_be = not (args.mode == "wct_sd" and args.lw_perc == 0)
    be = load_stage_params(be_path, be_spec) if need_be else None

    def student_encoder_init():
        if args.SE:
            return load_stage_params(resolve_path(args.SE), se_spec)
        if args.pretrained_init:
            return load_stage_params(os.path.join(root, "16x_base", f"e{k}.npz"), se_spec)
        return init_params(se_spec, torch.Generator().manual_seed(0))

    if args.mode == "wct_se":
        frozen = {"be": be, "bd": load_stage_params(bd_path, bd_spec)}
        student = student_encoder_init()
    elif args.mode == "wct_sd":
        sd_spec = decoder_spec("16x", k)
        frozen = {"se": student_encoder_init(), "be": be}
        if args.SD:
            student = load_stage_params(resolve_path(args.SD), sd_spec)
        elif args.pretrained_init:
            student = load_stage_params(os.path.join(root, "16x_base", f"d{k}.npz"), sd_spec)
        else:
            student = init_params(sd_spec, torch.Generator().manual_seed(1))
    else:  # wct_sd_kd2sd
        sd_spec = decoder_spec("16x", k, aux=True)
        frozen = {"be": be, "bd": load_stage_params(bd_path, bd_spec),
                  "se": student_encoder_init()}
        if args.SD:
            student = load_stage_params(resolve_path(args.SD), sd_spec)
        else:
            student = init_params(sd_spec, torch.Generator().manual_seed(2))

    cfg = TrainConfig(mode=args.mode, stage=k, lr=args.lr, lr_final=args.lr_final,
                      lr_decay_steps=(args.lr_decay_steps or args.max_steps)
                      if args.lr_final > 0 else 0,
                      batch_size=args.batch_size, epochs=args.epoch,
                      lw_feat=args.lw_feat, lw_pixl=args.lw_pixl, lw_perc=args.lw_perc,
                      lw_kd=args.lw_kd, aux_relu=args.updim_relu, speedup=args.speedup,
                      compute_dtype="bfloat16" if args.bf16 else "float32")
    trainer = Trainer(cfg, student, frozen, device=args.device)
    start_epoch = 1
    if args.resume:
        meta = trainer.restore(resolve_path(args.resume))
        start_epoch = int(meta.get("epoch", 0)) + 1
        log(f"resumed from {args.resume} at epoch {start_epoch - 1}")

    # uint8 batches: a quarter of the bytes to the card, normalized there
    dataset = ImageFolderDataset(args.content_train, args.shorter_side, cache=args.cache_data,
                                 uint8=True, aug=args.aug)
    loader = Loader(dataset, args.batch_size)
    if len(loader) == 0:
        raise SystemExit(f"dataset has {len(dataset)} images < batch_size {args.batch_size}: "
                         f"no full batch can be formed (reduce --batch_size)")
    log(f"dataset: {len(dataset)} images, {len(loader)} steps/epoch, device {trainer.device}, "
        f"compute {cfg.compute_dtype}")

    meter = LossMeter()
    tp = Throughput()
    total_steps = 0
    for epoch in range(start_epoch, args.epoch + 1):
        for step, (batch, _paths) in enumerate(loader):
            losses, rec = trainer.train_step(batch)
            total_steps += 1
            tp.tick(batch.shape[0] * batch.shape[1] * batch.shape[2])
            for name, val in losses.items():
                meter.update(f"{name} (*{trainer.loss_weights[name]:g})", float(val))
            if step % args.print_interval == 0:
                log(f"E{epoch}S{step} {meter.format()} ({tp.report()})")
                tp.reset()
            if step % args.save_interval == 0:
                grid = np.concatenate([batch.astype(np.float32) / 255.0,
                                       rec.cpu().numpy()], axis=0)
                path, why = jpeg_or_png(exp.image_path(epoch, step), device=trainer.device)
                save_image_grid(grid, path, nrow=args.batch_size, device=trainer.device)
                if why:
                    log(f"grid written as PNG ({why})")
            if args.max_steps and total_steps >= args.max_steps:
                trainer.save(exp.ckpt_path(), epoch=epoch, step=total_steps)
                log(f"max_steps {args.max_steps} reached; checkpoint at {exp.ckpt_path()}")
                return 0
        trainer.save(exp.ckpt_path(), epoch=epoch, step=total_steps)
        log(f"epoch {epoch} done; checkpoint at {exp.ckpt_path()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
