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
card), float32 master weights, Adam state and losses. ``--data_parallel N``
trains on N devices (0, the default, means every visible card, as in the
reference; a batch that does not divide over them is refused, and so are
fewer cards than N). On the card that is one process a card: the CLI
starts N copies of itself, card ``r`` for copy ``r``, joined as
``torchrun --nproc_per_node N`` joins them (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; launched so by hand or by
``torchrun``, it joins that group and starts none). The processes join
through ``initialize_multihost`` (NCCL; gloo with ``--device cpu``); each
loads and trains on its own rows of every batch (one shuffle seed: the
same batches), and process 0 alone writes the log, the grids (its own
rows) and the checkpoints. With ``--device cpu`` and no group, N > 1 is
one process holding N replicas on the CPU (``Trainer(mesh=)``).
On the card, ``--content_train``'s JPEGs are decoded by nvJPEG and resized
to ``--shorter_side`` there (``ImageFolderDataset(device=)``); PNGs are
read on the host.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..data.pipeline import ImageFolderDataset, Loader
from ..models.specs import decoder_spec, encoder_spec
from ..models.vgg import init_params
from ..models.zoo import default_weights_root, load_stage_params
from ..parallel.mesh import initialize_multihost, make_mesh, process_group
from ..train.trainer import TrainConfig, Trainer
from ..utils.image import jpeg_or_png, save_image_grid
from ..utils.logging import Experiment, LossMeter, Throughput, resolve_path
from ..wct.engine import resolve_device


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
                    help="devices for data parallelism: a process a card (0 = every "
                         "visible card); with --device cpu, replicas in one process "
                         "(0 = one)")
    ap.add_argument("--weights_root", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cpu = resolve_device(args.device).type == "cpu"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_multihost(backend="gloo" if cpu else None)
        try:
            return _stages(args)
        finally:
            torch.distributed.destroy_process_group()
    n_dev = args.data_parallel or (1 if cpu else torch.cuda.device_count())
    if cpu or n_dev <= 1:
        return _stages(args)
    if n_dev > torch.cuda.device_count():
        raise SystemExit(f"--data_parallel {n_dev}: {torch.cuda.device_count()} CUDA "
                         f"devices visible")
    if args.batch_size % n_dev:
        raise SystemExit(f"batch_size {args.batch_size} not divisible by {n_dev} devices")
    return _spawn(argv, n_dev)


def _spawn(argv, n: int) -> int:
    """Run this CLI as ``n`` processes, one a card, joined as ``torchrun``
    joins them; returns the first failing exit code (the others are then
    stopped: they would wait on it in a collective), else 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, *argv],
                              env={**os.environ, "PYTHONPATH": path, "WORLD_SIZE": str(n),
                                   "RANK": str(r), "LOCAL_RANK": str(r),
                                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
             for r in range(n)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()


def _stages(args) -> int:
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


class _NoExperiment:
    """What a process other than 0 of a group writes: nothing."""

    def log(self, *_a, **_k) -> None:
        pass

    def close(self) -> None:
        pass


def _run_stage(args, k: int) -> int:
    exp = (Experiment(args.project_name or f"{args.mode}_s{k}",
                      debug=args.debug, to_screen=args.screen or args.debug)
           if process_group()[1] == 0 else _NoExperiment())
    try:
        return _train(args, k, args.weights_root or default_weights_root(), exp)
    finally:
        exp.close()


def _data_parallel(args):
    """(N, mesh or None): the reference's ``args.data_parallel or
    len(jax.devices())``; a mesh only above one device. In a group of
    processes N counts them, each holding a mesh of its one device; with
    none, N > 1 is N replicas on the CPU (:func:`main` starts a process a
    card on the GPU)."""
    cpu = resolve_device(args.device).type == "cpu"
    world, rank = process_group()
    if world == 1:
        n_dev = args.data_parallel or 1
        if n_dev <= 1:
            return n_dev, None
        if args.batch_size % n_dev:
            raise SystemExit(f"batch_size {args.batch_size} not divisible by {n_dev} devices")
        return n_dev, make_mesh(data=n_dev, devices=["cpu"] * n_dev)
    if args.data_parallel not in (0, world):
        raise SystemExit(f"--data_parallel {args.data_parallel}: a group of {world} "
                         f"processes trains on one device each; pass 0 or {world}")
    if args.batch_size % world:
        raise SystemExit(f"batch_size {args.batch_size} not divisible by {world} devices")
    local = torch.device("cpu") if cpu else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if not cpu:
        torch.cuda.set_device(local)
    return world, make_mesh(data=1, devices=[local])


def _train(args, k: int, root: str, exp: Experiment) -> int:
    log = exp.log
    log(f"args: {vars(args)}")
    n_dev, mesh = _data_parallel(args)
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
    trainer = Trainer(cfg, student, frozen, device=args.device, mesh=mesh)
    start_epoch = 1
    if args.resume:
        meta = trainer.restore(resolve_path(args.resume))
        start_epoch = int(meta.get("epoch", 0)) + 1
        log(f"resumed from {args.resume} at epoch {start_epoch - 1}")

    # uint8 batches: a quarter of the bytes to the card, normalized there
    # JPEGs decode and resize on the trainer's card (nvJPEG and the resize
    # kernels), each process on its own
    dataset = ImageFolderDataset(args.content_train, args.shorter_side, cache=args.cache_data,
                                 uint8=True, aug=args.aug, device=trainer.device)
    world, rank = process_group()
    loader = Loader(dataset, args.batch_size, shard=(rank, world))
    if len(loader) == 0:
        raise SystemExit(f"dataset has {len(dataset)} images < batch_size {args.batch_size}: "
                         f"no full batch can be formed (reduce --batch_size)")
    log(f"dataset: {len(dataset)} images, {len(loader)} steps/epoch, device {trainer.device}, "
        f"compute {cfg.compute_dtype}, mesh: {'DP x %d' % n_dev if mesh else 'single device'}"
        + (" (one process a device)" if world > 1 else ""))
    lead = rank == 0

    meter = LossMeter()
    tp = Throughput()
    total_steps = 0
    for epoch in range(start_epoch, args.epoch + 1):
        for step, (batch, _paths) in enumerate(loader):
            losses, rec = trainer.train_step(batch)
            total_steps += 1
            tp.tick(world * batch.shape[0] * batch.shape[1] * batch.shape[2])
            for name, val in losses.items():
                meter.update(f"{name} (*{trainer.loss_weights[name]:g})", float(val))
            if step % args.print_interval == 0:
                log(f"E{epoch}S{step} {meter.format()} ({tp.report()})")
                tp.reset()
            if lead and step % args.save_interval == 0:
                # this process's rows: the first of the global batch's
                grid = np.concatenate([batch.astype(np.float32) / 255.0,
                                       rec[:len(batch)].cpu().numpy()], axis=0)
                path, why = jpeg_or_png(exp.image_path(epoch, step), device=trainer.device)
                save_image_grid(grid, path, nrow=len(batch), device=trainer.device)
                if why:
                    log(f"grid written as PNG ({why})")
            if args.max_steps and total_steps >= args.max_steps:
                if lead:
                    trainer.save(exp.ckpt_path(), epoch=epoch, step=total_steps)
                    log(f"max_steps {args.max_steps} reached; checkpoint at {exp.ckpt_path()}")
                return 0
        if lead:
            trainer.save(exp.ckpt_path(), epoch=epoch, step=total_steps)
            log(f"epoch {epoch} done; checkpoint at {exp.ckpt_path()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
