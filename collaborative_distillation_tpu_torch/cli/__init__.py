"""Command-line entry points of the port, each ``python -m
collaborative_distillation_tpu_torch.cli.<name>``:

    stylize — content x style folders (or one UHD pair) to image files
    serve   — an HTTP server over a warm engine, with a style registry
    eval    — per-stage reconstruction PSNR/SSIM of a model family
    export  — a trainer checkpoint's student params into the weight store
    train   — collaborative distillation of a student stage (three modes)
    make_teacher  — a synthetic activation-normalized teacher store
    normalize_vgg — Gatys activation normalization of an encoder's weights

Each runs on the GPU unless ``--device cpu`` is given, and raises before
doing any work where CUDA is unavailable.
"""
