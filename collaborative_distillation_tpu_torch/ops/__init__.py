"""NHWC conv/pool/upsample ops (:mod:`.conv`), the WCT math
(:mod:`.wct_transform`) and the CUDA kernels behind them (:mod:`.cuda`)."""
