"""NHWC conv/pool/upsample ops (:mod:`.conv`), the WCT math
(:mod:`.wct_transform`), Gram and AdaIN statistics (:mod:`.style_stats`),
float32 scoping (:mod:`.precision`) and the CUDA kernels behind them
(:mod:`.cuda`)."""
