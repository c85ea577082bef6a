"""The plain reference: the WCT cascade and the ``wct_se`` training step in
plain PyTorch, NCHW, float32 with TF32 off, from a configuration's layer
tables. It imports nothing of the program and takes nothing the program
made: the benchmark hands it the same weights and inputs it hands the
program, and it works out every derived quantity (conv0, the statistics,
the coloring) again."""
