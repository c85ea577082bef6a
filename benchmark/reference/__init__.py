"""The plain reference: the WCT cascade and the ``wct_se`` training step in
plain PyTorch, NCHW, float32 (with the configuration's TF32 flag), from a
configuration's layer tables; the control rounds its products' operands
to the precision below the configuration's (``precision.py``). It imports nothing of the program and takes nothing the program
made: the benchmark hands it the same weights and inputs it hands the
program, and it works out every derived quantity (conv0, the statistics,
the coloring) again."""
