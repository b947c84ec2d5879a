"""Training-side uses of the paper's operators (PyTorch port): the straggler-masked,
sketched gradient mean (``sketch_dp``) and sketched linear-head fitting on LM
features (``solvers``). The LM training loop they sit in is not ported yet."""
