"""One gloo rank of the sketch-DP step across processes (imported by spawned
children: no JAX here). The tiny test model (``tests/_torch_lm_train.py``'s
config, rebuilt without JAX) from the reference's weights for key 0, two steps
of ``make_sketch_dp_step`` with the CountSketch compressor over a group of
WORLD ranks, each on its rows of the global batch; rank r saves its parameters
and losses to ``out_dir/rank<r>.npz``."""
import dataclasses

import numpy as np

TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=97)
WORLD, BATCH, SEQ, STEPS, RATIO, LR, EPS = 2, 4, 32, 2, 0.1, 1e-3, 1e-4
MASKS = ([1.0, 1.0], [1.0, 0.0])  # step 0: both ranks arrive; step 1: rank 1 is late
BASE_KEY = 1


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gradcomp import GradCompressionConfig
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import sketch_dp, state
    from repro_torch.utils import prng

    torch.set_num_threads(1)
    group, _ = mesh.init_worker_group(device="cpu", rank=rank, world_size=world, init_method=f"file://{init_file}")
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), **TINY)
    opt = AdamWConfig(lr=LR, eps=EPS)
    st = state.init_train_state(cfg, opt, prng.prng_key(0), device="cpu")
    step = sketch_dp.make_sketch_dp_step(cfg, opt, group=group,
                                         comp=GradCompressionConfig(enabled=True, ratio=RATIO))
    losses = []
    for s in range(STEPS):
        batch = lm_batch(0, s, batch=BATCH, seq=SEQ, vocab=cfg.vocab_size, device="cpu")
        st, m = step(st, batch, prng.fold_in(prng.prng_key(BASE_KEY), s), torch.tensor(MASKS[s]))
        losses.append(float(m["loss"]))
    out = {f"p:{n}": p.detach().numpy() for n, p in st["params"].named_parameters()}
    np.savez(f"{out_dir}/rank{rank}.npz", losses=np.array(losses), **out)
