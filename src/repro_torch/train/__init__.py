"""Training substrate of the port: state, steps (the plain one and the sketch-DP
one), the trainer loop, and sketched linear-head fitting on LM features
(``solvers``)."""
from repro_torch.train.state import init_train_state, train_state_shapes
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
