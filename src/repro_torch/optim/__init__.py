"""Optimizer substrate of the port: AdamW and learning-rate schedules."""
from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm_clip, init_opt_state
from repro_torch.optim.schedules import constant_schedule, linear_schedule, linear_warmup_cosine
