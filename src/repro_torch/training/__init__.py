from repro_torch.training import schedule, optimizer, trainer, \
    grad_compression
from repro_torch.training.optimizer import make_optimizer, Optimizer
from repro_torch.training.schedule import SCHEDULES
from repro_torch.training.trainer import init_state, make_train_step

__all__ = [
    "schedule", "optimizer", "trainer", "grad_compression",
    "make_optimizer", "Optimizer", "SCHEDULES", "init_state",
    "make_train_step",
]
