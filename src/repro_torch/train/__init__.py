"""Training of the port: AdamW written out and the train-step factory, as the
JAX package's ``repro.train`` (its distribution pieces, gradient compression
and the logical-axis rules, are not ported yet)."""

from .loop import StepTimer
from .loop import StepWatchdog
from .loop import TrainState
from .loop import init_train_state
from .loop import make_train_step
from .optimizer import AdamWConfig
from .optimizer import OptState
from .optimizer import adamw_update
from .optimizer import global_norm
from .optimizer import init_opt_state
from .optimizer import lr_schedule

__all__ = [
    "StepTimer", "StepWatchdog", "TrainState", "init_train_state",
    "make_train_step",
    "AdamWConfig", "OptState", "adamw_update", "global_norm",
    "init_opt_state", "lr_schedule",
]
