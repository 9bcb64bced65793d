"""Training of the port: AdamW written out, the train-step factory, gradient
compression and the logical-axis rules, as the JAX package's ``repro.train``;
and the placing of a train state on a mesh."""

from .compression import compressed_psum_mean
from .compression import init_error_feedback
from .loop import StepTimer
from .loop import StepWatchdog
from .loop import TrainState
from .loop import gather_train_state
from .loop import init_sharded_train_state
from .loop import init_train_state
from .loop import make_train_step
from .loop import shard_train_state
from .optimizer import AdamWConfig
from .optimizer import OptState
from .optimizer import adamw_update
from .optimizer import global_norm
from .optimizer import init_opt_state
from .optimizer import lr_schedule
from .sharding_rules import batch_logical_axes
from .sharding_rules import opt_logical_axes
from .sharding_rules import param_logical_axes

__all__ = [
    "compressed_psum_mean", "init_error_feedback",
    "StepTimer", "StepWatchdog", "TrainState", "gather_train_state", "init_sharded_train_state",
    "init_train_state",
    "make_train_step", "shard_train_state",
    "AdamWConfig", "OptState", "adamw_update", "global_norm",
    "init_opt_state", "lr_schedule",
    "batch_logical_axes", "opt_logical_axes", "param_logical_axes",
]
