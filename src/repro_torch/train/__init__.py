from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (Heartbeat, RecoveryStats,
                                     StragglerMonitor, run_with_recovery)
from repro_torch.train.trainer import (TrainConfig, abstract_state,
                                       init_state, make_eval_step,
                                       make_prefill_step, make_serve_step,
                                       make_train_step, state_specs)

__all__ = ["TrainConfig", "init_state", "abstract_state", "make_train_step",
           "make_eval_step", "make_prefill_step", "make_serve_step",
           "state_specs",
           "CheckpointManager", "Heartbeat", "StragglerMonitor",
           "run_with_recovery", "RecoveryStats"]
