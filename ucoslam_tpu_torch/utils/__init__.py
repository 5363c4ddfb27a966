from ucoslam_tpu_torch.utils.timers import Debug, StageTimers, timers  # noqa: F401
