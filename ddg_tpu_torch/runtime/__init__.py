"""Training runtime: optimizer and schedules, weight averaging, the train
and eval steps (port of `ddg_tpu/runtime/`)."""
