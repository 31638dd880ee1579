"""Training: the D+G train step, its optimizers and schedules, ortho-reg, the
run driver and its CLI, and the golden step check."""
