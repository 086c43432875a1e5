"""Fine-tuning: schedule, train loop, feature cache, checkpoints."""
