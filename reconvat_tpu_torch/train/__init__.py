"""Training: optimizer, train state and the train/eval steps."""
