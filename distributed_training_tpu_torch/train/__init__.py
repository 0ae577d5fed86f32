"""Training: optimizer, precision, state, step and the Trainer."""
