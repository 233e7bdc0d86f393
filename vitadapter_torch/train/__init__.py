"""Training: optimizer and train step."""
