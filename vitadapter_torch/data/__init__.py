"""Input preprocessing."""
