"""Eval step, checkpoints and the adversarial handler (test mode)."""
