"""Survival evaluators and the concordance index (host numpy)."""
