"""Data and instance parallelism over processes: one rank per card."""
