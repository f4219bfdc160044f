"""Core numerics: config, tasks, RNG, partitions, state-dict math."""
