"""Distributed building blocks: communication topologies."""
