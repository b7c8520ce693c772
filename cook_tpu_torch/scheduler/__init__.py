"""Scheduling core: coordinator, constraints, tensorize, unscheduled."""
