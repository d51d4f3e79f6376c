"""Schedules, conversion, routing, dispatch and the sampler of the port."""
