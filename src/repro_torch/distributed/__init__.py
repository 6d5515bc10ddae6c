"""Sharding rules, FLOP / byte / collective accounting and the H100
roofline (counterparts of the JAX package's ``repro.distributed``)."""
