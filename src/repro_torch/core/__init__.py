"""Numerics of Moniqua: topologies, quantizers, modulo arithmetic, theta and the update rules."""
