"""`host_syncs_per_round` in the ICM cell: the blocking host syncs a
round, here the Houdayer fixed-point loop's convergence reads (one every
few steps) and the swaps' copy of a constant from host memory."""

from perfbench.metrics.host_syncs_per_round import read  # noqa: F401
