"""`round_roofline` in the ICM cell: the sweeps of the round against the
chip's least time for them, over the "round" stage's device time, where
the work counts every sub-replica's chains (`work.round_work`)."""

from perfbench.metrics.round_roofline import read  # noqa: F401
