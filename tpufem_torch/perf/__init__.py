"""Profiling: the reference's phase timer table (``timers``) and the
measurement scripts of the port (run on the GPU)."""

from tpufem_torch.perf.timers import PHASES, PhaseTimers

__all__ = ["PhaseTimers", "PHASES"]
