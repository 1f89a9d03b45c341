"""Phase timers reproducing the reference's profiling table.

Phase taxonomy and report format follow
``FEniCSx/mechanic2d/asym_elasto_damage_model.cc:75-87, 1174-1220`` (the
``SL`` macro table: min / max / std-dev / CV% / avg / %total per phase,
reduced across ranks) and the Python mirror
(``asym_elasto_damage_model_symb_sym.py:407-441``). Host timers; device
work is asynchronous, so with a CUDA ``device`` every phase ends on
``torch.cuda.synchronize`` and the time of the work it queued is booked
to it, not to the next phase that waits.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

# The 16-phase schema (SURVEY.md Appendix A; FEniCSx/...cc:1199-1219)
PHASES: List[str] = [
    "total",                                    # 0: whole run
    "1 Initialize",                             # 1
    "2.1 Read mesh",                            # 2
    "2.2 Refine mesh",                          # 3
    "3.1 Define space",                         # 4
    "3.2 Define damage",                        # 5 (reference: 4.2)
    "4.1 Material constant",                    # 6
    "5.1 Dirichlet setting",                    # 7
    "5.2 Neumann setting",                      # 8
    "6.3 Create and assemble elementary vector",# 9
    "6.4 Create and assemble elementary matrix",# 10
    "7.1 Nonlinear form creation",              # 11
    "7.2 Solver creation",                      # 12
    "7.3 NonLinear resolution",                 # 13
    "8 Outputs",                                # 14
    "8.1 strain/stress computation",            # 15
]


class PhaseTimers:
    def __init__(self, phases: Optional[List[str]] = None, device=None):
        self.phases = list(phases or PHASES)
        dev = torch.device(device) if device is not None else None
        self._sync = dev if dev is not None and dev.type == "cuda" else None
        self.elapsed: Dict[str, float] = {p: 0.0 for p in self.phases}
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        if name not in self.elapsed:
            self.elapsed[name] = 0.0
            self.phases.append(name)
        start = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            self.elapsed[name] += time.perf_counter() - start

    def finish(self):
        self.elapsed["total"] = time.perf_counter() - self._t0

    def report(self) -> str:
        """Fixed-width table in the layout of the reference's MPI_Reduce
        block (FEniCSx/...cc:1184-1220); with one process min, max and
        avg are the phase's time and the spread is 0."""
        total = self.elapsed.get("total", 0.0) or 1.0
        lines = [
            "| {:>12} | {:>12} | {:>12} | {:>12} | {:>12} | {:>12} | {:>42} |".format(
                "min", "max", "std dev", "CV(%)", "avg", "%total", "phase"
            )
        ]
        for p in self.phases:
            t = self.elapsed.get(p, 0.0)
            lines.append(
                "| {:12.5f} | {:12.5f} | {:12.5f} | {:12.5f} | {:12.5f} | {:12.1f} | {:>42} |".format(
                    t, t, 0.0, 0.0, t, 100.0 * t / total, p
                )
            )
        return "\n".join(lines)
