"""Serving runtime base, as far as batched CNN serving uses it (DESIGN.md §8).

The counterpart of ``repro.serve.runtime.ServeRuntime`` for one device
and an open-loop controller: the controller check, the static bit-family
set applied around every forward, the cached AP pricer, batch admission
planning and the per-request records.  The slot-pool scheduler, the
mesh/placement-plan branches and the closed-loop ``FluidController`` are
not ported yet.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.apsim import metrics as apm
from repro_torch.core.policy import BudgetController
from repro_torch.kernels import ops as kops
from repro_torch.serve.accounting import (BitVectorPricer, CostRecord,
                                          RuntimeStats)

# "no budget": fits every configuration on any axis (most accurate wins)
UNCONSTRAINED_BUDGET = 1e30


class ServeRuntime:
    """Shared serving base: accounting, admission planning, bit families."""

    def __init__(self, controller: BudgetController, n_layers: int, *,
                 gemms: Optional[Sequence[Sequence]] = None,
                 slot_desc: str = "bit-slot layers") -> None:
        if controller.n_layers != n_layers:
            raise ValueError(
                f"controller resolves {controller.n_layers} bit slots but "
                f"this workload has {n_layers} {slot_desc}")
        self.controller = controller
        self.n_layers = n_layers
        # grouped per-row dispatch runs one GEMM per *distinct* weight
        # bit-width the controller can emit (kernels/ops.py)
        wtab, _ = controller.stacked_tables()
        self.families = tuple(sorted(
            {min(max(int(v), 1), 8) for v in wtab.flatten().tolist()}))
        self.pricer = (BitVectorPricer(gemms) if gemms is not None else None)
        self.stats = RuntimeStats()
        self.requests: Dict[int, CostRecord] = {}
        self._next_rid = 0

    def price_matrix_bits(self, wmat, amat) -> List[apm.BitVectorCost]:
        """One-pass batch pricing (rows share cached cost objects)."""
        return self.pricer.price_matrix(wmat, amat)

    def plan_admissions(self, budgets: Sequence[Optional[float]]
                        ) -> np.ndarray:
        """Effective budgets for a batch of admissions (open loop: each
        request's own budget passes through; ``None`` is unconstrained)."""
        return np.asarray([UNCONSTRAINED_BUDGET if b is None else float(b)
                           for b in budgets], np.float64)

    def next_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def finish_record(self, rid: int) -> CostRecord:
        record = self.requests[rid]
        record.done = True
        record.finished_s = time.time()
        self.stats.completed += 1
        return record

    @contextlib.contextmanager
    def compute_ctx(self):
        """The controller's static bit-family set around a forward."""
        with kops.bit_families(self.families):
            yield
