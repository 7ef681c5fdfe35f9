"""Serving runtime base, as far as batched CNN serving and whole-batch LM
generation use it (DESIGN.md §8).

The counterpart of ``repro.serve.runtime.ServeRuntime`` for one device
and an open-loop controller: the controller check, the static bit-family
set applied around every forward, the cached AP pricer (with the LM's
logits head), the host-side mirrors of the controller's tables, batch
admission planning and the per-request records.  The slot-pool
scheduler, the mesh/placement-plan branches and the closed-loop
``FluidController`` are not ported yet.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

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
                 head: Optional[Tuple[int, int]] = None,
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
        self.pricer = (BitVectorPricer(gemms, head=head)
                       if gemms is not None else None)
        self.stats = RuntimeStats()
        self.requests: Dict[int, CostRecord] = {}
        self._next_rid = 0
        self._lats_np: Optional[np.ndarray] = None
        self._tabs_np: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def price_bits(self, wv, av) -> apm.BitVectorCost:
        """AP cycles/energy of one resolved bit vector pair (cached)."""
        return self.pricer.price(np.asarray(wv), np.asarray(av))

    def price_matrix_bits(self, wmat, amat) -> List[apm.BitVectorCost]:
        """One-pass batch pricing (rows share cached cost objects)."""
        return self.pricer.price_matrix(wmat, amat)

    def _host_index(self, budget: float) -> int:
        """Host-side mirror of ``controller.select`` for one budget (the
        prediction array cached as float32 numpy, as the controller
        compares)."""
        if self._lats_np is None:
            self._lats_np = np.asarray(
                [self.controller.predicted_latency_s[k]
                 for k in self.controller.order()], np.float32)
        fits = np.nonzero(self._lats_np <= np.float32(budget))[0]
        return int(fits[-1]) if fits.size else 0

    def host_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """The controller's stacked (w, a) bit tables as cached host
        numpy, expanded from the raw policy tuples (the same
        last-entry-extends rule as ``PrecisionPolicy.vectors``)."""
        if self._tabs_np is None:
            n = self.n_layers

            def expand(tab):
                return [int(tab[i]) if i < len(tab) else int(tab[-1])
                        for i in range(n)]

            ws, as_ = [], []
            for k in self.controller.order():
                p = self.controller.configs[k]
                ws.append(expand(p.weight_bits))
                as_.append(expand(p.act_bits))
            self._tabs_np = (np.asarray(ws, np.int32),
                             np.asarray(as_, np.int32))
        return self._tabs_np

    def host_bits(self, budget: float) -> Tuple[np.ndarray, np.ndarray]:
        """The (wbits, abits) vectors a budget resolves to, as host numpy."""
        wtab, atab = self.host_tables()
        i = self._host_index(budget)
        return wtab[i], atab[i]

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
