"""Cost-driven layer replication and data-parallel scale-out planning.

The counterpart of ``repro.dist.placement``, on the port's own AP cost
model.  LRMP (arXiv:2312.03146) replicates the bottleneck layers of a
mixed-precision in-memory pipeline across crossbar tiles, so the
pipeline clock is set by the *amortized* bottleneck, not the raw one.
The serve analogue: the per-layer AP cost breakdown every admission
already pays for (``apsim.metrics.price_bit_vector``: per-slot
cycles/energy, plus a trailing logits-head entry) becomes a *placement*
signal.

:func:`plan_placement` turns one representative priced bit vector plus a
device budget into a :class:`PlacementPlan`:

* **dp**: request rows split across the mesh's data axis (the serving
  batch is row-parallel);
* **replicas**: per priced entry (bit slots, + the head when priced),
  extra resident copies for the entries whose latency share dominates,
  assigned greedily to the current bottleneck while the memory budget
  funds them (``r = n_devices`` is one full copy per device, ``r = 1`` a
  single logical copy).

The plan is consumed three ways:

* **execution**: the engines place their weights by it on a mesh (a
  fully replicated plan keeps every weight on every rank, so a slot's
  owner computes its rows alone; a partial one shards the rest);
* **pricing**: :meth:`PlacementPlan.price` amortizes each entry's
  latency over its replicas (energy is unchanged: the same work runs,
  spread wider), which is what the cost records and ``aggregate()``
  report;
* **co-decision**: a ``FluidController`` re-prices its prediction table
  under the plan (``BudgetController.adopt_plan``), so the same SLO
  resolves higher bits.

:meth:`PlacementPlan.replicates` is the reference's parameter-spec rule
(which leaves replicate under a plan): ``dist.sharding`` reads it, so on
a mesh the leaves a plan fully replicates stay whole on every rank and
the rest keep the Megatron/FSDP rule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.apsim import metrics as apm
from repro_torch.apsim.workloads import Layer

# plan entries that resolve to these leaf names are the LM logits head
# family (the trailing priced entry); stacked transformer blocks live
# under "layers" (one leading L dim, so the stack replicates only when
# EVERY slot entry does)
_HEAD_LEAVES = frozenset(("head", "emb"))
_STACK_KEY = "layers"


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One placement decision: dp ways + per-entry replica counts.

    ``replicas``/``shares`` align with the priced cost entries: one per
    bit slot, plus one trailing entry when the logits head was priced
    (``has_head``).  ``names`` (CNN) maps entries to the per-layer
    parameter dict keys; empty for an LM (stacked params).
    """
    n_devices: int
    dp: int
    replicas: Tuple[int, ...]
    shares: Tuple[float, ...]
    axis: str = "edp"
    has_head: bool = False
    names: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {self.n_devices}")
        if not all(1 <= r <= self.n_devices for r in self.replicas):
            raise ValueError(f"replica counts {self.replicas} must lie in "
                             f"[1, {self.n_devices}]")
        if self.names and len(self.names) != len(self.replicas) - int(
                self.has_head):
            raise ValueError(
                f"{len(self.names)} entry names for "
                f"{len(self.replicas)} replica entries (has_head="
                f"{self.has_head})")

    # ---- introspection ----------------------------------------------

    @property
    def fully_replicated(self) -> bool:
        """Every priced entry holds one copy per device: the scale-out
        serving mode (unlocks the exact row split)."""
        return all(r == self.n_devices for r in self.replicas)

    @property
    def mean_replicas(self) -> float:
        return (sum(self.replicas) / len(self.replicas)
                if self.replicas else 1.0)

    @property
    def replicated_entries(self) -> Tuple[int, ...]:
        """Indices of entries with more than one resident copy."""
        return tuple(i for i, r in enumerate(self.replicas) if r > 1)

    def summary(self) -> Dict[str, object]:
        return {
            "n_devices": self.n_devices,
            "dp": self.dp,
            "axis": self.axis,
            "mean_replicas": round(self.mean_replicas, 4),
            "fully_replicated": self.fully_replicated,
            "replicated_entries": list(self.replicated_entries),
        }

    # ---- pricing ----------------------------------------------------

    def price(self, cost: apm.BitVectorCost) -> apm.BitVectorCost:
        """Amortize a priced bit vector over this plan's replicas.

        Per entry, latency (cycles) divides by the replica count: r
        resident copies of a layer serve r concurrent token streams, so
        the per-stream occupancy of that stage is cycles/r at full
        replica occupancy (LRMP's pipeline-clock argument).  Energy is
        UNCHANGED: every stream's work still runs somewhere.  Accepts
        costs priced with or without the trailing head entry (slots
        align from the front either way)."""
        n = len(cost.per_layer_cycles)
        if n > len(self.replicas):
            raise ValueError(
                f"cost has {n} entries but the plan covers only "
                f"{len(self.replicas)}")
        cyc = tuple(c / self.replicas[i]
                    for i, c in enumerate(cost.per_layer_cycles))
        return apm.BitVectorCost(cyc, cost.per_layer_energy_j, cost.freq_hz)

    # ---- parameter-spec rule ----------------------------------------

    def _name_index(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.names)}

    def replicates(self, keys: Sequence[str]) -> bool:
        """Whether the parameter leaf at ``keys`` REPLICATES under this
        plan (overrides the base sharding rule).

        CNN leaves match by their per-layer dict key (``names``); LM
        logits-head leaves (emb/head) match the trailing head entry; the
        stacked ``layers`` subtree replicates only when every slot entry
        is fully replicated (one leading L dim, no per-layer specs)."""
        keys = tuple(keys)
        if not keys:
            return False
        if self.names:
            idx = self._name_index().get(keys[0])
            if idx is not None:
                return self.replicas[idx] == self.n_devices
            return False
        if keys[0] in _HEAD_LEAVES or keys[-1] in _HEAD_LEAVES:
            return self.has_head and self.replicas[-1] == self.n_devices
        if keys[0] == _STACK_KEY:
            slots = self.replicas[:-1] if self.has_head else self.replicas
            return bool(slots) and all(r == self.n_devices for r in slots)
        return False


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _entry_weights(gemms: Sequence[Sequence],
                   head: Optional[Tuple[int, int]]) -> Tuple[float, ...]:
    """Weight elements resident per priced entry (replication's memory
    currency): sum of K*N over a slot's GEMV pairs, or i*j for a full
    conv/fc Layer."""
    out = []
    for dims in gemms:
        w = 0.0
        for item in dims:
            if isinstance(item, Layer):
                i, j, _ = item.gemm_dims()
                w += float(i) * float(j)
            else:
                K, N = item
                w += float(K) * float(N)
        out.append(w)
    if head is not None:
        out.append(float(head[0]) * float(head[1]))
    return tuple(out)


def _entry_shares(cost: apm.BitVectorCost, axis: str) -> Tuple[float, ...]:
    """Per-entry share of the total budget-axis cost (the dominance
    signal a replica chases)."""
    cyc = cost.per_layer_cycles
    en = cost.per_layer_energy_j
    if axis == "latency":
        raw = cyc
    elif axis == "energy":
        raw = en
    elif axis == "edp":
        raw = tuple(c * e for c, e in zip(cyc, en))
    else:
        raise ValueError(f"unknown budget axis {axis!r}")
    tot = sum(raw)
    if tot <= 0.0:
        return tuple(0.0 for _ in raw)
    return tuple(v / tot for v in raw)


def plan_placement(gemms: Sequence[Sequence],
                   wvec: Sequence[int], avec: Sequence[int], *,
                   n_devices: int,
                   head: Optional[Tuple[int, int]] = None,
                   axis: str = "edp",
                   memory_budget: Optional[float] = None,
                   names: Sequence[str] = ()) -> PlacementPlan:
    """Plan dp + replication from one representative priced bit vector.

    ``gemms``/``head`` are exactly ``price_bit_vector``'s descriptors
    (``lm.layer_gemm_dims`` / ``apm.network_gemms``); ``wvec``/``avec``
    the representative per-slot bits (a controller's most accurate
    config: :func:`plan_for_controller`).  ``memory_budget`` is total
    weight capacity in units of one full model copy (default:
    ``n_devices``, so every device holds a full copy and the plan fully
    replicates); tighter budgets (e.g. 1.5) replicate only the dominant
    entries.  Deterministic: greedy bottleneck chase, ties break on the
    lowest entry index.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    cost = apm.price_bit_vector(gemms, list(wvec), list(avec), head=head)
    shares = _entry_shares(cost, axis)
    weights = _entry_weights(gemms, head)
    lat = cost.per_layer_cycles
    n = len(lat)
    replicas = [1] * n
    total_w = sum(weights)
    budget = float(n_devices if memory_budget is None else memory_budget)
    if budget < 1.0:
        raise ValueError(f"memory_budget must be >= 1 model copy, "
                         f"got {budget}")
    remaining = (budget - 1.0) * total_w
    tol = 1e-9 * max(total_w, 1.0)
    while n_devices > 1:
        # chase the current bottleneck: highest amortized latency first;
        # fall through to the next entry when the top one is maxed out
        # or unfundable (replicating a cheaper stage still helps)
        order = sorted(range(n), key=lambda i: (-lat[i] / replicas[i], i))
        bumped = False
        for i in order:
            if replicas[i] >= n_devices:
                continue
            if weights[i] <= remaining + tol:
                replicas[i] += 1
                remaining -= weights[i]
                bumped = True
                break
        if not bumped:
            break
    return PlacementPlan(
        n_devices=int(n_devices), dp=int(n_devices),
        replicas=tuple(replicas), shares=shares, axis=axis,
        has_head=head is not None, names=tuple(names))


def plan_for_controller(controller, gemms: Sequence[Sequence], *,
                        n_devices: int,
                        head: Optional[Tuple[int, int]] = None,
                        axis: Optional[str] = None,
                        memory_budget: Optional[float] = None,
                        names: Sequence[str] = ()) -> PlacementPlan:
    """Plan from a controller's bit families: the representative vector
    is the most accurate registered configuration (the plan must stay
    honest for the heaviest bits the controller can resolve; cheaper
    configs only flatten the same dominance profile).  ``axis`` defaults
    to the controller's own budget axis."""
    wtab, atab = controller.stacked_tables()
    return plan_placement(
        gemms, wtab[-1].tolist(), atab[-1].tolist(), n_devices=n_devices,
        head=head, axis=axis if axis is not None else controller.budget_axis,
        memory_budget=memory_budget, names=names)


def mesh_device_count(mesh) -> int:
    """Total device count of a mesh (duck-typed: ``.shape`` dict)."""
    return int(math.prod(mesh.shape.values())) if mesh is not None else 1
