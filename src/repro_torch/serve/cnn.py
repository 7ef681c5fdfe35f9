"""Batched, bit-fluid CNN image serving, on one device or row-split
across a data mesh.

The counterpart of ``repro.serve.cnn``: weights are quantized once at
engine construction (int8 containers, packed int4 where every registered
configuration keeps a layer at <= 4 bits), each image's budget resolves
through a :class:`~repro_torch.core.policy.BudgetController` (or the
closed-loop :class:`~repro_torch.core.policy.FluidController`, charged
image by image through ``plan_admissions``) into a per-layer bit vector,
the batch's ``(B, n_gemm)`` bit matrix runs through the bit-grouped
dispatch (one bit-plane kernel launch per layer, or per group of a
grouped conv, and bit family), and the resolved matrix is priced in one
pass through the paper's calibrated AP cost model.

The reference counts compiled programs to show that configuration
switches never recompile; the port runs eagerly, and its counterpart is
the bit-plane kernel's launch count per ``n_planes``
(``repro_torch.kernels.bitplane_matmul.launches_by_planes``), which only
ever touches the controller's bit families.

Placement (``mesh=``, ``plan=``): a plan without a mesh prices every
image under it (latency amortized over the replicas, energy unchanged).
On a mesh the quantized weights are placed once by
``dist.sharding.param_shardings(qparams, mesh, plan=self.plan)`` (each
conv and fc column-parallel over the ``model`` axis, its output channels
gathered after it, and FSDP over the data axis; a plan's fully
replicated layers stay whole), and a data axis that divides
``max_batch`` splits the padded batch's rows: every rank resolves and
prices the whole batch on the host identically, runs its block of
``max_batch / dp`` rows through the forward and all-gathers the logits;
a data axis that does not divide it leaves the rows whole, and every
rank computes every image (the reference replicates such a dim).
The caller is SPMD: every rank calls :meth:`CNNServeEngine.serve` with
the same images and budgets.  Rows are independent and every sharded
GEMM is exact, so the logits equal the single-device engine's.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.apsim import metrics as apm
from repro_torch.apsim.workloads import (HAWQV3_RESNET18, Layer, gemm_layers,
                                         per_layer_bits)
from repro_torch.core.policy import BudgetController, PrecisionPolicy, fixed
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import ops as kops
from repro_torch.models import cnn
from repro_torch.models import common as cm
from repro_torch.serve.accounting import ImageStats
from repro_torch.serve.runtime import ServeRuntime


class CNNServeEngine(ServeRuntime):
    """Batched, bit-fluid CNN inference server.

    ``serve(images, budgets)`` runs one batch: ``images`` (B, H, W, C)
    NHWC with B <= ``max_batch`` (short batches right-pad; padded rows take
    the cheapest configuration and are dropped from the results), and
    ``budgets`` a scalar or ``(B,)`` per-image vector on the controller's
    budget axis (``None`` = unconstrained = most accurate configuration).
    Returns ``(logits (B, num_classes) numpy, [ImageStats])``.

    ``params`` are train-form parameters (``cnn.init_cnn``, or the
    reference's through ``models.convert``); they are quantized onto
    ``device`` — CUDA unless the caller passes another.  ``mesh`` and
    ``plan`` place the engine (module docstring).
    """

    @torch.no_grad()
    def __init__(self, params: dict, layers: Sequence[Layer], *,
                 controller: Optional[BudgetController] = None,
                 policy: Optional[PrecisionPolicy] = None,
                 max_batch: int = 8, container: str = "auto", mesh=None,
                 plan=None, device="cuda"):
        self.device = cm.resolve_device(device)
        self.layers = list(layers)
        gl = gemm_layers(self.layers)
        self.n_gemm = len(gl)
        if controller is None:
            pol = policy or fixed(8)
            controller = BudgetController({pol.name: pol}, {pol.name: 0.0},
                                          self.n_gemm)
        if plan == "auto":
            # planned here, not in the runtime: a CNN plan carries the
            # per-layer names (true per-layer replication)
            m = mesh if mesh is not None else dist.active_mesh()
            nd = dist.mesh_device_count(m)
            plan = (dist.plan_for_controller(
                        controller, apm.network_gemms(self.layers),
                        n_devices=nd, names=tuple(l.name for l in gl))
                    if nd > 1 else None)
        super().__init__(controller, self.n_gemm,
                         gemms=apm.network_gemms(self.layers), mesh=mesh,
                         plan=plan, slot_desc="GEMM (conv/fc) layers")
        self.max_batch = max_batch
        # a batch that does not split: every rank computes every image
        self._rows = self._row_split(max_batch, "images per batch",
                                     cache=False)
        wtab, _ = controller.stacked_tables()
        if container == "auto":
            int4_names = cnn.int4_eligible(self.layers, wtab)
            container = "int8"
        else:
            int4_names = ()
            wmax = int(wtab.max())
            if container == "int4" and wmax > 4:
                raise ValueError(
                    f"container='int4' caps fidelity at 4 bits but the "
                    f"controller can resolve up to {wmax}-bit "
                    f"configurations — requests would be priced at a "
                    f"precision the container cannot honor (use "
                    f"container='auto' to pack int4 only where every "
                    f"configuration stays <= 4 bits)")
        self.int4_names = int4_names
        on_dev = {k: {n: t.to(self.device) for n, t in v.items()}
                  for k, v in params.items()}
        self.qparams = self.place(cnn.quantize_cnn_params(
            on_dev, self.layers, container=container,
            int4_names=int4_names))

    @torch.no_grad()
    def serve(self, images, budgets=None
              ) -> Tuple[np.ndarray, List[ImageStats]]:
        """One batched inference; see class docstring."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        B = images.shape[0]
        if not 1 <= B <= self.max_batch:
            raise ValueError(f"batch of {B} images exceeds max_batch="
                             f"{self.max_batch}")
        submitted = time.time()
        if budgets is None:
            req: List[Optional[float]] = [None] * B
        else:
            req = np.broadcast_to(np.asarray(budgets, np.float64),
                                  (B,)).tolist()
        # batch admission planning: a closed-loop controller is charged
        # image by image, so effective budgets tighten within the batch
        bud = self.plan_admissions(req)
        # pad to the fixed batch shape: padded rows take the cheapest
        # configuration (budget 0 fits nothing -> fastest) and are dropped
        pad = self.max_batch - B
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad,) + tuple(images.shape[1:]))])
            bud = np.concatenate([bud, np.zeros((pad,), np.float64)])
        wmat, amat = self.controller.resolve(
            torch.as_tensor(bud, dtype=torch.float32))
        rows = slice(*self._rows) if self._rows is not None else slice(None)
        with self.compute_ctx(), kops.split_rows(
                self.mesh if self._rows is not None else None):
            logits = cnn.cnn_forward(self.qparams, images[rows], self.layers,
                                     wmat[rows].to(self.device),
                                     amat[rows].to(self.device))
        if self._rows is not None:
            logits = self.mesh.gather_rows(logits)
        logits_h = logits[:B].cpu().numpy()
        wmat_h = wmat.numpy().astype(np.int64)[:B]
        amat_h = amat.numpy().astype(np.int64)[:B]
        costs = self.price_matrix_bits(wmat_h, amat_h)     # one-pass batch
        replicas = (self.plan.mean_replicas if self.plan is not None
                    else 0.0)
        stats = []
        for i in range(B):
            rec = ImageStats(
                rid=self.next_rid(), budget_s=float(bud[i]), index=i,
                mean_wbits=float(np.mean(wmat_h[i])), ap_cost=costs[i],
                wbits=tuple(int(b) for b in wmat_h[i]),
                abits=tuple(int(b) for b in amat_h[i]),
                plan_replicas=replicas, submitted_s=submitted)
            self.requests[rec.rid] = rec
            self.finish_record(rec.rid)
            stats.append(rec)
        self.stats.admitted += B
        self.stats.batches += 1
        self.stats.images += B
        return logits_h, stats


def hawq_fidelity_sweep(network: str = "resnet18", image: int = 32,
                        batch: int = 2, seed: int = 0, *, device="cuda"
                        ) -> Tuple[Dict[str, float], Dict[int, int]]:
    """Run every ``HAWQV3_RESNET18`` configuration through the serve-form
    kernels; returns ``({constraint: fidelity-vs-fp}, launches)``.

    Fidelity is softmax total-variation agreement with the fp
    (fake-quant-identity) train-form forward.  ``launches`` is the
    bit-plane kernel's launches per ``n_planes`` during the sweep — the
    port's counterpart of the reference's trace count: every
    configuration arrives as an ``(n_gemm,)`` bit tensor, so every GEMM
    runs at the container width (8 planes) and the sweep touches exactly
    one specialization.  Empty on the CPU, where no kernel launches.
    """
    dev = cm.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params, layers = cnn.init_cnn(network, gen, image=image, device=dev)
    qp = cnn.quantize_cnn_params(params, layers)
    x = torch.randn((batch, image, image, 3), generator=gen).to(dev)
    ref = torch.softmax(cnn.cnn_forward(params, x, layers), dim=-1)
    before = bpm.launches_by_planes()
    fid = {}
    for name, vec in HAWQV3_RESNET18.items():
        bits = torch.tensor(per_layer_bits(layers, vec), dtype=torch.int32,
                            device=dev)
        out = torch.softmax(cnn.cnn_forward(qp, x, layers, bits, bits),
                            dim=-1)
        fid[name] = float(1.0 - 0.5 * (out - ref).abs().sum(-1).mean())
    if not all(np.isfinite(v) for v in fid.values()):
        raise FloatingPointError(f"non-finite fidelity: {fid}")
    launches = {n: c - before[n] for n, c in bpm.launches_by_planes().items()
                if c != before[n]}
    return fid, launches
