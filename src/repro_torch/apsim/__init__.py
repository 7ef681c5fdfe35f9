"""repro_torch.apsim — faithful reimplementation of BF-IMNA's in-house simulator.

A verbatim copy of ``repro.apsim`` (pure Python/numpy): the port imports
nothing of ``repro``, and its pricing must stay float-equal to the
reference's, so the two copies change together.

The paper (Rakka et al., "BF-IMNA", 2024) models Associative-Processor (AP)
compute as sequences of compare/write passes (Tables I & II, Eqs. 1-15) and
estimates end-to-end CNN inference latency / energy / area on two hardware
configurations (IR = infinite resources, LR = limited resources, Table V)
for SRAM and ReRAM CAM cells (Table VI).

Modules
-------
costmodel   Eqs. 1-15 runtime models + cell-level op accounting
energy      Table VI technology parameters, voltage scaling
mapper      im2col GEMM dims, IR/LR mapping with time folding, mesh comm
workloads   AlexNet / VGG16 / ResNet50 / ResNet18 layer tables
metrics     GOPS, GOPS/W, GOPS/W/mm^2, EDP, Table VIII peak model
"""
from repro_torch.apsim.costmodel import (  # noqa: F401
    Cost,
    rt_add,
    rt_multiply,
    rt_reduce,
    rt_matmat,
    rt_relu,
    rt_maxpool,
    rt_avgpool,
)
from repro_torch.apsim.energy import TechParams, SRAM, RERAM  # noqa: F401
from repro_torch.apsim.mapper import BFIMNAConfig, LR_CONFIG, IR_CONFIG, simulate_network  # noqa: F401
from repro_torch.apsim.workloads import WORKLOADS, NETWORKS  # noqa: F401
