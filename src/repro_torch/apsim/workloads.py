"""CNN workload tables for the paper's benchmarks.

AlexNet / VGG16 / ResNet50 (paper §IV) + ResNet18 (Table VII bit-fluidity
study).  Each network is a list of :class:`Layer` records; convolutions are
described by their im2col GEMM dimensions (paper §II.C):

    P (input-patch)  : (Hk*Wk*Ci) x (Ho*Wo)
    K (kernel-patch) : Ck x (Hk*Wk*Ci)
    O = K @ P        : Ck x (Ho*Wo)       i.e. GEMM dims i=Ck, j=Hk*Wk*Ci/g,
                                          u=Ho*Wo  (g = groups)

MAC counts match the common references (AlexNet 0.72G with grouped convs as
the paper cites; VGG16 15.5G).  NOTE: the paper quotes "4.14G MACs" for
ResNet50, which is its FLOP count (2 ops/MAC); our table yields ~2.07 GMACs
— the trend comparisons (VGG16 > ResNet50 > AlexNet) are unaffected and the
delta is recorded in EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    kind: str                    # conv | fc | maxpool | avgpool | add | relu
    # conv/fc geometry
    hin: int = 0
    win: int = 0
    cin: int = 0
    hk: int = 0
    wk: int = 0
    cout: int = 0
    stride: int = 1
    pad: int = 0
    groups: int = 1
    # pooling geometry
    window: int = 0              # S = hk*wk for pools
    relu: bool = False           # fused activation after conv/fc

    @property
    def hout(self) -> int:
        if self.kind in ("conv", "maxpool", "avgpool"):
            return (self.hin - self.hk + 2 * self.pad) // self.stride + 1
        return 1

    @property
    def wout(self) -> int:
        if self.kind in ("conv", "maxpool", "avgpool"):
            return (self.win - self.wk + 2 * self.pad) // self.stride + 1
        return 1

    def gemm_dims(self) -> Tuple[int, int, int]:
        """(i, j, u) such that the layer is O[i,u] = K[i,j] @ P[j,u]."""
        if self.kind == "conv":
            i = self.cout // self.groups
            j = self.hk * self.wk * (self.cin // self.groups)
            u = self.hout * self.wout
            return i, j, u
        if self.kind == "fc":
            return self.cout, self.cin, 1
        raise ValueError(f"{self.kind} has no GEMM dims")

    @property
    def macs(self) -> int:
        if self.kind == "conv":
            i, j, u = self.gemm_dims()
            return i * j * u * self.groups
        if self.kind == "fc":
            return self.cout * self.cin
        return 0

    @property
    def pool_elems(self) -> int:
        """(#windows K, window size S) product = elements pooled."""
        if self.kind in ("maxpool", "avgpool"):
            return self.hout * self.wout * self.cin * self.hk * self.wk
        return 0


def conv(name, hin, cin, k, cout, stride=1, pad=None, groups=1, relu=True) -> Layer:
    if pad is None:
        pad = k // 2
    return Layer(name, "conv", hin, hin, cin, k, k, cout,
                 stride=stride, pad=pad, groups=groups, relu=relu)


def pool(name, kind, hin, cin, k, stride) -> Layer:
    return Layer(name, kind, hin, hin, cin, k, k, cin, stride=stride, pad=0,
                 window=k * k)


def fc(name, cin, cout, relu=True) -> Layer:
    return Layer(name, "fc", cin=cin, cout=cout, relu=relu)


def add(name, hin, cin) -> Layer:
    return Layer(name, "add", hin=hin, win=hin, cin=cin)


# ---------------------------------------------------------------------------
def alexnet() -> List[Layer]:
    return [
        conv("conv1", 227, 3, 11, 96, stride=4, pad=0),
        pool("pool1", "maxpool", 55, 96, 3, 2),
        conv("conv2", 27, 96, 5, 256, groups=2),
        pool("pool2", "maxpool", 27, 256, 3, 2),
        conv("conv3", 13, 256, 3, 384),
        conv("conv4", 13, 384, 3, 384, groups=2),
        conv("conv5", 13, 384, 3, 256, groups=2),
        pool("pool5", "maxpool", 13, 256, 3, 2),
        fc("fc6", 256 * 6 * 6, 4096),
        fc("fc7", 4096, 4096),
        fc("fc8", 4096, 1000, relu=False),
    ]


def vgg16() -> List[Layer]:
    layers: List[Layer] = []
    cfg = [(224, 3, 64, 2), (112, 64, 128, 2), (56, 128, 256, 3),
           (28, 256, 512, 3), (14, 512, 512, 3)]
    for bi, (h, cin, cout, n) in enumerate(cfg, 1):
        for li in range(n):
            layers.append(conv(f"conv{bi}_{li+1}", h, cin if li == 0 else cout,
                               3, cout))
        layers.append(pool(f"pool{bi}", "maxpool", h, cout, 2, 2))
    layers += [fc("fc6", 512 * 7 * 7, 4096), fc("fc7", 4096, 4096),
               fc("fc8", 4096, 1000, relu=False)]
    return layers


def _resnet(block_cfg, bottleneck: bool) -> List[Layer]:
    layers: List[Layer] = [
        conv("conv1", 224, 3, 7, 64, stride=2, pad=3),
        pool("pool1", "maxpool", 112, 64, 3, 2),
    ]
    h, cin = 56, 64
    for si, (cmid, n_blocks) in enumerate(block_cfg, 2):
        cout = cmid * 4 if bottleneck else cmid
        for b in range(n_blocks):
            stride = 2 if (b == 0 and si > 2) else 1
            pfx = f"s{si}b{b+1}"
            if bottleneck:
                layers += [
                    conv(f"{pfx}_c1", h, cin, 1, cmid, stride=stride, pad=0),
                    conv(f"{pfx}_c2", h // stride, cmid, 3, cmid),
                    conv(f"{pfx}_c3", h // stride, cmid, 1, cout, pad=0,
                         relu=False),
                ]
            else:
                layers += [
                    conv(f"{pfx}_c1", h, cin, 3, cmid, stride=stride),
                    conv(f"{pfx}_c2", h // stride, cmid, 3, cout, relu=False),
                ]
            if b == 0 and cin != cout:
                layers.append(conv(f"{pfx}_down", h, cin, 1, cout,
                                   stride=stride, pad=0, relu=False))
            h //= stride
            cin = cout
            layers.append(add(f"{pfx}_add", h, cout))
    layers.append(pool("gap", "avgpool", h, cin, h, 1))
    layers.append(fc("fc", cin, 1000, relu=False))
    return layers


def resnet50() -> List[Layer]:
    return _resnet([(64, 3), (128, 4), (256, 6), (512, 3)], bottleneck=True)


def resnet18() -> List[Layer]:
    return _resnet([(64, 2), (128, 2), (256, 2), (512, 2)], bottleneck=False)


NETWORKS = {
    "alexnet": alexnet,
    "vgg16": vgg16,
    "resnet50": resnet50,
    "resnet18": resnet18,
}
WORKLOADS = NETWORKS  # alias


def total_macs(layers: List[Layer]) -> int:
    return sum(l.macs for l in layers)


def gemm_layers(layers: List[Layer]) -> List[Layer]:
    return [l for l in layers if l.kind in ("conv", "fc")]


# ---------------------------------------------------------------------------
# HAWQ-V3 per-layer bitwidths for ResNet18 (paper Table VII).  Vectors are
# transcribed from the table; they apply to the quantized GEMM layers in
# order, and any remaining layers take the final entry.
# ---------------------------------------------------------------------------
HAWQV3_RESNET18 = {
    "int8": [8],
    "high": [8, 8, 8, 8, 8, 8, 8, 8, 4, 8, 8, 8, 4, 8, 4, 8, 4, 8, 4, 8],
    "medium": [8, 8, 8, 8, 8, 4, 8, 8, 4, 8, 8, 4, 4, 8, 4, 8, 4, 4],
    "low": [8, 8, 8, 4, 8, 4, 8, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4],
    "int4": [4],
}
# Accuracy / model size are adopted from HAWQ-V3 [53] (Table VII) — they are
# *inputs* to the EDP-accuracy trade-off, not simulator outputs.
HAWQV3_METADATA = {
    "int4": dict(size_mb=5.6, top1=68.45),
    "low": dict(size_mb=6.1, top1=68.56),
    "medium": dict(size_mb=7.2, top1=70.34),
    "high": dict(size_mb=8.7, top1=70.40),
    "int8": dict(size_mb=11.2, top1=71.56),
}


def per_layer_bits(layers: List[Layer], vec: List[int]) -> List[int]:
    """Expand a Table-VII bit vector over the network's GEMM layers.

    Short vectors extend with their last entry (the paper's rule); a
    vector LONGER than the network's GEMM-layer count is a config/network
    mismatch and raises instead of silently dropping its tail."""
    gl = gemm_layers(layers)
    if len(vec) > len(gl):
        raise ValueError(
            f"bit vector of length {len(vec)} exceeds the network's "
            f"{len(gl)} GEMM (conv/fc) layers — wrong network for this "
            f"configuration?")
    out = []
    for idx in range(len(gl)):
        out.append(vec[idx] if idx < len(vec) else vec[-1])
    return out
