"""The lowering report's op counter (``repro_torch.launch.opcost``), the
kernels' fake branches and ``work`` functions, and the recording mesh.

Everything here runs on fake tensors (``launch/specs.fake_mode``): FLOPs
by product and type, bytes, the live-storage high-water mark, each
wrapper's launch on a fake CUDA tensor (one launch under its ``plan()``
key, none of its plain version's ops), the ``work`` of one shape per
kernel (the bounds of ``chip_smoke.py``'s table), and the collectives a
``RecordingMesh`` records in the reference's convention.
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

from repro_torch import dist, kernels  # noqa: E402
from repro_torch.kernels import bitplane_matmul as bpm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int4_matmul as i4mm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.launch import dryrun, opcost, specs  # noqa: E402


def _fake(shape, dtype, device="cpu"):
    with specs.fake_mode():
        return torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("n", [1, 3, 7])
def test_a_python_loop_of_products_counts_each_trip(n):
    a, b = _fake((64, 128), torch.bfloat16), _fake((128, 32), torch.bfloat16)

    def prog():
        for _ in range(n):
            a @ b

    with specs.fake_mode():
        _, c = opcost.count(prog)
    assert c.flops == {"bf16": n * 2.0 * 64 * 32 * 128}
    assert c.by_op == {"mm.default": n}
    assert c.bytes == c.bytes_floor == n * 2 * (64 * 128 + 128 * 32
                                                 + 64 * 32)


def test_flops_are_bucketed_by_operand_type():
    x8, w8 = _fake((32, 64), torch.int8), _fake((64, 16), torch.int8)
    xf, wf = _fake((4, 8, 16), torch.float32), _fake((4, 16, 2),
                                                      torch.float32)
    xb = _fake((3, 5, 7), torch.bfloat16)
    wb = _fake((7, 11), torch.bfloat16)
    with specs.fake_mode():
        _, c = opcost.count(lambda: (torch._int_mm(x8, w8),
                                     torch.bmm(xf, wf),
                                     torch.einsum("bsk,kn->bsn", xb, wb)))
    assert c.flops == {"int8": 2.0 * 32 * 16 * 64,
                       "f32": 2.0 * 4 * 8 * 2 * 16,
                       "bf16": 2.0 * 3 * 5 * 11 * 7}


def test_views_and_empty_count_no_bytes_and_storages_free():
    x = _fake((256, 256), torch.float32)

    def prog():
        v = x.view(-1).reshape(512, 128).t()[::2]
        torch.empty((1024,), dtype=torch.float32)
        y = x * 2                      # 256 KiB live
        z = y + 1                      # 512 KiB at the peak
        del y
        return z, v

    with specs.fake_mode():
        (z, _), c = opcost.count(prog)
    nb = 256 * 256 * 4
    assert c.bytes == 4 * nb                 # mul and add: in and out
    assert c.bytes_floor == 0 and c.flops == {}
    assert c.peak_bytes == 2 * nb            # the empty's died at once
    assert c.live_bytes == nb                # z alone survives
    assert opcost.tree_bytes({"x": x, "v": [x.t(), x[1]]}) == nb


def test_autograd_saved_tensors_count_in_the_peak():
    w = _fake((128, 128), torch.float32).requires_grad_(True)
    x = _fake((64, 128), torch.float32)

    def prog():
        h = torch.tanh(x @ w)          # tanh's output is saved
        return torch.autograd.grad(h.sum(), w)[0]

    with specs.fake_mode():
        _, c = opcost.count(prog)
    assert c.flops["f32"] == 2 * 2.0 * 64 * 128 * 128   # forward, dw
    assert c.peak_bytes >= 2 * 64 * 128 * 4


def _launch_cases():
    x8 = _fake((16, 2560), torch.int8, "cuda")
    xl = _fake((4096, 2560), torch.int8, "cuda")
    w8 = _fake((2560, 4096), torch.int8, "cuda")
    wp = _fake((2560, 2048), torch.uint8, "cuda")
    s = _fake((1, 4096), torch.float32, "cuda")
    q = _fake((32, 4096, 128), torch.bfloat16, "cuda")
    return [
        ("bitplane_matmul", lambda: bpm.bitplane_matmul(x8, w8, n_planes=4),
         ("bitplane_matmul", bpm.plan(16, 2560, 4096).path, 4, 16, 2560,
          4096), bpm.work(16, 2560, 4096)),
        ("bitplane_matmul", lambda: bpm.bitplane_matmul(xl, w8, n_planes=8),
         ("bitplane_matmul", "large_m", 8, 4096, 2560, 4096),
         bpm.work(4096, 2560, 4096)),
        ("int4_matmul", lambda: i4mm.int4_matmul(xl, wp, s),
         ("int4_matmul", i4mm.plan(4096, 2560, 4096).path),
         i4mm.work(4096, 2560, 4096)),
        ("quant_matmul", lambda: qmm.quant_matmul(x8, w8, s, s, act="silu",
                                                  out_dtype=torch.bfloat16),
         ("quant_matmul", "silu", qmm.plan(16, 2560, 4096).path),
         qmm.work(16, 2560, 4096, 2)),
        ("flash_attention", lambda: fa.flash_attention(q, q, q, causal=True),
         ("flash_attention", 128, True, 0),
         fa.work(32, 4096, 4096, 128, True)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_each_wrapper_launches_once_on_a_fake_card_tensor(case):
    """A fake CUDA tensor plans and allocates as the card does, reports
    one launch under the key a card run would, runs none of the plain
    version's ops, and is priced by the kernel's ``work``; the launch
    counters, which count real launches, do not move."""
    name, call, key, (ops, nbytes) = _launch_cases()[case]
    before = kernels.launch_keys()
    with specs.fake_mode():
        out, c = opcost.count(call)
    assert out.device.type == "cuda"
    assert c.kernels == {key: 1}
    assert kernels.launches_since(before) == {}
    assert set(c.by_op) <= {"empty.memory_format"}      # out and scratch
    peak = {"bitplane_matmul": 1979e12, "int4_matmul": 1979e12,
            "quant_matmul": 1979e12, "flash_attention": 989e12}[name]
    assert c.kernel_work == {name: [ops, nbytes,
                                    max(ops / peak, nbytes / 3.35e12)]}
    assert c.bytes == c.bytes_floor == nbytes
    assert sum(c.flops.values()) == ops


def test_as_card_takes_the_fake_branch_for_fake_cpu_tensors_only():
    """Under ``kernels.as_card`` a fake CPU tensor stands for the card's
    (the flash wrapper pads hd 80 to 128 and slices it back); a real CPU
    tensor still takes the plain version and counts nothing."""
    q = _fake((4, 256, 80), torch.bfloat16)
    before = kernels.launch_keys()
    with specs.fake_mode(), kernels.as_card():
        out, c = opcost.count(lambda: kops.flash_attention(q, q, q))
    assert out.shape == (4, 256, 80)
    assert c.kernels == {("flash_attention", 128, True, 0): 1}
    assert "bmm.default" not in c.by_op
    x = torch.randint(-8, 8, (3, 5), dtype=torch.int8)
    w = torch.randint(-8, 8, (5, 7), dtype=torch.int8)
    with kernels.as_card():
        got = bpm.bitplane_matmul(x, w, n_planes=8)
    assert torch.equal(got, bpm.bitplane_matmul_ref(x, w, 8))
    assert kernels.launches_since(before) == {}


def test_work_pins_one_shape_per_kernel():
    """The bounds of ``chip_smoke.py``'s kernel table read these."""
    assert bpm.work(4, 2560, 4096) == (2.0 * 4 * 4096 * 2560,
                                       4 * 2560 + 2560 * 4096 + 16 * 4096)
    assert i4mm.work(16, 9216, 4096) == (2.0 * 16 * 4096 * 9216,
                                         16 * 9216 + 9216 * 2048 + 4 * 4096
                                         + 4 * 16 * 4096)
    assert qmm.work(2704, 1728, 128, 2) == (2.0 * 2704 * 128 * 1728,
                                            2704 * 1728 + 1728 * 128
                                            + 8 * 128 + 2 * 2704 * 128)
    assert fa.work(128, 4096, 4096, 128, True) == (
        4.0 * 128 * 4096 * 4096 * 128 / 2, 2 * 128 * 8192 * 128 * 2)
    # a causal band counts exactly the visible pairs
    assert fa.work(1, 8, 8, 1, True, 3)[0] == 4 * (1 + 2 + 3 * 6)
    assert fa.work(1, 2, 10, 1, True, 4)[0] == 4 * (4 + 4)


def test_recording_mesh_overrides_every_collective_of_mesh():
    """Every method of Mesh that calls torch.distributed is overridden,
    so a future collective cannot reach a process group the recording
    mesh does not have."""
    for name, fn in inspect.getmembers(dist.Mesh, inspect.isfunction):
        if "tdist." in inspect.getsource(fn):
            assert fn is not getattr(dist.RecordingMesh, name), name


def test_recording_mesh_records_in_the_reference_convention():
    mesh = dist.RecordingMesh((2, 8), rank=0)
    x = _fake((4, 16), torch.bfloat16)
    with specs.fake_mode():
        mesh.all_reduce(x, mesh.tp_axes, "sum", kind="acc_tp")
        g = mesh.all_gather(x, mesh.dp_axes, dim=1, kind="gather_weight")
        mesh.broadcast(x, 0, kind="move_row")
        mesh.all_reduce(x, (), "max")              # no live axis: nothing
    assert g.shape == (4, 32)
    assert mesh.counts == {"acc_tp": [1, 128], "gather_weight": [1, 128],
                           "move_row": [1, 128]}
    rep = dryrun.collective_report(mesh)
    assert rep["kinds"] == {"all-reduce": {"count": 1, "bytes": 128},
                            "all-gather": {"count": 1, "bytes": 256},
                            "broadcast": {"count": 1, "bytes": 128}}
    assert rep["traffic"] == 2 * 128 + 256 + 128
    # the model line (8 ranks) lies in one node; the data line crosses
    links = {(r["collective"], tuple(r["axes"])): r["link"]
             for r in rep["by_axes"]}
    assert links == {("all-reduce", ("model",)): "nvlink",
                     ("all-gather", ("data",)): "nic",
                     ("broadcast", ("data",)): "nic"}
    assert rep["seconds"] == pytest.approx(256 / 450e9 + 384 / 50e9)
    prod = dist.RecordingMesh((16, 16), rank=37)
    assert prod.coords == {"data": 2, "model": 5}
    assert dryrun.link(prod, ("model",)) == "nic"    # 16 ranks, two nodes
    assert dryrun.link(dist.RecordingMesh((32, 8)), ("model",)) == "nvlink"
