"""The port's roofline (``repro_torch.roofline``) against the reference's
arithmetic, and its collective records against a count by hand.

* ``tests/test_roofline.py``'s cases through both packages: the reference's
  parsed HLO collectives as the port's records (same kind, bytes, group size
  and host crossing), their wire bytes, their per-kind aggregate and its
  seconds (the reference dry run's ``_collective_agg`` and
  ``_collective_seconds``), ``roofline_terms`` on the same cost and figures,
  ``extrapolate``, ``extrapolate_cell`` and ``model_flops_for`` on every
  config of ``PORTED`` and shape of ``SHAPES``.
* The H100 figures (NVIDIA's data sheet, SXM, dense, 700 W) that the kernel
  bounds of ``chip_smoke.py`` read.
* A bf16 SwiGLU's two products on a fake (16, 16) mesh (this process rank 0
  of 256; the group destroyed after), recorded by the dry run's counter: W1
  [Shard(0), Shard(1)], W2 [Shard(1), Shard(0)], x [Shard(0), Replicate()].
  DTensor gathers each weight's fsdp shard over "data" (2 all-gathers of
  d·f/16 bf16 each, groups of 16 that span two hosts of 8), and nothing else;
  the local flops are those of the two local products.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.roofline import collectives as JC
from repro.roofline import model as jrl
from repro.roofline.hw import V5E
from repro_torch.configs import PORTED, SHAPES, get_config
from repro_torch.roofline import collectives as C
from repro_torch.roofline import model as rl
from repro_torch.roofline.hw import H100_SXM, HwSpec

torch.set_num_threads(1)

HLO = """
ENTRY %main {
  %ag = f32[4096,512]{1,0} all-gather(%x), channel_id=1, replica_groups={{0,1,2,3}}, dimensions={1}
  %ar = bf16[1024]{0} all-reduce(%y), channel_id=2, replica_groups=[32,16]<=[512], use_global_device_ids=true
  %rs = f32[256,128]{1,0} reduce-scatter(%z), channel_id=3, replica_groups={{0,256}}, dimensions={0}
  %cp = f32[64]{0} collective-permute(%w), channel_id=4, source_target_pairs={{0,256},{256,0}}
  %a2a = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-to-all(%p, %q), replica_groups={{0,1}}
  %dot = f32[128,128]{1,0} dot(%a, %b)
}
"""
# The reference's V5E figures as a port HwSpec: the arithmetic compared on the same numbers.
V5E_AS_PORT = HwSpec(name=V5E.name, peak_flops_bf16=V5E.peak_flops_bf16, hbm_bw=V5E.hbm_bw,
                     ici_link_bw=V5E.ici_link_bw, ici_links=V5E.ici_links, hbm_bytes=V5E.hbm_bytes, dcn_bw=V5E.dcn_bw)


def _as_port(ops):
    return [C.CollectiveOp(o.kind, o.bytes, o.group_size, o.crosses_pod) for o in ops]


def _reference_dryrun():
    """The reference's ``launch.dryrun``, whose import sets ``XLA_FLAGS``: the
    variable is put back as it was, for the tests that run after these."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.mark.parametrize("pod_size", [None, 256])
def test_wire_bytes_and_seconds_match_the_reference(pod_size):
    jdry = _reference_dryrun()
    jops = JC.parse_collectives(HLO, pod_size=pod_size)
    tops = _as_port(jops)
    assert [C.op_wire_bytes(t) for t in tops] == [JC.op_wire_bytes(j) for j in jops]
    got = C.summarize_collectives(tops)
    assert got == jdry._collective_agg(HLO, pod_size)
    want = JC.summarize_collectives(jops)
    assert {k: (v["count"], v["bytes"], v["wire_bytes"]) for k, v in got.items()} == {
        k: (v["count"], v["bytes"], v["wire_bytes"]) for k, v in want.items()}
    assert C.collective_seconds(got, ici_bw=V5E.ici_link_bw, dcn_bw=V5E.dcn_bw) == jdry._collective_seconds(got)


def test_wire_bytes_model():
    by = {o.kind: o for o in _as_port(JC.parse_collectives(HLO))}
    np.testing.assert_allclose(C.op_wire_bytes(by["all-reduce"]), 2 * 15 / 16 * 2048)
    np.testing.assert_allclose(C.op_wire_bytes(by["all-gather"]), 3 / 4 * 4096 * 512 * 4)
    np.testing.assert_allclose(C.op_wire_bytes(by["collective-permute"]), 64 * 4)


@pytest.mark.parametrize("cost", [{"flops": 1e12, "bytes accessed": 1e9}, {"flops": 3e9, "bytes accessed": 7e11},
                                  {"flops": 0.0, "bytes accessed": 0.0}])
def test_roofline_terms_match_the_reference(cost):
    """The reference's ``roofline_terms`` costs each parsed op; the port's costs
    their per-kind aggregate, as the reference's dry run does. Every term is
    the reference's; the breakdown is its dry run's."""
    jdry = _reference_dryrun()
    jr = jrl.roofline_terms(arch="x", shape="train_4k", mesh="pod16x16", chips=256, cost=cost, hlo_text=HLO,
                            model_flops=1e14, pod_size=256)
    agg = C.summarize_collectives(_as_port(JC.parse_collectives(HLO, pod_size=256)))
    tr = rl.roofline_terms(arch="x", shape="train_4k", mesh="pod16x16", chips=256, cost=cost, collectives=agg,
                           model_flops=1e14, hw=V5E_AS_PORT)
    assert tr.collective == jdry._collective_seconds(agg)
    got, want = dataclasses.asdict(tr), dataclasses.asdict(jr)
    del got["collective"], want["collective"], want["memory_analysis"]
    assert got == want
    assert tr.table_row() == jr.table_row()


def test_roofline_terms_on_the_h100():
    rr = rl.roofline_terms(arch="x", shape="train_4k", mesh="pod16x16", chips=256,
                           cost={"flops": 1e12, "bytes accessed": 1e9}, collectives={}, model_flops=1e14)
    assert rr.compute_s == 1e12 / 989e12 and rr.memory_s == 1e9 / 3.35e12 and rr.collective_s == 0.0
    assert rr.bottleneck == "compute" and rr.roofline_fraction == 1.0


@pytest.mark.parametrize("L1,L2,L", [(1, 2, 40), (6, 12, 48), (1, 2, 4), (1, 2, 2)])
def test_extrapolation_matches_the_reference(L1, L2, L):
    c1 = {"flops": 100.0, "bytes accessed": 40.0, "utilization0{}": 1.0}
    c2 = {"flops": 150.0, "bytes accessed": 55.0}
    a1 = {"all-reduce": {"count": 2, "bytes": 10.0, "wire_bytes": 10.0, "dcn_wire_bytes": 0.0}}
    a2 = {"all-reduce": {"count": 3, "bytes": 15.0, "wire_bytes": 15.0, "dcn_wire_bytes": 0.0},
          "all-gather": {"count": 1, "bytes": 4.0, "wire_bytes": 3.0, "dcn_wire_bytes": 3.0}}
    assert rl.extrapolate(10.0, 20.0, L1, L2, L) == jrl.extrapolate(10.0, 20.0, L1, L2, L)
    assert rl.extrapolate(20.0, 10.0, L1, L2, L) == jrl.extrapolate(20.0, 10.0, L1, L2, L)
    assert rl.extrapolate_cell(c1, c2, a1, a2, L1, L2, L) == jrl.extrapolate_cell(c1, c2, a1, a2, L1, L2, L)


@pytest.mark.parametrize("arch", PORTED)
def test_model_flops_match_the_reference(arch):
    for name, shape in SHAPES.items():
        assert rl.model_flops_for(get_config(arch), shape, mode=shape.mode) == jrl.model_flops_for(
            jget(arch), JSHAPES[name], mode=shape.mode)


def test_h100_figures():
    h = H100_SXM
    assert (h.peak_flops_bf16, h.peak_flops_tf32, h.peak_flops_fp32, h.peak_int32_ops) == (989e12, 495e12, 67e12,
                                                                                            16.7e12)
    assert (h.hbm_bw, h.ici_link_bw, h.dcn_bw, h.host_size) == (3.35e12, 450e9, 50e9, 8)
    assert 79e9 < h.hbm_bytes < 86e9


@pytest.fixture(scope="module")
def fake256():
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    dryrun.start_fake_group(256)
    yield
    dist.destroy_process_group()


def test_swiglu_collectives_on_a_fake_mesh_match_a_count_by_hand(fake256):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu")
    d, f, B, S = 4096, 12800, 256, 64
    meta = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device="meta")
    w1 = sharding.shard_tensor(meta(d, f), mesh, (Shard(0), Shard(1)))
    w2 = sharding.shard_tensor(meta(f, d), mesh, (Shard(1), Shard(0)))
    x = sharding.shard_tensor(meta(B * S, d), mesh, (Shard(0), Replicate()))
    mode = dryrun.StepCounter()
    with mode:
        y = (x @ w1) @ w2
    by_hand = [C.CollectiveOp("all-gather", d * (f // 16) * 2, 16, True)] * 2
    assert mode.collectives == by_hand
    # the local products: x (B·S/16, d) by the gathered W1 (d, f/16), then by W2 (f/16, d)
    assert mode.flops == 2 * (2 * (B * S // 16) * d * (f // 16))
    assert C.summarize_collectives(mode.collectives) == {"all-gather": {
        "count": 2.0, "bytes": 2.0 * d * (f // 16) * 2, "wire_bytes": 2 * 15 / 16 * d * (f // 16) * 2,
        "dcn_wire_bytes": 2 * 15 / 16 * d * (f // 16) * 2}}
    from torch.distributed.tensor import Partial

    assert tuple(y.placements) == (Shard(0), Partial()) and tuple(y.to_local().shape) == (B * S // 16, d)
