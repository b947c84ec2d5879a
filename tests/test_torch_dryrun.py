"""The dry run (``repro_torch.launch.dryrun``) on fake process groups in this
process (each destroyed after its tests).

* A narrow 2-layer config of each family (dense, MLA, MoE, Mamba stack,
  hybrid, encoder-decoder, VLM) gives an OK training record on a fake (2, 2)
  mesh; granite's prefill and decode do too.
* Its per-device argument bytes equal the sum the reference's specs imply
  (its ``train_state_pspecs`` and ``batch_pspecs``, every dimension here even
  on the mesh, so jax's padded shards and DTensor's split agree).
* On a (1, 1) mesh its per-device flops equal ``FlopCounterMode``'s count of
  the same forward and backward of the unsharded model.
* The two-depth extrapolation (1 and 2 layers) equals the count at 4 layers
  (flops, bytes accessed, collectives by kind).
* The SKIP set is the reference's, with its reasons, for every (arch, shape);
  without a fake group the dry run raises.
"""
import contextlib
import dataclasses
import math

import jax
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES, shape_applicable as j_applicable
from repro.data import specs as jspecs
from repro.launch import mesh as jmesh
from repro.optim import AdamWConfig as JAdamW
from repro.train import state as jstate
from repro_torch.configs import PORTED, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm

torch.set_num_threads(1)

SMALL = ShapeSpec("train_small", 32, 4, "train")
FAMILIES = ["granite-3-8b", "minicpm3-4b", "mixtral-8x7b", "falcon-mamba-7b", "hymba-1.5b", "whisper-small",
            "pixtral-12b"]


def _two_layers(arch: str):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, num_layers=2, **({"enc_layers": 2} if cfg.encdec else {}))


@contextlib.contextmanager
def fake_mesh(shape):
    """A fake group of prod(shape) ranks and its ("data", "model") CPU mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dryrun.start_fake_group(math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_the_dry_run_needs_its_fake_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        dryrun.lower_cell("granite-3-8b", "train_4k")


def test_skips_are_the_references():
    for arch in PORTED:
        for name, shape in SHAPES.items():
            ok, why = j_applicable(jget(arch), JSHAPES[name])
            if not ok:
                rec = dryrun.lower_cell(arch, name)
                assert rec == {"arch": arch, "shape": name, "mesh": "pod16x16", "status": "SKIP", "reason": why}


@pytest.fixture(scope="module")
def records():
    """Each family's training record on a fake (2, 2) mesh, granite's prefill
    and decode, and granite's per-depth counts (1, 2 and 4 layers)."""
    out = {}
    with fake_mesh((2, 2)) as mesh:
        for arch in FAMILIES:
            out[arch] = dryrun.lower_cell(arch, "train_small", mesh=mesh, cfg=_two_layers(arch), shape=SMALL,
                                          tuning=dryrun.TrainTuning())
        g = _two_layers("granite-3-8b")
        out["prefill"] = dryrun.lower_cell("granite-3-8b", "prefill_small", mesh=mesh, cfg=g,
                                           shape=ShapeSpec("prefill_small", 32, 4, "prefill"))
        out["decode"] = dryrun.lower_cell("granite-3-8b", "decode_small", mesh=mesh, cfg=g,
                                          shape=ShapeSpec("decode_small", 32, 4, "decode"))
        g4 = dataclasses.replace(g, num_layers=4)
        plan = lm.ExecPlan(attn_chunk=16, loss_chunk=16, ssm_chunk=16, remat="full")
        out["direct4"] = dryrun.run_step(g4, SMALL, mesh, tmesh.production_rules(), plan,
                                         dryrun.TrainTuning(attn_chunk=16, loss_chunk=16, ssm_chunk=16))
        out["extrapolated4_chunked"] = dryrun.lower_cell(
            "granite-3-8b", "train_small", mesh=mesh, cfg=g4, shape=SMALL,
            tuning=dryrun.TrainTuning(attn_chunk=16, loss_chunk=16, ssm_chunk=16))
    return out


@pytest.mark.parametrize("arch", FAMILIES + ["prefill", "decode"])
def test_each_family_gives_an_ok_record(records, arch):
    r = records[arch]
    assert r["status"] == "OK", r.get("error")
    assert r["chips"] == 4 and r["memory"]["argument_bytes"] > 0 and r["memory"]["temp_bytes"] > 0
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective") and r["fits_hbm"]
    assert sum(v["count"] for v in r["collectives"].values()) > 0


def _ceil_local_bytes(shape, spec, dtype_size, mesh_axes) -> int:
    """One device's bytes of a leaf under a reference spec: jax's ⌈n/k⌉ shards."""
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        k = math.prod(mesh_axes[a] for a in axes)
        n *= -(-d // k)
    return n * dtype_size


def test_argument_bytes_are_the_sum_the_reference_specs_imply(records):
    jcfg = dataclasses.replace(jget("granite-3-8b").reduced(), num_layers=2)
    rules = jmesh.production_rules()
    axes = {"data": 2, "model": 2}
    shapes = jstate.train_state_shapes(jcfg, JAdamW())
    specs = jstate.train_state_pspecs(jcfg, JAdamW(), rules)
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = sum(_ceil_local_bytes(x.shape, tuple(s), x.dtype.itemsize, axes) for x, s in zip(leaves, spec_leaves))
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=SMALL.seq_len, global_batch=SMALL.global_batch)
    bspecs = jspecs.batch_pspecs(jcfg, jshape, rules)
    for k, x in jspecs.input_specs(jcfg, jshape).items():
        want += _ceil_local_bytes(x.shape, tuple(bspecs[k]), x.dtype.itemsize, axes)
    assert records["granite-3-8b"]["memory"]["argument_bytes"] == want


def test_one_rank_flops_equal_flop_counter_mode_of_the_unsharded_model():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.specs import input_specs

    cfg = _two_layers("granite-3-8b")
    tuning = dryrun.TrainTuning(attn_chunk=16, loss_chunk=8)
    with fake_mesh((1, 1)) as mesh:
        rec = dryrun.lower_cell("granite-3-8b", "train_small", mesh=mesh, cfg=cfg, shape=SMALL, tuning=tuning)
    params = lm.meta_params(cfg)
    params.requires_grad_(True)
    plan = lm.ExecPlan(attn_chunk=16, loss_chunk=8, ssm_chunk=tuning.ssm_chunk, remat="full")
    counter = FlopCounterMode(display=False)
    with counter:
        loss, _ = lm.lm_loss(params, cfg, input_specs(cfg, SMALL), plan=plan)
        loss.backward()
    assert rec["status"] == "OK" and rec["cost"]["flops"] == counter.get_total_flops() > 0


def test_two_depth_extrapolation_equals_the_count_at_four_layers(records):
    ext, direct = records["extrapolated4_chunked"], records["direct4"]
    assert ext["depths"] == [1, 2]
    assert ext["cost"]["flops"] == direct["flops"]
    assert ext["cost"]["bytes accessed"] == direct["bytes"]
    from repro_torch.roofline import collectives as C

    want = C.summarize_collectives(direct["collectives"])
    assert {k: v["count"] for k, v in ext["collectives"].items()} == {k: v["count"] for k, v in want.items()}
    assert {k: v["bytes"] for k, v in ext["collectives"].items()} == {k: v["bytes"] for k, v in want.items()}


@pytest.mark.parametrize("seq,remat", [(4096, "full"), (32768, "dots"), (0, "none")])
def test_analysis_plan_is_the_references(seq, remat):
    from repro.models import lm as jlm

    want, got = jlm.analysis_plan(seq, remat=remat), lm.analysis_plan(seq, remat=remat)
    assert (got.attn_chunk, got.loss_chunk, got.ssm_chunk, got.remat) == (
        want.attn_chunk, want.loss_chunk, want.ssm_chunk, want.remat)
