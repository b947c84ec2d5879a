"""Dry run: every (arch × shape) cell's step on the production meshes, on meta
DTensors in a fake process group, counted per device.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each cell
on 512 host devices and never runs it; here the cell's step runs once on
``meta`` tensors (no memory, no arithmetic) placed as DTensors on a
``DeviceMesh`` of a fake process group of 256 or 512 ranks, this process
being rank 0. That is the reference's dry run in PyTorch's terms, not a
fallback: without the fake group the dry run raises.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k \\
        --mesh single --out results/dryrun_torch

``--mesh smoke`` runs one cell at one rank (a fake group of 1, the (1, 1)
``make_smoke_mesh``), optionally cut to ``--layers`` with a ``--batch`` ×
``--seq`` training shape: the step the card's check counts and allocates.

What a cell records (one JSON each):

  * **memory** — ``argument_bytes``: the local shard bytes of everything the
    step takes (the train state with its AdamW moments, or the parameters and
    the cache, and the inputs), summed exactly from the placements.
    ``temp_bytes``: the live peak of the step's own tensors, from a dispatch
    mode that adds each new storage's local bytes when an op makes it and
    takes them off when the storage dies (a storage finalizer); views and
    in-place results add nothing. ``fits_hbm`` holds their sum against the
    card's memory (``roofline.hw.H100_SXM``; the reference had
    ``fits_16gb_hbm``).
  * **cost** — per device, counted on the local ops only (DTensor-level ops
    are passed through to run on their shards, whose ops are counted):
    ``flops`` by ``torch.utils.flop_counter``'s formulas on each local op, as
    ``FlopCounterMode`` applies them (composite ops decomposed first);
    ``bytes accessed``: each local op's inputs read and outputs written
    (views, factories and collectives move nothing here).
  * **collectives** — each ``_c10d_functional`` op DTensor issues
    (``roofline.collectives``), costed on NVLink inside a host of 8 and on
    the network across hosts.

Cost and memory come from two depth-reduced runs (the reference's analysis
depths L1, L2: 1 and 2 layers, gemma3's 6 and 12) extrapolated linearly to
the config's depth, as the reference does, with the production plan's chunk
sizes (the port's loops are Python loops: every trip is counted). A cell at
or below L2 layers runs at its own depth. ``lower_cell(mesh=...)`` takes any
mesh (a one-rank ``make_smoke_mesh`` for the card's check): there each
DTensor's one shard is the whole tensor, and the local ops counted are the
plain program's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import PORTED
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec, get_config, shape_applicable
from repro_torch.data.specs import batch_pspecs, input_specs
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_production_mesh, production_rules
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.roofline import collectives as C
from repro_torch.roofline import model as rl
from repro_torch.roofline.hw import H100_SXM
from repro_torch.train import state as tstate

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")


@dataclasses.dataclass
class TrainTuning:
    accum_steps: int = 1
    moment_dtype: str = "float32"
    remat: str = "full"
    loss_chunk: int = 512
    attn_chunk: int = 1024
    ssm_chunk: int = 128
    accum_dtype: str = "float32"


# The reference's per-arch tuning. The dry run runs one microbatch of
# global_batch / accum_steps rows and scales the step's cost by accum_steps.
TRAIN_TUNING: Dict[str, TrainTuning] = {
    "grok-1-314b": TrainTuning(accum_steps=16, moment_dtype="bfloat16", accum_dtype="bfloat16"),
    "pixtral-12b": TrainTuning(accum_steps=2),
    "gemma3-12b": TrainTuning(accum_steps=2),
    "mixtral-8x7b": TrainTuning(accum_steps=4),
    "falcon-mamba-7b": TrainTuning(accum_steps=2, ssm_chunk=64),
    "hymba-1.5b": TrainTuning(accum_steps=2, ssm_chunk=64),
}

# Archs whose parameter+optimizer footprint needs FSDP to span the pod axis on the
# multi-pod mesh (512-way instead of 256-way parameter sharding).
POD_FSDP_ARCHS = {"grok-1-314b"}
HOST_SIZE = H100_SXM.host_size


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _analysis_depths(cfg: ArchConfig) -> Tuple[int, int]:
    if cfg.attn_kind == "local_global" and cfg.local_global_ratio > 0:
        p = cfg.local_global_ratio + 1
        return p, 2 * p
    return 1, 2


def _with_depth(cfg: ArchConfig, L: int) -> ArchConfig:
    changes = {"num_layers": L}
    if cfg.encdec:
        changes["enc_layers"] = L
    return dataclasses.replace(cfg, **changes)


# ------------------------------------------------------------------ the fake group


def start_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of ``world_size`` ranks
    (collectives return at once, with outputs of the right shapes). A group
    already up must be that one."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(f"the dry run needs a fake group of {world_size} ranks; a "
                               f"{dist.get_backend()} group of {dist.get_world_size()} is up")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _require_fake_group() -> None:
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("the dry run runs in a fake process group (start_fake_group); none is up")


# ------------------------------------------------------------------ counting


_SKIP_BYTES = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach", "alias",
               "lift_fresh", "_to_copy_meta")


class StepCounter(TorchDispatchMode):
    """Per-device flops, bytes accessed, collectives and the live peak of the
    step run inside it, on the local ops only (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, out, in_keys: set) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in in_keys or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation: the op on global-shape fake
            # tensors, for its output's metadata only (not a local op).
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        ins = _tensors((args, kwargs))
        in_keys = {t.untyped_storage()._cdata for t in ins}
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        if C.is_collective(func):
            rec = C.record(func, args, kwargs, out, HOST_SIZE)
            if rec is not None:
                self.collectives.append(rec)
        elif not func.is_view and func._opname not in _SKIP_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in _tensors(out))
        self._track(out, in_keys)
        return out


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_bytes(t) -> int:
    return _nbytes(t.to_local() if sharding.is_dtensor(t) else t)


# ------------------------------------------------------------------ placing


def _place(t: torch.Tensor, mesh, spec):
    """``t`` as a DTensor placed by ``spec`` on ``mesh``."""
    return sharding.shard_tensor(t, mesh, sharding.to_placements(spec, mesh))


def sharded_params(cfg: ArchConfig, mesh, rules: ShardingRules) -> lm.LM:
    """The model on ``meta`` DTensors, each parameter placed by ``rules``."""
    named = {n: p.detach() for n, p in lm.meta_params(cfg).named_parameters()}
    specs = sharding.named_pspecs(named, rules)
    return lm.params_from_named(cfg, {n: _place(t, mesh, specs[n]) for n, t in named.items()})


def _sharded_moments(params: lm.LM, opt_cfg: AdamWConfig, rules: ShardingRules, mesh) -> list:
    """AdamW's two moments of every parameter, placed as their parameter (meta)."""
    dt = torch.bfloat16 if opt_cfg.moment_dtype == "bfloat16" else torch.float32
    named = dict(params.named_parameters())
    specs = sharding.named_pspecs(named, rules)
    return [_place(torch.empty(p.shape, dtype=dt, device="meta"), mesh, specs[n])
            for n, p in named.items() for _ in range(2)]


def _sharded_batch(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules) -> dict:
    specs = batch_pspecs(cfg, shape, rules)
    return {k: _place(v, mesh, specs[k]) for k, v in input_specs(cfg, shape).items()}


# ------------------------------------------------------------------ one cell


def _micro(shape: ShapeSpec, accum_steps: int) -> ShapeSpec:
    if accum_steps <= 1:
        return shape
    return dataclasses.replace(shape, global_batch=shape.global_batch // accum_steps)


def run_step(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: Optional[ShardingRules], plan: lm.ExecPlan,
             tuning: TrainTuning) -> Dict[str, Any]:
    """Place the cell's arguments on ``mesh`` and run its step under a
    :class:`StepCounter`: a training microbatch's loss and backward, the
    batched prefill, or one decode step. Returns {"argument_bytes", "flops",
    "bytes", "temp_bytes", "collectives" (the records)}.

    The step runs twice and the second run is the one counted: DTensor's
    first dispatch of an op computes and caches its sharding, making
    tensors of its own on the way, which would count in the live peak."""
    _require_fake_group()
    _step_once(cfg, shape, mesh, rules, plan, tuning)
    return _step_once(cfg, shape, mesh, rules, plan, tuning)


def _step_once(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: Optional[ShardingRules], plan: lm.ExecPlan,
               tuning: TrainTuning) -> Dict[str, Any]:
    params = sharded_params(cfg, mesh, rules)
    args = list(params.parameters())
    if shape.mode == "train":
        args += _sharded_moments(params, AdamWConfig(moment_dtype=tuning.moment_dtype), rules, mesh)
        micro = _micro(shape, tuning.accum_steps)
        batch = _sharded_batch(cfg, micro, mesh, rules)
    else:
        batch = _sharded_batch(cfg, shape, mesh, rules)
    args += list(batch.values())
    counter = StepCounter()
    if shape.mode == "train":
        params.requires_grad_(True)
        with counter, lm.sharded_region(params):
            loss, _ = lm.lm_loss(params, cfg, batch, rules=rules, plan=plan)
            loss.backward()
        del loss
    elif shape.mode == "prefill":
        with counter:
            out = lm.batched_prefill(params, cfg, batch, cache_len=shape.seq_len, rules=rules, plan=plan)
        del out
    else:
        batch_sharded = shape.global_batch > 1
        cache = lm.sharded_cache(cfg, shape.global_batch, shape.seq_len, mesh, rules, batch_sharded=batch_sharded,
                                 device="meta")
        args += list(sharding.spec_leaves(cache).values())
        tokens = batch["tokens"]
        if not batch_sharded and sharding.is_dtensor(tokens):
            tokens = tokens.redistribute(mesh, sharding.to_placements((), mesh))
        with counter:
            out = lm.decode_step(params, cfg, tokens, cache, shape.seq_len - 1, rules=rules)
        del out
    scale = tuning.accum_steps if shape.mode == "train" else 1
    return {"argument_bytes": sum(_local_bytes(t) for t in args), "flops": counter.flops * scale,
            "bytes": counter.bytes * scale, "temp_bytes": counter.peak,
            "collectives": counter.collectives * scale}


def _param_bytes(cfg: ArchConfig, mesh, rules: ShardingRules, itemsize: int) -> int:
    """The local bytes of one tensor per parameter, placed as it, of ``itemsize``."""
    named = dict(lm.meta_params(cfg).named_parameters())
    return sum(sharding.local_count(named[n].shape, mesh, sharding.to_placements(spec, mesh)) * itemsize
               for n, spec in sharding.named_pspecs(named, rules).items())


def train_state_argument_bytes(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh, rules: ShardingRules) -> int:
    """The local bytes of the whole train state (parameters, moments, count,
    step) under ``rules`` on ``mesh``, from its shapes and placements alone."""
    shapes = sharding.spec_leaves(tstate.checkpoint_tree(tstate.train_state_shapes(cfg, opt_cfg)))
    specs = sharding.spec_leaves(tstate.train_state_pspecs(cfg, opt_cfg, rules))
    return sum(sharding.local_count(tuple(shapes[p].shape), mesh, sharding.to_placements(s, mesh))
               * shapes[p].dtype.itemsize for p, s in specs.items())


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, mesh=None, cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeSpec] = None, tuning: Optional[TrainTuning] = None,
               rules_override: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """One cell's record. ``mesh`` (default: the production mesh of
    ``multi_pod``), ``cfg`` and ``shape`` (default: the registry's) may be
    given; the fake group must be up with the mesh's ranks."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_tag = _mesh_tag(multi_pod) if mesh is None else "x".join(map(str, mesh.shape))
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    if not ok:
        return {**base, "status": "SKIP", "reason": why}
    _require_fake_group()
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = rules_override or production_rules(multi_pod=multi_pod)
    if multi_pod and arch in POD_FSDP_ARCHS and rules_override is None:
        rules = dataclasses.replace(rules, fsdp=("pod", "data"))
    chips = mesh.size()
    tuning = tuning or (TRAIN_TUNING.get(arch, TrainTuning()) if shape.mode == "train" else TrainTuning())
    plan = lm.ExecPlan(attn_chunk=tuning.attn_chunk, loss_chunk=tuning.loss_chunk, ssm_chunk=tuning.ssm_chunk,
                       remat=tuning.remat)

    t0 = time.perf_counter()
    L1, L2 = _analysis_depths(cfg)
    L = cfg.num_layers
    if L <= L2:
        runs = [run_step(cfg, shape, mesh, rules, plan, tuning)]
    else:
        runs = [run_step(_with_depth(cfg, Lk), shape, mesh, rules, plan, tuning) for Lk in (L1, L2)]
    run_s = time.perf_counter() - t0
    costs = [{"flops": float(r["flops"]), "bytes accessed": float(r["bytes"]), "temp_bytes": float(r["temp_bytes"])}
             for r in runs]
    aggs = [C.summarize_collectives(r["collectives"]) for r in runs]
    if len(runs) == 1:
        cost, agg = costs[0], aggs[0]
    else:
        cost, agg = rl.extrapolate_cell(costs[0], costs[1], aggs[0], aggs[1], L1, L2, L)

    if shape.mode == "train":
        opt_cfg = AdamWConfig(moment_dtype=tuning.moment_dtype)
        state_bytes = train_state_argument_bytes(cfg, opt_cfg, mesh, rules)
        batch_bytes = sum(_local_bytes(t) for t in _sharded_batch(cfg, _micro(shape, tuning.accum_steps), mesh,
                                                                   rules).values())
        arg_bytes = state_bytes + batch_bytes
    else:
        arg_bytes = runs[-1]["argument_bytes"] if len(runs) == 1 else int(rl.extrapolate(
            runs[0]["argument_bytes"], runs[1]["argument_bytes"], L1, L2, L))
    temp = int(cost["temp_bytes"])
    if shape.mode == "train" and tuning.accum_steps > 1:  # the gradient accumulator, one per parameter
        acc = 2 if tuning.accum_dtype == "bfloat16" else 4
        temp += _param_bytes(cfg, mesh, rules, acc)
    mem = {"argument_bytes": int(arg_bytes), "temp_bytes": temp, "peak_bytes": int(arg_bytes) + temp}
    r = rl.roofline_terms(arch=arch, shape=shape_name, mesh=mesh_tag, chips=chips, cost=cost, collectives=agg,
                          model_flops=rl.model_flops_for(cfg, shape, mode=shape.mode))
    terms = {k: getattr(r, k) for k in ("compute_s", "memory_s", "collective_s", "bottleneck", "step_s",
                                        "model_flops", "useful_fraction", "roofline_fraction")}
    return {
        **base,
        "status": "OK",
        "chips": chips,
        "mode": shape.mode,
        "depths": [L1, L2] if len(runs) == 2 else [L],
        "run_s": round(run_s, 2),
        "memory": mem,
        "fits_hbm": bool(mem["peak_bytes"] <= H100_SXM.hbm_bytes),
        "hw": H100_SXM.name,
        "cost": {"flops": r.flops_per_device, "bytes accessed": r.bytes_per_device},
        "collectives": agg,
        "roofline": {**terms, "collective_detail": r.collective},
        "tuning": dataclasses.asdict(tuning) if shape.mode == "train" else None,
    }


def run_cells(archs, shapes, meshes, out_dir: str, *, resume: bool = True):
    """Each cell's record, written to ``out_dir/<arch>_<shape>_<mesh>.json``."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for mesh_name in meshes:
        multi_pod = mesh_name == "multi"
        start_fake_group(512 if multi_pod else 256)
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}_{shape_name}_{_mesh_tag(multi_pod)}"
                path = os.path.join(out_dir, tag + ".json")
                if resume and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    print(f"[dryrun] {tag}: cached ({rec['status']})", flush=True)
                    results.append(rec)
                    continue
                print(f"[dryrun] {tag}: running...", flush=True)
                try:
                    rec = lower_cell(arch, shape_name, multi_pod=multi_pod)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod), "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "OK":
                    m, r = rec["memory"], rec["roofline"]
                    print(f"[dryrun] {tag}: OK run={rec['run_s']}s args={m['argument_bytes'] / 2**30:.2f}GiB "
                          f"temp={m['temp_bytes'] / 2**30:.2f}GiB fits={rec['fits_hbm']} "
                          f"bottleneck={r['bottleneck']} terms=({r['compute_s'] * 1e3:.1f},"
                          f"{r['memory_s'] * 1e3:.1f},{r['collective_s'] * 1e3:.1f})ms "
                          f"useful={r['useful_fraction']:.2f} roofline={r['roofline_fraction']:.2f}", flush=True)
                else:
                    print(f"[dryrun] {tag}: {rec['status']} {rec.get('reason', rec.get('error', ''))}", flush=True)
                results.append(rec)
        _end_group()
    return results


def run_smoke_cell(arch: str, shape_name: str, out_dir: str, *, layers: Optional[int] = None,
                   batch: Optional[int] = None, seq: Optional[int] = None) -> Dict[str, Any]:
    """One cell on a one-rank fake group and its (1, 1) smoke mesh, cut to
    ``layers`` (and, for ``batch``/``seq``, a training shape of that size);
    its record written to ``out_dir/<arch>_<shape>_1x1.json``."""
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = get_config(arch)
    if layers:
        cfg = _with_depth(cfg, layers)
    shape = SHAPES.get(shape_name)
    if batch or seq:
        shape_name = f"train_{batch}x{seq}"
        shape = ShapeSpec(shape_name, seq, batch, "train")
    start_fake_group(1)
    try:
        rec = lower_cell(arch, shape_name, mesh=make_smoke_mesh(device_type="cpu"), cfg=cfg, shape=shape)
    finally:
        _end_group()
    rec["layers"] = cfg.num_layers
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}_{shape_name}_1x1.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _end_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both", "smoke"])
    ap.add_argument("--layers", type=int, default=0, help="smoke mesh: cut the config to this depth")
    ap.add_argument("--batch", type=int, default=0, help="smoke mesh: a training shape of this batch")
    ap.add_argument("--seq", type=int, default=0, help="smoke mesh: ... and this sequence length")
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    if args.mesh == "smoke":
        rec = run_smoke_cell(args.arch, args.shape, args.out, layers=args.layers or None, batch=args.batch or None,
                             seq=args.seq or None)
        print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "layers", "memory", "cost")}))
        return 0 if rec["status"] == "OK" else 1
    archs = PORTED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run_cells(archs, shapes, meshes, args.out, resume=not args.no_resume)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"[dryrun] done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL of {len(results)}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
