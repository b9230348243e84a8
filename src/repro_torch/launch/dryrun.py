"""The H100 planner: memory and FLOPs of every (arch x input-shape) step
on one card, traced on ``meta`` tensors (port of ``repro.launch.dryrun``).

Where the reference lowers and compiles each combination for 256 or 512
TPU placeholders and reads XLA's memory and cost analyses, the port plans
what ONE card runs: the whole step (``--mesh card``, the default), or
rank 0's share of it on the reference's production meshes (``--mesh
pod``: 16 x 16 ranks, (data, model); ``multipod``: 2 x 16 x 16, (pod,
data, model); ``both``; ``REPRO_DEBUG_MESH`` shrinks them as the
reference's).  A share is the step over a ``repro_torch.launch.mesh.
PlanMesh`` (``repro_torch.train.state``'s ``mesh=`` steps): training
holds rank 0's blocks of ``param_specs(fsdp=True)`` and of AdamW's
moments and its ``batch / (pod * data)`` rows, gathers each leaf over
``model`` and the edge group where it is used and reduce-scatters its
gradient; prefill and decode hold ``param_specs(fsdp=False)`` blocks,
decode its blocks of ``cache_specs`` (batch rows, or at batch 1 a
sequence-split K/V, attended split-KV); every collective the ranks would
run is allocated as they would allocate it and metered in
``collectives`` as the reference's HLO census meters it (an all-gather its
gathered result, a reduce-scatter its input, an all-reduce its operand),
split by group.  It builds the model as the card runs it (the
``flash_attention`` and ``ssd_scan`` kernels), on ``meta`` tensors, and
runs one step under a dispatch mode that sees every aten op:

  1. the model from the arch config (with the per-shape adaptations of
     ``repro_torch.launch.specs``, a ``--layers`` window, the reference's
     variant flags, and its depth calibration on unstacked trees);
  2. the step's arguments as ``meta`` tensors: the parameter tree
     (``LM.init(None)``), AdamW's moments, the batch or the decode cache;
  3. one step: ``make_train_step`` (AdamW), ``make_prefill_step`` or
     ``decode_step`` against ``init_cache(batch, seq_len)``;
  4. ``cost``: ``flops`` from ``torch.utils.flop_counter`` for the aten
     ops plus each kernel's ``work()`` (its meta path counts what the
     kernel does, the attended pairs only), ``bytes accessed`` as XLA sums
     them, each op's operands and results (views move nothing), plus the
     kernels' bytes; ``memory``: the arguments', outputs' and temporaries'
     bytes and ``peak_live_bytes``, the most bytes live at once, every
     storage counted from the op that made it until it is freed, rounded
     up to the caching allocator's 512-byte blocks;
  5. ``fits``: the predicted peak at most the card's 80 GB.

Meta tensors hold no data and run no arithmetic: nothing is computed, so
the whole 10 x 4 grid plans on a CPU in minutes.  ``--measure`` (a card
only) runs each row that fits once more with real tensors on the card and
records the measured peak, the step's time and the kernels' launches
beside the plan.  An eager trace counts every layer, so the 2-point
calibration (``--calibrate``) reproduces the full-depth FLOPs exactly.

Step per shape kind:
  train    -> ``train_step``  (AdamW)
              or ``el_round`` (``--step el_round``): ONE rank's share of
              the paper's OL4EL round over a (``--mesh-data`` x
              ``--mesh-model``) mesh (``repro_torch.federated.
              local_sgd``): ``--edges-per-rank`` edges' training states
              (over a ``model`` axis, the rank's blocks of them), each
              edge's ``batch // n_edges`` share of the global batch for
              all ``--h-max`` local steps (over a ``model`` axis each
              group's weights gathered in its forward and again in its
              recompute, each gradient leaf gathered for the clip), then
              the all-gather of the parameter stack and the mean; every
              gather's bytes in the row's ``collectives``, by group;
              ``--mesh pod|multipod``: one edge per edge rank, each
              edge's model over the 16-wide ``model`` axis, as the
              reference plans it
  prefill  -> ``prefill_step`` (forward, full sequence)
  decode   -> ``decode_step``  (ONE token vs a seq_len KV/SSM cache)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.bench.roofline import CARD_MEMORY_BYTES, CARD_NAME
from repro_torch.config import (ARCH_IDS, INPUT_SHAPES, ModelConfig,
                                TrainConfig, get_config)
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.kmeans_assign import ops as km_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.specs import (adapt_model_for_shape, batch_struct,
                                      decode_token_struct)
from repro_torch.models import LM
from repro_torch.models.transformer import layer_groups
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.state import (TrainState, make_decode_step,
                                     make_prefill_step, make_train_step)

#: The caching allocator hands out blocks in multiples of 512 bytes.
ALLOC_BLOCK = 512
KERNEL_OPS = {"flash_attention": fa_ops, "ssd_scan": ssd_ops,
              "kmeans_assign": km_ops}
#: Ops that allocate and move no data: no bytes accessed.
ALLOCATIONS = (torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided)
#: ``--mesh``: one card, or rank 0's share on a production mesh.
MESHES = ("card", "pod", "multipod")
MESH_NAMES = {"card": "1x1", "pod": "16x16", "multipod": "2x16x16"}


def block_bytes(nbytes: int) -> int:
    """Bytes the caching allocator holds for a storage of ``nbytes``."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def storages_bytes(tensors) -> int:
    """Allocator bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = block_bytes(st.nbytes())
    return sum(seen.values())


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------


class LiveBytes(TorchDispatchMode):
    """Live storage bytes and bytes accessed, op by op.

    Every op's results that make a new storage add its (block-rounded)
    bytes; a storage leaves when its last tensor is freed, which its
    ``StorageWeakRef`` shows at the next op.  ``peak`` is the most bytes
    live at once, the step's arguments (``hold``: live throughout, since
    the caller holds them) included.  ``bytes_accessed`` sums each op's
    operands and results, views (which move nothing) left out."""

    def __init__(self):
        super().__init__()
        self.held: set = set()
        self.live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.current = 0
        self.peak = 0
        self.bytes_accessed = 0

    def hold(self, tensors) -> int:
        """Count the storages under ``tensors`` as live for the whole step
        (never swept); returns their bytes."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self.held:
                self.held.add(st._cdata)
                added += block_bytes(st.nbytes())
        self.current += added
        self.peak = max(self.peak, self.current)
        return added

    def track(self, tensors) -> None:
        """Count the storages under ``tensors`` as live until freed."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.held or key in self.live:
                continue
            nbytes = block_bytes(st.nbytes())
            self.live[key] = (StorageWeakRef(st), nbytes)
            self.current += nbytes
        self.peak = max(self.peak, self.current)

    def sweep(self) -> None:
        expired = torch.Storage._expired          # StorageWeakRef.expired
        dead = [k for k, (ref, _) in self.live.items() if expired(ref.cdata)]
        for key in dead:
            self.current -= self.live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and func.overloadpacket not in ALLOCATIONS:
            ins = [t for t in _pytree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(t.nbytes for t in ins + outs)
        self.sweep()
        self.track(outs)
        return out


def trace_step(step: Callable[[], Any], arguments: List[torch.Tensor]
               ) -> Dict[str, Any]:
    """Run ``step()`` on meta tensors under the tracker: its ``cost``,
    ``memory`` and the kernels' work.  ``arguments`` are the tensors the
    step is given (parameters, moments, batch, cache), live from the
    start."""
    for ops in KERNEL_OPS.values():
        ops.meta_flops = ops.meta_bytes = 0
    tracker = LiveBytes()
    arg_bytes = tracker.hold(arguments)
    with FlopCounterMode(display=False) as flops, tracker:
        out = step()
        tracker.sweep()
    work = {name: (ops.meta_flops, ops.meta_bytes)
            for name, ops in KERNEL_OPS.items() if ops.meta_flops}
    arg_keys = {t.untyped_storage()._cdata for t in arguments}
    out_bytes = storages_bytes(
        t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)
        and t.untyped_storage()._cdata not in arg_keys)
    del out
    cost = {"flops": float(flops.get_total_flops()
                           + sum(f for f, _ in work.values())),
            "bytes accessed": float(tracker.bytes_accessed
                                    + sum(b for _, b in work.values()))}
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": max(tracker.peak - arg_bytes - out_bytes,
                                        0),
              "peak_live_bytes": tracker.peak}
    return {"cost": cost, "memory": memory,
            "kernels": {k: {"flops": f, "bytes": b}
                        for k, (f, b) in work.items()}}


# ---------------------------------------------------------------------------
# The model and the step, as the card runs them
# ---------------------------------------------------------------------------


def layer_window(cfg: ModelConfig, layers: str) -> ModelConfig:
    """The layers ``a:b`` of ``cfg``'s full pattern as a model of their
    own (one card answers "does it fit" by cutting depth)."""
    a, _, b = layers.partition(":")
    pattern = cfg.block_pattern()[slice(int(a) if a else None,
                                        int(b) if b else None)]
    if not pattern:
        raise ValueError(f"--layers {layers!r}: no layer of {cfg.name}'s "
                         f"{cfg.n_layers}")
    return dataclasses.replace(
        cfg, n_layers=len(pattern),
        layer_pattern=tuple(k for k, _ in pattern),
        ffn_pattern=tuple(f for _, f in pattern), first_k_dense=0)


def _dryrun_train_cfg(batch: int, seq_len: int,
                      opt_state_dtype: str = "float32") -> TrainConfig:
    return TrainConfig(optimizer="adamw", global_batch=batch,
                       seq_len=seq_len, total_steps=1000,
                       opt_state_dtype=opt_state_dtype)


def build(model_cfg: ModelConfig, device: Any, window_slice: bool = False,
          fused_xent: bool = False, ring_cache: bool = False) -> LM:
    """The model as the card runs it: attention through ``flash_attention``
    and the SSD through ``ssd_scan`` (their meta paths on ``meta``)."""
    return LM(model_cfg, attn_impl="kernel", use_ssd_kernel=True,
              fused_xent=fused_xent, ring_cache=ring_cache,
              window_slice=window_slice, device=device)


def card_batch(cfg: ModelConfig, struct: Dict[str, torch.Tensor],
               device: Any, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Real tensors for the stand-ins ``struct`` on ``device``: token ids
    uniform over the vocabulary, embeddings standard normal, from
    ``gen``."""
    out = {}
    for k, t in struct.items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                                   device=device, generator=gen)
        else:
            out[k] = torch.randn(t.shape, dtype=t.dtype, device=device,
                                 generator=gen)
    return out


def edge_ranks(mesh) -> int:
    """The ranks of ``mesh``'s edge axes (1 without a mesh)."""
    if mesh is None:
        return 1
    from repro_torch.launch.mesh import group_size
    return group_size(mesh.edge_group())


def _blocks(layout, cfg: ModelConfig, device, gen) -> Any:
    """A rank's parameter blocks under ``layout``: on ``meta`` the
    shapes, on the card drawn from ``gen`` (each block N(0, 0.02^2), norms
    ones: a share's values are the card's to time, not a model's)."""
    shapes = layout.shard(LM(cfg, device="meta").init(None))
    if gen is None:
        return shapes

    def draw(t):
        if t.dim() == 1:
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        return (torch.randn(t.shape, dtype=torch.float32, device=device,
                            generator=gen) * 0.02).to(t.dtype)
    return tree_map(draw, shapes)


def step_inputs(model: LM, kind: str, batch: int, seq_len: int,
                opt_state_dtype: str = "float32",
                prefill_last_only: bool = False,
                gen: Optional[torch.Generator] = None, mesh=None
                ) -> Tuple[Callable[[], Any], List[torch.Tensor], int]:
    """One step of ``kind`` on ``model``'s device: ``(step, arguments,
    static_bytes)``.  On ``meta`` the arguments are shape-only; on the
    card (``gen`` given) parameters and batch are drawn from ``gen``.
    ``static_bytes`` is what the step holds whatever its activations: the
    arguments and, for training, the gradient tree.  ``mesh`` (a
    ``PlanMesh``): rank 0's share of the step (its blocks, its rows, its
    cache blocks; a batch that does not tile the edge ranks raises)."""
    cfg = model.cfg
    meta = model.device.type == "meta"
    rows = edge_ranks(mesh)

    def draw_batch(struct):
        return struct if meta else card_batch(cfg, struct, model.device, gen)

    def draw_params(layout):
        """The whole tree (no mesh), or the rank's blocks under
        ``layout``."""
        if layout is None:
            return model.init(None if meta else gen)
        return _blocks(layout, cfg, model.device, None if meta else gen)

    def share(n: int) -> int:
        if n % rows:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"{rows} ranks of the edge axes")
        return n // rows

    if kind == "train":
        tc = _dryrun_train_cfg(batch, seq_len, opt_state_dtype)
        train_step = make_train_step(model, tc, mesh=mesh)
        params = draw_params(train_step.layout)
        state = TrainState(params, init_opt_state(tc, params))
        data = draw_batch(batch_struct(cfg, share(batch), seq_len))
        arguments = tree_leaves(state) + list(data.values())
        grads = storages_bytes(tree_leaves(params))
        return (lambda: train_step(state, data), arguments,
                storages_bytes(arguments) + grads)
    if kind == "prefill":
        prefill = make_prefill_step(model, last_only=prefill_last_only,
                                    mesh=mesh)
        params = draw_params(prefill.layout)
        data = draw_batch(batch_struct(cfg, share(batch), seq_len))
        arguments = tree_leaves(params) + list(data.values())
        return (lambda: prefill(params, data), arguments,
                storages_bytes(arguments))
    decode = make_decode_step(model, mesh=mesh, batch=batch,
                              max_len=seq_len)
    params = draw_params(decode.layout)
    cache = model.init_cache(batch, seq_len, mesh=mesh)
    n_tok = (share(batch) if mesh is not None
             and decode.cache_layout.batch_split else batch)
    tokens = draw_batch({"tokens": decode_token_struct(cfg, n_tok)})["tokens"]
    arguments = tree_leaves(params) + tree_leaves(cache) + [tokens]
    return (lambda: decode(params, tokens, cache), arguments,
            storages_bytes(arguments))


def plan_model(model_cfg: ModelConfig, kind: str, batch: int, seq_len: int,
               window_slice: bool = False, fused_xent: bool = False,
               prefill_last_only: bool = False, ring_cache: bool = False,
               opt_state_dtype: str = "float32", mesh=None
               ) -> Dict[str, Any]:
    """The plan of one step of ``kind`` (train | prefill | decode) on
    ``model_cfg`` at ``batch`` x ``seq_len``: ``cost``, ``memory``,
    ``static_bytes``, ``fits`` and the kernels' work; ``mesh`` (a
    ``PlanMesh``): rank 0's share, its collectives in the mesh's
    groups' ``calls``."""
    model = build(model_cfg, "meta", window_slice, fused_xent, ring_cache)
    step, arguments, static = step_inputs(
        model, kind, batch, seq_len, opt_state_dtype, prefill_last_only,
        mesh=mesh)
    plan = trace_step(step, arguments)
    plan["static_bytes"] = static
    plan["fits"] = plan["memory"]["peak_live_bytes"] <= CARD_MEMORY_BYTES
    return plan


def measure_step(step: Callable[[], Any], arguments: List[torch.Tensor],
                 repeats: int = 3, warmup: bool = True) -> Dict[str, Any]:
    """``step`` on the card: a warm-up (unless ``warmup`` is false: a
    caller that has just run the same path), then ``repeats`` steps, each
    between ``reset_peak_memory_stats()`` and ``max_memory_allocated()``
    and timed by CUDA events.  The peak is the step's rise above what was
    allocated before it plus its arguments' blocks, so a cuBLAS workspace
    or another phase's tensors do not count: the quantity the plan's
    ``peak_live_bytes`` predicts."""
    dev = arguments[0].device
    if dev.type != "cuda":
        raise ValueError(f"measure_step: the card only, not {dev}")
    arg_bytes = storages_bytes(arguments)
    if warmup:
        step()
    torch.cuda.synchronize(dev)
    before = {k: (ops.launches, getattr(ops, "batched_launches", 0))
              for k, ops in KERNEL_OPS.items()}
    peaks, times = [], []
    for _ in range(repeats):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step()
        end.record()
        torch.cuda.synchronize(dev)
        peaks.append(torch.cuda.max_memory_allocated(dev) - base + arg_bytes)
        times.append(start.elapsed_time(end))
        del out
    launches = {k: ops.launches + getattr(ops, "batched_launches", 0)
                - sum(before[k]) for k, ops in KERNEL_OPS.items()}
    return {"peak_bytes": max(peaks), "peaks": peaks,
            "step_ms": statistics.median(times), "step_ms_all": times,
            "repeats": repeats, "launches": launches,
            "device": torch.cuda.get_device_name(dev)}


def el_round_inputs(model: LM, batch: int, seq_len: int, h_max: int,
                    edges_per_rank: int, data_ranks: int,
                    opt_state_dtype: str = "float32",
                    gen: Optional[torch.Generator] = None,
                    model_ranks: int = 1, mesh=None
                    ) -> Tuple[Callable[[], Any], List[torch.Tensor], int,
                               Any]:
    """Rank 0's share of one OL4EL round on ``model``'s device: ``(step,
    arguments, static_bytes, mesh)``.  The state holds ``edges_per_rank``
    edges (every edge drawn, as ``init_el_state`` draws them; over
    ``model_ranks`` > 1, rank 0's blocks of them), the batch their rows
    of ``el_round_batch_struct``, every edge runs all ``h_max`` steps
    (the most a round runs), and the round gathers over a ``PlanMesh`` of
    ``data_ranks`` x ``model_ranks`` ranks, or over ``mesh`` (a
    production ``PlanMesh``; its edge ranks are ``data_ranks``) (its
    groups' ``calls``: the gathers)."""
    from repro_torch.federated.local_sgd import init_el_state, make_el_round
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.launch.specs import el_round_batch_struct
    cfg = model.cfg
    meta = model.device.type == "meta"
    if mesh is None:
        mesh = PlanMesh(data_ranks, model_ranks)
    n_edges = edges_per_rank * edge_ranks(mesh)
    tc = _dryrun_train_cfg(batch, seq_len, opt_state_dtype)
    state = init_el_state(model, tc, n_edges, None if meta else gen,
                          edges=range(edges_per_rank), mesh=mesh)
    struct = {k: v[:edges_per_rank] for k, v in el_round_batch_struct(
        cfg, n_edges, h_max, batch, seq_len).items()}
    data = struct if meta else card_batch(cfg, struct, model.device, gen)
    el_round = make_el_round(model, tc, h_max,
                             mesh=mesh if mesh.size > 1 else None)
    intervals = torch.full((n_edges,), h_max, dtype=torch.int32)
    weights = torch.ones(n_edges, device=model.device)
    arguments = tree_leaves(state) + list(data.values())
    grads = storages_bytes(tree_leaves(state.params)) // edges_per_rank
    return (lambda: el_round(state, data, intervals, weights), arguments,
            storages_bytes(arguments) + grads, mesh)


def gather_census(mesh) -> Dict[str, Any]:
    """The row's ``collectives`` in the reference's schema
    (``repro.obs.prof.parse_collectives``) from a ``PlanMesh``'s recorded
    collectives (one traced step): ``per_op`` {op: {``count``, ``bytes``,
    ``by_group`` {edge | model: {count, bytes}}}} and
    ``bytes_per_device``, their total."""
    per_op: Dict[str, Dict[str, Any]] = {}
    groups = (("edge", mesh.edge_group()), ("model", mesh.model_group()))
    for name, group in groups:
        for op, nbytes in (group.calls if group is not None else ()):
            entry = per_op.setdefault(op, {"count": 0, "bytes": 0,
                                           "by_group": {}})
            part = entry["by_group"].setdefault(name, {"count": 0,
                                                       "bytes": 0})
            for e in (entry, part):
                e["count"] += 1
                e["bytes"] += nbytes
    return {"per_op": per_op,
            "bytes_per_device": sum(e["bytes"] for e in per_op.values())}


def measure_model(model_cfg: ModelConfig, kind: str, batch: int,
                  seq_len: int, device: Any = "cuda", window_slice: bool = False,
                  fused_xent: bool = False, prefill_last_only: bool = False,
                  ring_cache: bool = False, opt_state_dtype: str = "float32",
                  mesh=None, repeats: int = 3) -> Dict[str, Any]:
    """``plan_model``'s step run on the card with real tensors (parameters
    and batch drawn from a generator seeded with 0): ``measure_step``;
    ``mesh`` (a ``PlanMesh``): rank 0's share, its collectives allocated
    and not exchanged (each gather copies the rank's block into every
    block)."""
    model = build(model_cfg, device, window_slice, fused_xent, ring_cache)
    step, arguments, _ = step_inputs(
        model, kind, batch, seq_len, opt_state_dtype, prefill_last_only,
        gen=torch.Generator(device=model.device).manual_seed(0), mesh=mesh)
    out = measure_step(step, arguments, repeats=repeats)
    del step, arguments, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Planning per combo
# ---------------------------------------------------------------------------


def plan_combo(arch: str, shape_name: str, multi_pod: bool = False,
               step_mode: str = "auto", h_max: int = 4,
               window_slice: bool = False,
               fused_xent: bool = False,
               no_remat: bool = False,
               moe_sort_dispatch: bool = False,
               prefill_last_only: bool = False,
               ring_cache: bool = False,
               moe_groups: int = 0,
               opt_state_dtype: str = "float32",
               extra_tag: str = "",
               depth_groups: Optional[int] = None,
               batch: Optional[int] = None,
               seq_len: Optional[int] = None,
               layers: Optional[str] = None,
               measure: bool = False,
               device: Any = "meta", edges_per_rank: int = 1,
               data_ranks: int = 1, model_ranks: int = 1,
               mesh: str = "card") -> Dict[str, Any]:
    """Plan one combo on one card: the reference's ``lower_combo``
    arguments, plus ``batch`` / ``seq_len`` (override the shape's) and
    ``layers`` (a window ``a:b`` of the full layer pattern).  With
    ``measure`` (``device`` a card) a row that fits also runs on the card
    (``measure_model``).  ``mesh``: ``"card"`` plans the whole step on one
    card; ``"pod"`` (16 x 16) and ``"multipod"`` (2 x 16 x 16;
    ``multi_pod=True``, the reference's flag, is its alias) plan rank 0's
    share on the production mesh, as the reference lowers it there
    (``measure`` runs that share on the card).
    ``step_mode="el_round"`` plans one rank's share of the OL4EL round
    (``el_round_inputs``): on a card mesh over ``data_ranks`` x
    ``model_ranks`` ranks, on a production mesh one edge per edge rank
    over its ``model`` axis.

    ``depth_groups``: calibration mode, as the reference's: a
    depth-reduced unstacked variant (prefix + depth_groups * group
    layers, ``scan_layers=False``); ``repro_torch.bench.roofline``
    extrapolates ``total = c1 + (n_groups - 1) * (c2 - c1)``.
    """
    t0 = time.time()
    mesh = "multipod" if multi_pod else mesh
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; expected one of {MESHES}")
    if mesh != "card" and (data_ranks, model_ranks) != (1, 1):
        raise ValueError(f"the {mesh} mesh has its own ranks: data_ranks / "
                         "model_ranks plan a card mesh only")
    if measure and torch.device(device).type != "cuda":
        raise ValueError(f"--measure runs the step on a card, not on "
                         f"{device!r}")
    shape = INPUT_SHAPES[shape_name]
    batch_ = shape.global_batch if batch is None else batch
    seq_ = shape.seq_len if seq_len is None else seq_len
    exp = get_config(arch)
    model_cfg = adapt_model_for_shape(exp.model, shape)
    if layers:
        model_cfg = layer_window(model_cfg, layers)
    n_groups_full = None
    if depth_groups is not None:
        pre, grp, n_groups_full = layer_groups(model_cfg)
        model_cfg = dataclasses.replace(
            model_cfg,
            n_layers=len(pre) + depth_groups * max(len(grp), 1),
            scan_layers=False)
        extra_tag = ((extra_tag + "|") if extra_tag else "") \
            + f"calib{depth_groups}"
    if no_remat:
        model_cfg = dataclasses.replace(model_cfg, remat=False)
    if moe_sort_dispatch and model_cfg.moe.enabled:
        model_cfg = dataclasses.replace(
            model_cfg,
            moe=dataclasses.replace(model_cfg.moe, dispatch="sort"))
    if moe_groups and model_cfg.moe.enabled:
        model_cfg = dataclasses.replace(
            model_cfg,
            moe=dataclasses.replace(model_cfg.moe,
                                    dispatch_groups=moe_groups))

    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "1x1", "n_chips": 1,
        "step": step_mode, "tag": extra_tag,
        "params": int(model_cfg.num_params()),
        "active_params": int(model_cfg.num_active_params()),
        "sliding_window": model_cfg.sliding_window,
    }
    if batch is not None:
        record["batch"] = batch
    if seq_len is not None:
        record["seq_len"] = seq_len
    if layers:
        record["layers"] = layers
    if depth_groups is not None:
        record["depth_groups"] = depth_groups
        record["n_groups_full"] = n_groups_full
        record["n_layers_reduced"] = model_cfg.n_layers

    plan_mesh = None
    if mesh != "card":
        from repro_torch.launch.mesh import PlanMesh
        plan_mesh = PlanMesh.production(multi_pod=mesh == "multipod")
        record.update(mesh=MESH_NAMES[mesh], n_chips=plan_mesh.size,
                      rank=0, edge_ranks=edge_ranks(plan_mesh),
                      model_ranks=plan_mesh.shape["model"])
    if shape.kind == "train" and step_mode == "el_round":
        return _plan_el_round(record, model_cfg, batch_, seq_, h_max,
                              edges_per_rank, data_ranks, model_ranks,
                              opt_state_dtype, measure, device, t0,
                              plan_mesh)
    record["step"] = {"train": "train_step", "prefill": "prefill_step",
                      "decode": "decode_step"}[shape.kind]
    flags = dict(window_slice=window_slice, fused_xent=fused_xent,
                 ring_cache=ring_cache)
    plan = plan_model(model_cfg, shape.kind, batch_, seq_,
                      prefill_last_only=prefill_last_only,
                      opt_state_dtype=opt_state_dtype, mesh=plan_mesh,
                      **flags)
    record["plan_s"] = round(time.time() - t0, 2)
    record.update(memory=plan["memory"], cost=plan["cost"],
                  static_bytes=plan["static_bytes"], fits=plan["fits"],
                  card=CARD_NAME, card_memory_bytes=CARD_MEMORY_BYTES,
                  kernels=plan["kernels"],
                  collectives=({} if plan_mesh is None
                               else gather_census(plan_mesh)), ok=True)
    if measure and plan["fits"]:
        record["measured"] = measure_model(
            model_cfg, shape.kind, batch_, seq_, device,
            prefill_last_only=prefill_last_only,
            opt_state_dtype=opt_state_dtype, mesh=plan_mesh, **flags)
        record["peak_error"] = (plan["memory"]["peak_live_bytes"]
                                / record["measured"]["peak_bytes"] - 1.0)
    return record


def _plan_el_round(record, model_cfg, batch, seq_len, h_max,
                   edges_per_rank, data_ranks, model_ranks, opt_state_dtype,
                   measure, device, t0, plan_mesh=None) -> Dict[str, Any]:
    if plan_mesh is None:
        record.update(mesh=f"{data_ranks}x{model_ranks}",
                      n_chips=data_ranks * model_ranks)
    else:
        data_ranks = edge_ranks(plan_mesh)
        model_ranks = plan_mesh.shape["model"]
    n_edges = edges_per_rank * data_ranks
    if batch % n_edges:
        raise ValueError(f"a global batch of {batch} does not split over "
                         f"{n_edges} edges")
    record.update(step="el_round", n_edges=n_edges,
                  h_max=h_max, edges_per_rank=edges_per_rank,
                  edge_batch=batch // n_edges)
    step, arguments, static, mesh = el_round_inputs(
        build(model_cfg, "meta"), batch, seq_len, h_max, edges_per_rank,
        data_ranks, opt_state_dtype, model_ranks=model_ranks,
        mesh=plan_mesh)
    plan = trace_step(step, arguments)
    plan["fits"] = plan["memory"]["peak_live_bytes"] <= CARD_MEMORY_BYTES
    record["plan_s"] = round(time.time() - t0, 2)
    record.update(memory=plan["memory"], cost=plan["cost"],
                  static_bytes=static, fits=plan["fits"], card=CARD_NAME,
                  card_memory_bytes=CARD_MEMORY_BYTES,
                  kernels=plan["kernels"], collectives=gather_census(mesh),
                  ok=True)
    if measure and plan["fits"]:
        model = build(model_cfg, device)
        step, arguments, _, _ = el_round_inputs(
            model, batch, seq_len, h_max, edges_per_rank, data_ranks,
            opt_state_dtype,
            gen=torch.Generator(device=model.device).manual_seed(0),
            model_ranks=model_ranks, mesh=plan_mesh)
        record["measured"] = measure_step(step, arguments)
        del step, arguments, model
        torch.cuda.empty_cache()
        record["peak_error"] = (plan["memory"]["peak_live_bytes"]
                                / record["measured"]["peak_bytes"] - 1.0)
    return record


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _chips(mesh: str) -> int:
    """The ranks of ``--mesh``'s mesh (a failed row's ``n_chips``)."""
    if mesh == "card":
        return 1
    from repro_torch.launch.mesh import production_shape
    return int(math.prod(production_shape(multi_pod=mesh == "multipod")[0]))


def _status_line(rec: Dict[str, Any], mesh_name: str) -> str:
    status = "OK" if rec.get("ok") else "FAIL"
    mem = rec.get("memory", {})
    line = (f"[{status}] {rec['arch']} {rec['shape']} {mesh_name} "
            f"{rec.get('step')} tag={rec.get('tag', '')} "
            f"args={mem.get('argument_size_in_bytes', 0) / 1e9:.2f}GB "
            f"peak={mem.get('peak_live_bytes', 0) / 1e9:.2f}GB "
            f"fits={rec.get('fits', '-')} "
            f"plan={rec.get('plan_s', '-')}s")
    if "measured" in rec:
        line += (f" measured={rec['measured']['peak_bytes'] / 1e9:.2f}GB "
                 f"err={rec['peak_error']:+.3f} "
                 f"step={rec['measured']['step_ms']:.2f}ms")
    if not rec.get("ok"):
        line += f" {rec['error']}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="card",
                    choices=["card", "pod", "multipod", "both"],
                    help="card: the whole step on one card; pod (16x16), "
                         "multipod (2x16x16), both: rank 0's share on the "
                         "production mesh")
    ap.add_argument("--step", default="auto",
                    choices=["auto", "train_step", "el_round"])
    ap.add_argument("--h-max", type=int, default=4)
    ap.add_argument("--edges-per-rank", type=int, default=1,
                    help="--step el_round: edges a rank holds")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="--step el_round: ranks of the data axis")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="--step el_round: ranks of the model axis (each "
                         "edge's model split over them)")
    ap.add_argument("--window-slice", action="store_true",
                    help="enable KV-slice optimization for sliding-window")
    ap.add_argument("--fused-xent", action="store_true",
                    help="cross-entropy as logsumexp less the label logit")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing")
    ap.add_argument("--moe-sort-dispatch", action="store_true",
                    help="sort-based MoE position-in-expert (O(Tk) mem)")
    ap.add_argument("--prefill-last-only", action="store_true",
                    help="serving prefill: emit only last-position logits")
    ap.add_argument("--ring-cache", action="store_true",
                    help="rolling window-length KV cache for decode")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="group-local MoE dispatch")
    ap.add_argument("--opt-state-dtype", default="float32",
                    help="Adam moment dtype (bf16 halves optimizer memory)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run the 2-point depth calibration (unstacked "
                         "prefix+G and prefix+2G) for the roofline's "
                         "flop/byte extrapolation")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a step (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a sequence, or the decode cache's length "
                         "(default: the shape's)")
    ap.add_argument("--layers", default=None,
                    help="plan the window a:b of the full layer pattern")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: plan only; cuda: --measure there")
    ap.add_argument("--measure", action="store_true",
                    help="also run each row that fits on the card (needs "
                         "--device cuda): measured peak, step ms, launches")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/torch_dryrun.jsonl")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.measure and args.device != "cuda":
        ap.error("--measure runs on the card: pass --device cuda")
    if args.mesh != "card" and (args.mesh_data, args.mesh_model) != (1, 1):
        ap.error(f"--mesh {args.mesh} has its own ranks: --mesh-data / "
                 "--mesh-model plan a card mesh only")

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"both": ["pod", "multipod"]}.get(args.mesh, [args.mesh])

    done = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"], r["step"],
                              r.get("tag", "")))
                except (json.JSONDecodeError, KeyError):
                    pass

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failures = 0
    with open(args.out, "a") as f:
        for arch, shape_name, mesh in ((a, s, m) for a in archs
                                       for s in shapes for m in meshes):
            step = args.step
            kind = INPUT_SHAPES[shape_name].kind
            if step == "el_round" and kind != "train":
                continue
            mesh_name = MESH_NAMES[mesh]
            if mesh == "card" and step == "el_round":
                mesh_name = f"{args.mesh_data}x{args.mesh_model}"
            key_step = step if step == "el_round" else {
                "train": "train_step", "prefill": "prefill_step",
                "decode": "decode_step"}[kind]
            if (not args.calibrate
                    and (arch, shape_name, mesh_name, key_step,
                         args.tag) in done):
                continue
            for dg in [1, 2] if args.calibrate else [None]:
                tag = args.tag
                if dg:
                    tag = ((tag + "|") if tag else "") + f"calib{dg}"
                if dg and (arch, shape_name, mesh_name, key_step,
                           tag) in done:
                    continue
                try:
                    rec = plan_combo(
                        arch, shape_name, step_mode=step, mesh=mesh,
                        h_max=args.h_max, window_slice=args.window_slice,
                        fused_xent=args.fused_xent, no_remat=args.no_remat,
                        moe_sort_dispatch=args.moe_sort_dispatch,
                        prefill_last_only=args.prefill_last_only,
                        ring_cache=args.ring_cache,
                        moe_groups=args.moe_groups,
                        opt_state_dtype=args.opt_state_dtype,
                        extra_tag=args.tag, depth_groups=dg,
                        batch=args.batch, seq_len=args.seq,
                        layers=args.layers, measure=args.measure,
                        device=args.device,
                        edges_per_rank=args.edges_per_rank,
                        data_ranks=args.mesh_data,
                        model_ranks=args.mesh_model)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "n_chips": _chips(mesh),
                           "step": key_step, "tag": tag, "ok": False,
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                f.write(json.dumps(rec) + "\n")
                f.flush()
                print(_status_line(rec, mesh_name), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
