"""The port's H100 planner and its neighbours against the reference, on the
CPU: ``repro_torch.config``'s shapes and registry, ``launch.specs``, the
shape-only parameter and cache trees (against ``jax.eval_shape``; nothing
is compiled), ``launch.dryrun``'s counts (a hand count of the FLOPs, the
depth extrapolation, a hand-built live-bytes sequence, the one-card
facts), ``bench.roofline`` against ``benchmarks/roofline.py``
(``bench.run --only roofline`` is in ``tests/test_torch_bench_figs.py``),
``launch.train``'s ``--alpha`` /
``--kmeans-impl`` against the reference launcher's decisions on replayed
draws, and the three examples on the CPU.

The planner traces on ``meta`` tensors: nothing is computed, so full-width
configurations plan here in seconds.  Only the rows the tests name are
planned; the 10 x 4 grid is not.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:               # the reference's benchmarks package
    sys.path.insert(0, ROOT)

from test_torch_ingraph import jax_round_draws  # noqa: E402

from benchmarks import roofline as ref_roofline  # noqa: E402
from repro import config as ref_config  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.bench import roofline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ARCHS = port_config.ARCH_IDS
GB = 1e9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops on a CPU that other test processes load: torch's OpenMP
    pool spin-waits between them (the examples' test took 200 s under the
    suite's 6 workers, 1.2 s alone).  One intra-op thread for this
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- config: shapes, registry, active parameters ------------------------------


def test_input_shapes_and_arch_ids_are_the_references():
    assert port_config.ARCH_IDS == ref_config.ARCH_IDS
    assert port_config.list_archs() == ref_config.list_archs()
    assert port_config.PORTED_LM_IDS == port_config.ARCH_IDS
    assert list(port_config.INPUT_SHAPES) == list(ref_config.INPUT_SHAPES)
    for name, shape in port_config.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) \
            == dataclasses.asdict(ref_config.INPUT_SHAPES[name])
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model")),
                        ((4,), ("model",))):
        got = port_config.MeshConfig(shape, axes)
        want = ref_config.MeshConfig(shape, axes)
        assert (got.edge_axes, got.n_edges) == (want.edge_axes, want.n_edges)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_active_params_is_the_references(arch):
    got = port_config.get_config(arch).model
    want = ref_config.get_config(arch).model
    assert got.num_active_params() == want.num_active_params()
    assert got.num_params() == want.num_params()


# -- launch.specs ----------------------------------------------------------------


def _sd(tree):
    """{key: (shape, dtype name)} of a dict of stand-ins of either
    package."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_give_the_references_shapes_and_dtypes(arch):
    port_cfg = port_config.get_config(arch).model
    ref_cfg = ref_config.get_config(arch).model
    for name in port_config.INPUT_SHAPES:
        got = specs.adapt_model_for_shape(port_cfg,
                                          port_config.INPUT_SHAPES[name])
        want = ref_specs.adapt_model_for_shape(
            ref_cfg, ref_config.INPUT_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        port_in = specs.input_specs(port_cfg, name)
        assert all(t.is_meta for t in port_in.values())
        assert _sd(port_in) == _sd(ref_specs.input_specs(ref_cfg, name))
    assert _sd(specs.batch_struct(port_cfg, 8, 128)) \
        == _sd(ref_specs.batch_struct(ref_cfg, 8, 128))
    assert _sd({"t": specs.decode_token_struct(port_cfg, 8)}) \
        == _sd({"t": ref_specs.decode_token_struct(ref_cfg, 8)})
    assert _sd(specs.el_round_batch_struct(port_cfg, 4, 3, 8, 64)) \
        == _sd(ref_specs.el_round_batch_struct(ref_cfg, 4, 3, 8, 64))
    assert specs.LONG_CONTEXT_WINDOW == ref_specs.LONG_CONTEXT_WINDOW


# -- the shape-only trees --------------------------------------------------------


def _jax_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).removeprefix("torch."))}
    out = {}
    for k, v in items:
        out.update(_port_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# one dense, one MoE, mamba2 and the jamba smoke config; qwen3's with a
# window and a ring cache, as the long-context shape plans it
TREE_CASES = ["qwen3-1.7b", "olmoe-1b-7b", "mamba2-370m", "jamba-smoke"]


@pytest.mark.parametrize("arch", TREE_CASES)
def test_shape_only_tree_and_cache_match_eval_shape(arch):
    """``LM(device="meta").init(None)`` and ``init_cache`` give the
    reference's ``jax.eval_shape(model.init)`` / ``init_cache`` trees leaf
    for leaf: key path, shape and dtype.  The trees carry no dtype
    difference (the test would name one here)."""
    if arch == "jamba-smoke":
        port_cfg = port_config.get_smoke_config(
            "jamba-1.5-large-398b").model
        ref_cfg = ref_config.get_smoke_config("jamba-1.5-large-398b").model
    else:
        port_cfg = port_config.get_config(arch).model
        ref_cfg = ref_config.get_config(arch).model
    model = LM(port_cfg, device="meta")
    tree = model.init(None)
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    ref = ref_build(ref_cfg)
    want = _jax_paths(jax.eval_shape(ref.init, jax.random.key(0)))
    assert _port_paths(tree) == want
    got_cache = _port_paths(model.init_cache(3, 40))
    want_cache = _jax_paths(jax.eval_shape(lambda: ref.init_cache(3, 40)))
    assert got_cache == want_cache
    with pytest.raises(ValueError, match="meta"):
        LM(port_cfg, device="cpu").init(None)


# -- dryrun's counts ---------------------------------------------------------------


def _dense_smoke(n_layers=2):
    cfg = port_config.get_smoke_config("qwen3-1.7b").model
    return dataclasses.replace(cfg, n_layers=n_layers)


def test_meta_prefill_flops_equal_a_hand_count():
    """A dense smoke prefill: 2 x (matmul parameters) x tokens for the
    projections, MLPs and the (tied) head, plus the kernel's 4 B H D
    pairs a layer on the causal pairs only."""
    cfg = _dense_smoke(3)
    b, s = 2, 48
    d, hd, h, kv = (cfg.d_model, cfg.resolved_head_dim, cfg.n_heads,
                    cfg.n_kv_heads)
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * cfg.d_ff
    matmul_params = cfg.n_layers * per_layer + d * cfg.vocab_size
    pairs = s * (s + 1) // 2
    want = 2 * matmul_params * b * s + cfg.n_layers * 4 * b * h * hd * pairs
    plan = dryrun.plan_model(cfg, "prefill", b, s)
    assert plan["cost"]["flops"] == want
    assert plan["kernels"]["flash_attention"]["flops"] \
        == cfg.n_layers * fa_ops.work(b, s, h, kv, hd)[0]
    assert plan["fits"] and plan["memory"]["peak_live_bytes"] \
        >= plan["memory"]["argument_size_in_bytes"] > 0


def _calibrated_flops(cfg, kind, b, s):
    from repro_torch.models.transformer import layer_groups
    pre, grp, n = layer_groups(cfg)
    flops = []
    for g in (1, 2):
        c = dataclasses.replace(cfg, n_layers=len(pre) + g * len(grp),
                                scan_layers=False)
        flops.append(dryrun.plan_model(c, kind, b, s)["cost"]["flops"])
    return flops[0] + (n - 1) * (flops[1] - flops[0])


@pytest.mark.parametrize("case", ["dense", "jamba"])
def test_depth_extrapolation_equals_the_full_depth_flops(case):
    """An eager trace counts every layer: the reference's 2-point
    calibration ``c1 + (n - 1)(c2 - c1)`` on unstacked trees equals the
    stacked full-depth count exactly."""
    if case == "dense":
        cfg = dataclasses.replace(_dense_smoke(5), remat=True)
    else:
        # the smoke config's (MAMBA, DENSE), (ATTN, MOE) group, 3 deep
        cfg = dataclasses.replace(port_config.get_smoke_config(
            "jamba-1.5-large-398b").model, n_layers=6, remat=True)
    full_flops = dryrun.plan_model(cfg, "train", 2, 32)["cost"]["flops"]
    assert _calibrated_flops(cfg, "train", 2, 32) == full_flops


def test_calibration_rows_through_the_roofline_index():
    rows = [dryrun.plan_combo("qwen3-1.7b", "decode_32k", batch=2,
                              seq_len=64, depth_groups=g)
            for g in (None, 1, 2)]
    calib = roofline.calibration_index(rows)
    key = ("qwen3-1.7b", "decode_32k", "1x1", "decode_step", "")
    assert calib[key][0] == rows[0]["cost"]["flops"]
    assert rows[1]["n_groups_full"] == 28 and rows[2]["tag"] == "calib2"
    assert roofline.analyze(rows[0], calib)["calibrated"]


def test_live_bytes_peak_of_a_hand_built_sequence():
    """Storages counted from the op that makes them until freed, rounded
    to the allocator's 512-byte blocks; views add nothing; the held
    arguments count throughout."""
    arg = torch.empty(1000, device="meta")                 # 4000 -> 4096
    tracker = dryrun.LiveBytes()
    assert tracker.hold([arg, arg[10:]]) == 4096
    with tracker:
        a = torch.empty(256, 3, device="meta")             # 3072
        v = a.view(-1)                                     # a view: 0
        b = a + 1.0                                        # 3072: 10240
        del a
        c = v * 2.0                                        # a lives in v
        peak_here = tracker.current
        del v, b
        d = c.sum(0)                                       # 4 -> 512
        e = torch.empty(600, device="meta")                # 2400 -> 2560
        tracker.sweep()
        now = tracker.current
    assert peak_here == 4096 + 3 * 3072
    assert tracker.peak == 4096 + 3 * 3072
    assert now == 4096 + 3072 + 512 + 2560
    # the add, the mul and the sum; allocations and views move nothing
    assert tracker.bytes_accessed == (3072 + 3072) + (3072 + 3072) \
        + (3072 + 4)
    del c, d, e


def test_one_card_facts_hold_on_meta():
    """olmoe-1b-7b's training state (f32 params, gradients and AdamW
    moments) is >= 110 GB and does not fit; jamba's layers 0:5 hold a
    96.0 GB tree and do not fit, its layers 2:5 a 51.6 GB one that does."""
    train = dryrun.plan_combo("olmoe-1b-7b", "train_4k", batch=4,
                              seq_len=512)
    assert train["static_bytes"] >= 110 * GB and not train["fits"]
    assert train["collectives"] == {} and train["mesh"] == "1x1"
    assert (train["batch"], train["seq_len"]) == (4, 512)
    first5 = dryrun.plan_combo("jamba-1.5-large-398b", "prefill_32k",
                               batch=4, seq_len=512, layers="0:5")
    assert round(first5["memory"]["argument_size_in_bytes"] / GB, 1) == 96.0
    assert not first5["fits"] and first5["layers"] == "0:5"
    mid = dryrun.layer_window(
        port_config.get_config("jamba-1.5-large-398b").model, "2:5")
    assert mid.block_pattern() == (("mamba", "dense"), ("mamba", "moe"),
                                   ("attn", "dense"))
    # one rank's share of the OL4EL round over 2 data ranks: its edge's
    # state, the batch's half, the gather of the parameter stack
    row = dryrun.plan_combo("qwen3-1.7b", "train_4k", step_mode="el_round",
                            h_max=2, batch=4, seq_len=64, layers="0:2",
                            data_ranks=2)
    assert (row["step"], row["mesh"], row["n_chips"], row["n_edges"],
            row["edge_batch"], row["h_max"]) == ("el_round", "2x1", 2, 2, 2,
                                                 2)
    params = LM(dryrun.layer_window(
        port_config.get_config("qwen3-1.7b").model, "0:2"),
        device="meta").init(None)
    nbytes = sum(t.numel() * t.element_size()
                 for t in jax.tree_util.tree_leaves(params))
    gathers = row["collectives"]["per_op"]["all-gather"]
    # one gather a dtype of the parameters, one of the edges' losses, each
    # metered by its gathered result (both ranks' rows), as the
    # reference's census meters it
    assert gathers["bytes"] == 2 * (nbytes + 4) and gathers["count"] >= 2
    assert row["collectives"]["bytes_per_device"] == gathers["bytes"]
    assert row["memory"]["argument_size_in_bytes"] >= 3 * nbytes
    assert row["fits"] and row["ok"]
    # the multi-pod mesh plans rank 0's share (ROADMAP item 14 part 7)
    mp = dryrun.plan_combo("qwen3-1.7b", "train_4k", multi_pod=True,
                           batch=64, seq_len=64, layers="0:2")
    assert (mp["mesh"], mp["n_chips"], mp["edge_ranks"],
            mp["model_ranks"], mp["step"]) == ("2x16x16", 512, 32, 16,
                                              "train_step")
    assert mp["ok"] and mp["collectives"]["bytes_per_device"] > 0
    assert set(mp["collectives"]["per_op"]) == {"all-gather",
                                                "reduce-scatter",
                                                "all-reduce"}
    with pytest.raises(ValueError, match="card"):
        dryrun.plan_combo("qwen3-1.7b", "decode_32k", measure=True,
                          device="cpu")


def _block_bytes(shape, spec, dtype, sizes):
    """Allocator bytes of one rank's block of a leaf under ``spec``."""
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= size // int(np.prod([sizes[a] for a in axes]))
    return dryrun.block_bytes(n * dtype.itemsize)


def test_el_round_plans_a_model_axis(tmp_path):
    """``--step el_round`` over a model axis of 2: the arguments are the
    rank's blocks of its edges' state (``el_state_specs``, the edge dim
    the rank's own) plus its batch, exactly; the peak is below the
    unsplit round's; ``collectives`` holds the model group's gathers (each
    group's weights in the forward and again in the recompute, each
    gradient leaf for the clip) and, over 2 data ranks, the edge group's
    too; the CLI plans the row."""
    import types

    from repro_torch.federated import local_sgd
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.launch.specs import el_round_batch_struct
    from repro_torch.sharding import map_specs
    kw = dict(step_mode="el_round", h_max=2, batch=4, seq_len=64,
              layers="0:2", edges_per_rank=2)
    one = dryrun.plan_combo("mamba2-370m", "train_4k", **kw)
    two = dryrun.plan_combo("mamba2-370m", "train_4k", model_ranks=2, **kw)
    assert (two["mesh"], two["n_chips"]) == ("1x2", 2)
    cfg = dryrun.layer_window(
        port_config.get_config("mamba2-370m").model, "0:2")
    tc = dryrun._dryrun_train_cfg(4, 64)
    meta = local_sgd.init_el_state(LM(cfg, device="meta"), tc, 2, None)
    mesh = PlanMesh(1, 2)
    specs = local_sgd.el_state_specs(cfg, mesh, meta)
    flat = [b.spec for b in tree_leaves(map_specs(
        lambda spec: types.SimpleNamespace(spec=spec), specs))]
    sizes = dict(mesh.shape)
    state = sum(_block_bytes(tuple(t.shape), s, np.dtype(str(t.dtype)[6:]),
                             sizes) for t, s in zip(tree_leaves(meta), flat))
    batch = sum(dryrun.block_bytes(t.numel() * t.element_size())
                for t in el_round_batch_struct(cfg, 2, 2, 4, 64).values())
    assert two["memory"]["argument_size_in_bytes"] == state + batch
    assert sum("model" in s for s in flat) > 0
    assert two["memory"]["peak_live_bytes"] < \
        one["memory"]["peak_live_bytes"]
    gathers = two["collectives"]["per_op"]["all-gather"]
    assert set(gathers["by_group"]) == {"model"}
    # each of the 4 steps (2 edges x h_max 2) gathers the split leaves
    # whole (both ranks' blocks, the gathered result) at least twice: in
    # the forward and for the clip
    split = sum(t[0].numel() * t.element_size()
                for t, s in zip(tree_leaves(meta.params), flat)
                if "model" in s)
    assert 8 * split <= gathers["bytes"] <= 16 * split
    four = dryrun.plan_combo("mamba2-370m", "train_4k", data_ranks=2,
                             model_ranks=2, **dict(kw, edges_per_rank=1))
    assert four["mesh"] == "2x2" and set(
        four["collectives"]["per_op"]["all-gather"]["by_group"]) == {
            "edge", "model"}
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "train_4k",
                        "--step", "el_round", "--mesh-model", "2",
                        "--edges-per-rank", "2", "--batch", "4", "--seq",
                        "64", "--layers", "0:2", "--h-max", "2",
                        "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    assert row["ok"] and row["mesh"] == "1x2"
    assert row["memory"] == two["memory"]


def _ref_window(arch, shape_name, port_cfg):
    """The reference's config of ``arch`` for ``shape_name`` cut to the
    port's layer window ``port_cfg``."""
    ref_cfg = ref_specs.adapt_model_for_shape(
        ref_config.get_config(arch).model, ref_config.INPUT_SHAPES[shape_name])
    return dataclasses.replace(
        ref_cfg, n_layers=port_cfg.n_layers,
        layer_pattern=port_cfg.layer_pattern,
        ffn_pattern=port_cfg.ffn_pattern, first_k_dense=0)


def _spec_bytes(tree, specs, sizes):
    from jax.sharding import PartitionSpec
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(flat)
    return sum(_block_bytes(tuple(t.shape), tuple(s), np.dtype(t.dtype),
                            sizes) for t, s in zip(leaves, flat))


MESH_ROWS = [(m, a, s) for m in ("pod", "multipod")
             for a, s in (("qwen3-1.7b", "train_4k"),
                          ("olmoe-1b-7b", "train_4k"),
                          ("qwen3-1.7b", "prefill_32k"),
                          ("mamba2-370m", "decode_32k"),
                          ("qwen3-1.7b", "decode_32k"),
                          ("qwen3-1.7b", "long_500k"))]


@pytest.mark.parametrize("mesh,arch,shape_name", MESH_ROWS)
def test_mesh_rows_hold_the_references_blocks(mesh, arch, shape_name):
    """Rank 0's share on the (16, 16) and (2, 16, 16) meshes: its
    argument bytes are, exactly, the blocks ``repro.sharding``'s
    ``param_specs`` (``fsdp=True`` for training, with AdamW's moments
    mirroring the parameters and the replicated step; ``fsdp=False`` to
    serve) and ``cache_specs`` give on a stub mesh of that shape (the
    reference's resolver reads ``axis_names`` and ``devices.shape`` only),
    plus the rank's rows of the batch (the whole batch-1 token of
    ``long_500k``, whose K/V sequence splits instead); the row records the
    reference's ``mesh`` / ``n_chips`` and a census."""
    import types

    from repro import sharding as ref_sharding
    row = dryrun.plan_combo(arch, shape_name, mesh=mesh, layers="0:2")
    multi = mesh == "multipod"
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    assert (row["mesh"], row["n_chips"]) == (
        "2x16x16" if multi else "16x16", 512 if multi else 256)
    stub = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    sizes = dict(zip(axes, shape))
    n_edge = int(np.prod(shape[:-1]))
    ishape = ref_config.INPUT_SHAPES[shape_name]
    port_cfg = dryrun.layer_window(specs.adapt_model_for_shape(
        port_config.get_config(arch).model,
        port_config.INPUT_SHAPES[shape_name]), "0:2")
    ref_cfg = _ref_window(arch, shape_name, port_cfg)
    model = ref_build(ref_cfg)
    params = jax.eval_shape(model.init, jax.random.key(0))
    b, s = ishape.global_batch, ishape.seq_len
    if ishape.kind == "train":
        p_bytes = _spec_bytes(params, ref_sharding.param_specs(
            ref_cfg, stub, params, fsdp=True), sizes)
        want = 3 * p_bytes + dryrun.block_bytes(4) \
            + dryrun.block_bytes(b // n_edge * s * 4)
    else:
        want = _spec_bytes(params, ref_sharding.param_specs(
            ref_cfg, stub, params, fsdp=False), sizes)
        if ishape.kind == "prefill":
            want += dryrun.block_bytes(b // n_edge * s * 4)
        else:
            cache = jax.eval_shape(lambda: model.init_cache(b, s))
            want += _spec_bytes(cache, ref_sharding.cache_specs(
                ref_cfg, stub, cache, b), sizes)
            want += dryrun.block_bytes(
                (b // n_edge if b % n_edge == 0 else b) * 4)
    assert row["memory"]["argument_size_in_bytes"] == want
    assert row["ok"] and row["collectives"]["bytes_per_device"] > 0


def test_collective_term_reads_the_planners_census():
    """The roofline's collective term is the census's ``bytes_per_device``
    over NVLink's rate, above 0 for an ``el_round`` row and a pod row, and
    a pod row's global FLOPs count every chip."""
    el = dryrun.plan_combo("qwen3-1.7b", "train_4k", step_mode="el_round",
                           h_max=1, batch=4, seq_len=64, layers="0:2",
                           data_ranks=2)
    pod = dryrun.plan_combo("qwen3-1.7b", "prefill_32k", mesh="pod",
                            batch=16, seq_len=64, layers="0:2")
    for row in (el, pod):
        coll = row["collectives"]["bytes_per_device"]
        got = roofline.analyze(row)
        assert coll > 0 and got["t_collective_s"] == coll / roofline.NVLINK_BW
        assert got["collectives"] == row["collectives"]["per_op"]
    got = roofline.analyze(pod)
    assert got["chips"] == 256
    assert got["hlo_flops_global"] == pod["cost"]["flops"] * 256


def test_dryrun_cli_writes_rows_and_failed_rows(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                        "--step", "el_round", "--edges-per-rank", "3",
                        "--out", str(out)]) == 1
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows[0]["ok"] and rows[0]["collectives"] == {}
    assert {"memory", "cost", "fits", "plan_s", "params",
            "active_params"} <= set(rows[0])
    assert not rows[1]["ok"] and "does not split" in rows[1]["error"]
    assert "[OK] mamba2-370m long_500k 1x1" in capsys.readouterr().out
    # --skip-existing keeps the reference's key
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--out", str(out), "--skip-existing"]) == 0
    assert len(out.read_text().splitlines()) == 2
    with pytest.raises(SystemExit):
        dryrun.main(["--measure", "--out", str(out)])


# -- bench.roofline vs benchmarks/roofline.py -----------------------------------


def _synthetic_rows():
    def row(arch, shape, step, tag, flops, nbytes, coll, **kw):
        return {"arch": arch, "shape": shape, "mesh": "1x1", "n_chips": 1,
                "step": step, "tag": tag, "ok": True,
                "active_params": 1_700_000_000,
                "cost": {"flops": flops, "bytes accessed": nbytes},
                "collectives": {"bytes_per_device": coll,
                                "per_op": {"all-reduce": coll}},
                "memory": {"argument_size_in_bytes": 7}, **kw}
    return [
        row("qwen3-1.7b", "train_4k", "train_step", "", 3e16, 4e12, 0.0),
        row("qwen3-1.7b", "train_4k", "train_step", "calib1", 1e15, 2e11,
            5e8, n_groups_full=28),
        row("qwen3-1.7b", "train_4k", "train_step", "calib2", 2e15, 3e11,
            7e8, n_groups_full=28),
        row("olmoe-1b-7b", "prefill_32k", "prefill_step", "x", 5e15, 2e13,
            0.0),
        row("mamba2-370m", "decode_32k", "decode_step", "", 1e11, 8e9, 1e6),
        row("mamba2-370m", "long_500k", "decode_step", "", 1e9, 1e9, 0.0,
            ok=False),
    ]


def test_roofline_equals_the_references_rescaled():
    rows = _synthetic_rows()
    calib = roofline.calibration_index(rows)
    assert calib == ref_roofline.calibration_index(rows)
    scale = {"t_compute_s": ref_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS,
             "t_memory_s": ref_roofline.HBM_BW / roofline.HBM_BW,
             "t_collective_s": ref_roofline.ICI_BW / roofline.NVLINK_BW}
    got_rows = []
    for r in rows:
        assert roofline.model_flops(r) == ref_roofline.model_flops(r)
        got, want = roofline.analyze(r, calib), ref_roofline.analyze(r, calib)
        assert (got is None) == (want is None)
        if got is None:
            continue
        for k, f in scale.items():
            want[k] *= f
        terms = {k: want[f"t_{k}_s"] for k in
                 ("compute", "memory", "collective")}
        want["dominant"] = max(terms, key=terms.get)
        want["bound_s"] = max(terms.values())
        # the same advice, said of a card where the reference says chip
        want["suggestion"] = roofline.SUGGESTIONS[want["dominant"]]
        assert want["suggestion"].replace("card", "chip") \
            == ref_roofline.SUGGESTIONS[want["dominant"]]
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(got[k], float):
                assert got[k] == pytest.approx(want[k], rel=1e-12), k
            else:
                assert got[k] == want[k], k
        got_rows.append(got)
    assert roofline.markdown_table(got_rows) \
        == ref_roofline.markdown_table(got_rows)
    # the planner's overrides: model FLOPs at the row's batch x seq
    r = dict(rows[0], batch=4, seq_len=512)
    assert roofline.model_flops(r) == 6.0 * 1_700_000_000 * 4 * 512


# -- launch.train's classic flags vs the reference launcher -----------------------


SAMPLES, EDGES, BUDGET, ROUNDS = 1500, 3, 4000.0, 96


def test_train_launcher_alpha_and_kmeans_impl_match_the_reference(
        monkeypatch):
    """``--alpha 1.0 --kmeans-impl torch`` makes the reference launcher's
    ``--alpha 1.0 --kmeans-impl jnp`` decisions: the port handed the
    reference's init (as numpy) and its sync round's ``jax.random`` draws
    (``jax_round_draws``) through the RNG seam."""
    from repro.el import ELSession as JaxSession
    from repro.launch import train as ref_train
    from repro.launch.classic import classic_fixture as jax_fixture
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import classic
    from repro_torch.launch import train as port_train

    seen = {}
    real_ref_run = JaxSession.run_sync_ingraph

    def ref_run(self, *a, **kw):
        seen["ref"] = real_ref_run(self, *a, **kw)
        return seen["ref"]
    monkeypatch.setattr(JaxSession, "run_sync_ingraph", ref_run)
    argv = ["--arch", "kmeans-traffic", "--mode", "ol4el", "--el-mode",
            "sync", "--samples", str(SAMPLES), "--edges", str(EDGES),
            "--budget", str(BUDGET), "--steps", str(ROUNDS), "--alpha",
            "1.0"]
    ref_train.main(argv + ["--kmeans-impl", "jnp"])
    ref = seen["ref"]

    init = jax.tree.map(np.asarray, jax_fixture(
        "kmeans-traffic", samples=SAMPLES, n_edges=EDGES, alpha=1.0,
        kmeans_impl="jnp")["init_params"])
    real_fixture = classic.classic_fixture

    def fixture(*a, **kw):
        assert kw["alpha"] == 1.0 and kw["kmeans_impl"] == "torch"
        fx = real_fixture(*a, **kw)
        return dict(fx, init_params=params_from_numpy(init, "cpu"))
    monkeypatch.setattr(classic, "classic_fixture", fixture)
    real_port_run = ELSession.run_sync_ingraph

    def port_run(self, max_rounds=512, **kw):
        draws = jax_round_draws(self.cfg.seed + 17, max_rounds,
                                self.cfg.max_interval, EDGES,
                                self.cfg.max_interval,
                                self._executor.batch)
        return real_port_run(self, max_rounds=max_rounds,
                             draws=ReplayDraws(*draws), **kw)
    monkeypatch.setattr(ELSession, "run_sync_ingraph", port_run)
    got = port_train.main(argv + ["--kmeans-impl", "torch", "--device",
                                  "cpu"])
    assert [r.interval for r in got.records] \
        == [r.interval for r in ref.records]
    assert len(ref.records) > 12
    assert got.arm_pulls == ref.arm_pulls
    assert got.terminated_reason == ref.terminated_reason
    np.testing.assert_allclose([r.metric for r in got.records],
                               [r.metric for r in ref.records], atol=1e-5)
    # the E-step engine follows --kmeans-impl; the kernel needs a card
    args = port_train.parse_args(argv)
    assert args.alpha == 1.0 and args.kmeans_impl is None
    monkeypatch.undo()
    with pytest.raises(ValueError, match="cuda"):
        port_train.main(argv + ["--kmeans-impl", "cuda", "--device", "cpu",
                                "--steps", "2"])


# -- the examples on the CPU ------------------------------------------------------


def test_examples_run_on_the_cpu(tmp_path, capsys):
    """Each example at its smallest setting; ``train_lm_ol4el``'s
    checkpoint loads with the reference's ``repro.train.checkpoint``."""
    from repro.train import checkpoint as ref_ckpt
    from repro_torch.examples import quickstart, serve_batched, \
        train_lm_ol4el
    from repro_torch.interop import tree_to_numpy
    quick = quickstart.main(["--steps", "2", "--device", "cpu"])
    assert len(quick["losses"]) == 2 and len(quick["decoded"]) == 9
    assert all(np.isfinite(quick["losses"]))
    served = serve_batched.main(["--device", "cpu"])
    assert list(served) == list(serve_batched.ARCHS)
    assert all(r["tokens"].shape == (4, 17) for r in served.values())
    path = tmp_path / "lm.npz"
    rep = train_lm_ol4el.main(["--preset", "5m", "--rounds", "2", "--edges",
                               "2", "--batch", "2", "--seq", "32",
                               "--ckpt", str(path), "--device", "cpu"])
    assert rep.n_aggregations == 4 and np.isfinite(rep.final_metric)
    want = tree_to_numpy(rep.final_params)
    back = ref_ckpt.restore(str(path), jax.tree.map(jnp.asarray, want))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert ref_ckpt.latest_step(str(path)) == 4
    assert train_lm_ol4el.PRESETS.keys() == {"100m", "25m", "5m"}
    assert "saved checkpoint" in capsys.readouterr().out
