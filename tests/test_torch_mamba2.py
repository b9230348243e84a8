"""The port's Mamba-2 stack (mixer, decode step, LM prefill/decode) vs the
JAX reference's, on mamba2-370m's smoke config.

Parameters come from the reference's ``LM.init`` and are carried into the
port with ``tree_from_numpy``; tokens are drawn with numpy.  f32 runs are
held to 1e-4.  bf16 runs are held to ``BF16_TOL``: both sides compute in
bf16 but round at other places (XLA keeps fused elementwise chains in
f32, torch rounds after every op), which moves values by one or two bf16
ulps (2^-7 relative) per layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import mamba2 as jax_m  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.models import LM, build_model  # noqa: E402
from repro_torch.models import mamba2 as port_m  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, restored after: its runs are
    many small ops, and beside the other test workers torch's OpenMP pool
    spin-waits between them (the same loaded test ran 4x faster so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = 1e-4
BF16_TOL = 6e-2
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _cfgs(dtype):
    return (dataclasses.replace(
                jax_config.get_smoke_config("mamba2-370m").model, dtype=dtype),
            dataclasses.replace(
                port_config.get_smoke_config("mamba2-370m").model,
                dtype=dtype))


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_tree_close(port_tree, ref_tree, tol):
    port_np = tree_map(lambda a: np.asarray(a, np.float32),
                       tree_to_numpy(port_tree))
    ref_np = _to_np(ref_tree)
    assert jax.tree.structure(port_np) == jax.tree.structure(ref_np)
    for p, r in zip(jax.tree.leaves(port_np), jax.tree.leaves(ref_np)):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=DTYPES)
def pair(request):
    """(dtype, ref cfg, port cfg, ref model, ref params, port params)."""
    rc, tc = _cfgs(request.param)
    rm = jax_build(rc)
    rp = rm.init(jax.random.key(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return request.param, rc, tc, rm, rp, tp


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seq", [40, 24])
def test_mixer_with_state_matches_reference(pair, seq, use_kernel):
    """40 steps under chunk 32 exercises the padding; 24 a single short
    chunk.  ``use_kernel`` selects the reference's Pallas path (interpret
    mode here) and the port's op (its CPU path)."""
    dtype, rc, tc, _, rp, tp = pair
    h = np.random.default_rng(seq).standard_normal(
        (2, seq, rc.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda a: a[0], rp["groups"]["sub0"]["mix"])
    p_port = tree_map(lambda a: a[0], tp["groups"]["sub0"]["mix"])
    y_ref, c_ref = jax_m.mamba_mixer_with_state(
        p_ref, rc, jnp.asarray(h, getattr(jnp, dtype)), use_kernel=use_kernel)
    y, c = port_m.mamba_mixer_with_state(
        p_port, tc, torch.from_numpy(h).to(getattr(torch, dtype)),
        use_kernel=use_kernel)
    assert y.dtype == getattr(torch, dtype)
    _assert_tree_close({"y": y, **c}, {"y": y_ref, **c_ref}, _tol(dtype))


def test_mamba_decode_matches_reference(pair):
    dtype, rc, tc, _, rp, tp = pair
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 12, rc.d_model)).astype(np.float32)
    h_t = rng.standard_normal((2, 1, rc.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda a: a[1], rp["groups"]["sub0"]["mix"])
    p_port = tree_map(lambda a: a[1], tp["groups"]["sub0"]["mix"])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, cache_ref = jax_m.mamba_mixer_with_state(p_ref, rc,
                                                jnp.asarray(h, jd))
    cache = tree_from_numpy(jax.tree.map(np.asarray, cache_ref), "cpu")
    y_ref, new_ref = jax_m.mamba_decode(p_ref, rc, jnp.asarray(h_t, jd),
                                        cache_ref)
    y, new = port_m.mamba_decode(p_port, tc, torch.from_numpy(h_t).to(td),
                                 cache)
    _assert_tree_close({"y": y, **new}, {"y": y_ref, **new_ref}, _tol(dtype))


@pytest.mark.parametrize("ref_kernel", [False, True])
def test_prefill_matches_reference(pair, ref_kernel):
    """Logits and the whole cache tree (stacked groups, scalar index)."""
    dtype, rc, tc, _, rp, tp = pair
    toks = _tokens(2, 40, rc.vocab_size, seed=1)
    rm = jax_build(rc, use_ssd_kernel=ref_kernel)
    logits_ref, cache_ref = rm.prefill(rp, jnp.asarray(toks),
                                       rm.init_cache(2, 64))
    tm = LM(tc, device="cpu")
    logits, cache = tm.prefill(tp, torch.from_numpy(toks),
                               tm.init_cache(2, 64))
    assert logits.shape == (2, 40, tc.vocab_size)
    assert int(cache["index"]) == 40
    _assert_tree_close({"logits": logits, "cache": cache},
                       {"logits": logits_ref, "cache": cache_ref},
                       _tol(dtype))


def test_decode_steps_match_reference(pair):
    dtype, rc, tc, rm, rp, tp = pair
    toks = _tokens(2, 20, rc.vocab_size, seed=2)
    _, cache_ref = rm.prefill(rp, jnp.asarray(toks[:, :16]),
                              rm.init_cache(2, 32))
    tm = LM(tc, device="cpu")
    _, cache = tm.prefill(tp, torch.from_numpy(toks[:, :16]),
                          tm.init_cache(2, 32))
    for t in range(16, 20):
        tok = toks[:, t:t + 1]
        logits_ref, cache_ref = rm.decode_step(rp, jnp.asarray(tok),
                                               cache_ref)
        logits, cache = tm.decode_step(tp, torch.from_numpy(tok), cache)
        _assert_tree_close({"logits": logits, "cache": cache},
                           {"logits": logits_ref, "cache": cache_ref},
                           _tol(dtype))
    assert int(cache["index"]) == 20


def test_forward_matches_reference_f32():
    rc, tc = _cfgs("float32")
    rm = jax_build(rc)
    rp = rm.init(jax.random.key(3))
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = _tokens(2, 33, rc.vocab_size, seed=3)
    logits_ref, _ = rm.forward(rp, jnp.asarray(toks))
    logits, aux = LM(tc, device="cpu").forward(tp, torch.from_numpy(toks))
    _assert_tree_close(logits, logits_ref, F32_TOL)
    assert float(aux["n_moe"]) == 0.0
    last, _ = LM(tc, device="cpu").forward(tp, torch.from_numpy(toks),
                                           last_only=True)
    torch.testing.assert_close(last[:, 0], logits[:, -1])


def test_prefill_decode_matches_forward_in_the_port():
    """prefill + decode logits == full-forward logits (the reference's
    test_prefill_decode_matches_forward), on the port's own init."""
    _, tc = _cfgs("float32")
    m = build_model(tc, device="cpu")
    params = m.init(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_tokens(2, 24, tc.vocab_size, seed=4))
    full_logits, _ = m.forward(params, tokens)
    _, cache = m.prefill(params, tokens[:, :-1], m.init_cache(2, 32))
    dec_logits, cache = m.decode_step(params, tokens[:, -1:], cache)
    err = float((full_logits[:, -1] - dec_logits[:, 0]).abs().max())
    assert err < 2e-3, f"prefill/decode mismatch {err}"
    assert int(cache["index"]) == 24


def test_port_init_has_the_reference_tree():
    """Same structure, shapes and dtypes as the reference's init (so the
    trees carry across), f32 leaves, values from the stated inits."""
    rc, tc = _cfgs("bfloat16")
    ref_shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                              jax_build(rc).init(jax.random.key(0)))
    params = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    port_shapes = tree_map(lambda t: (tuple(t.shape),
                                      str(t.dtype).replace("torch.", "")),
                           params)
    assert port_shapes == ref_shapes
    mix = params["groups"]["sub0"]["mix"]
    std = 1.0 / np.sqrt(tc.d_model)
    assert float(mix["in_proj"].abs().max()) <= 2 * std + 1e-7
    assert abs(float(mix["in_proj"].std()) / std - 0.88) < 0.05
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.05)
    n_heads = tc.mamba.n_heads(tc.d_model)
    torch.testing.assert_close(mix["A_log"][0], torch.log(
        torch.arange(1, n_heads + 1, dtype=torch.float32)))
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    again = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], params["embed"])


def test_cache_tree_matches_reference():
    rc, tc = _cfgs("bfloat16")
    ref_cache = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                             jax_build(rc).init_cache(3, 16))
    cache = LM(tc, device="cpu").init_cache(3, 16)
    assert tree_map(lambda t: (tuple(t.shape),
                               str(t.dtype).replace("torch.", "")),
                    cache) == ref_cache


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen3-1.7b", "svm-wafer",
                                  "kmeans-traffic", "minicpm-2b",
                                  "qwen2.5-14b", "deepseek-coder-33b",
                                  "olmoe-1b-7b", "deepseek-moe-16b",
                                  "musicgen-medium", "paligemma-3b",
                                  "jamba-1.5-large-398b"])
def test_config_equals_reference_field_for_field(arch, getter):
    port = getattr(port_config, getter)(arch)
    ref = getattr(jax_config, getter)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.model.block_pattern() == ref.model.block_pattern()


def test_num_params():
    cfg = port_config.get_config("mamba2-370m").model
    assert cfg.num_params() == 368_324_608
    assert cfg.num_params() == \
        jax_config.get_config("mamba2-370m").model.num_params()
    # num_params is the reference's analytic count (it rounds the small
    # per-layer vectors); the initialised trees hold the same number
    smoke = port_config.get_smoke_config("mamba2-370m").model
    params = LM(smoke, device="cpu").init(torch.Generator().manual_seed(0))
    ref_params = jax_build(jax_config.get_smoke_config(
        "mamba2-370m").model).init(jax.random.key(0))
    assert sum(t.numel() for t in jax.tree.leaves(params)) == \
        sum(a.size for a in jax.tree.leaves(ref_params))


def test_every_lm_arch_resolves_and_builds_every_block_kind():
    # every LM id of the reference resolves (jamba-1.5 the last, item
    # 13.6), so no id is left to name a slice; unknown ids still raise
    assert port_config.LM_SLICES == {}
    assert set(port_config.PORTED_LM_IDS) == set(jax_config.ARCH_IDS)
    for arch in ("paligemma-3b", "musicgen-medium", "jamba-1.5-large-398b"):
        assert port_config.get_config(arch).model.name == arch
        assert port_config.get_smoke_config(arch).model.name == \
            arch + "-smoke"
    with pytest.raises(KeyError, match="unknown arch"):
        port_config.get_config("gpt-5")
    # an SSM mixer with a MoE FFN, and attention and SSM layers in one
    # stack, build and run (item 13.6)
    hybrid = port_config.ModelConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=64,
        layer_pattern=(port_config.MAMBA,), dtype="float32",
        mamba=port_config.MambaConfig(d_state=16, head_dim=32,
                                      chunk_size=8),
        moe=port_config.MoEConfig(num_experts=4, expert_ffn_dim=32))
    mixed = dataclasses.replace(hybrid, layer_pattern=(
        port_config.MAMBA, port_config.ATTN), moe=port_config.MoEConfig())
    toks = torch.zeros(1, 8, dtype=torch.int32)
    for cfg in (hybrid, mixed):
        m = LM(cfg, device="cpu")
        logits, aux = m.forward(m.init(torch.Generator().manual_seed(0)),
                                toks)
        assert logits.shape == (1, 8, 64) and bool(torch.isfinite(
            logits).all())
        assert float(aux["n_moe"]) == (2.0 if cfg is hybrid else 0.0)
    attn = port_config.ModelConfig(n_layers=2)
    # multi-codebook heads and prefix embeddings build (item 13.5)
    cb = LM(dataclasses.replace(attn, n_codebooks=4, num_prefix_embeddings=2),
            device="cpu")
    assert cb.init(torch.Generator().manual_seed(0))["lm_head"].shape == (
        4, attn.d_model, attn.vocab_size)
    # window_slice and unstacked trees build (item 13.7)
    assert LM(attn, window_slice=True, device="cpu").window_slice
    flat = LM(dataclasses.replace(attn, d_model=64, n_heads=2, n_kv_heads=2,
                                  d_ff=64, vocab_size=32, scan_layers=False),
              device="cpu")
    groups = flat.init(torch.Generator().manual_seed(0))["groups"]
    assert isinstance(groups, list) and len(groups) == 2


def test_interop_round_trip_keeps_dtypes():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.array(3, np.int32),
                  np.linspace(0, 1, 5).astype(jnp.bfloat16)]}
    t = tree_from_numpy(tree, "cpu")
    assert t["b"][1].dtype == torch.bfloat16 and t["b"][0].dim() == 0
    back = tree_to_numpy(t)
    assert back["b"][1].dtype == tree["b"][1].dtype
    assert np.array_equal(back["b"][1].view(np.int16),
                          tree["b"][1].view(np.int16))
    assert np.array_equal(back["a"], tree["a"]) and back["b"][0] == 3
