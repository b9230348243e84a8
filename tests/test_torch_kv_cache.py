"""Attention against a KV cache and the dense LM zoo in the port, on the CPU
vs the reference.

The four cache functions of ``repro_torch.models.layers``
(``attention_fill``, ``attention_decode`` and their ring forms) against
``repro.models.layers`` on the same numpy parameters, inputs and caches;
``LM.prefill`` followed by ``decode_step``s against the reference's
(logits and the whole cache tree at every step), with the KV cache and
with the ring cache of a sliding-window variant through more decode steps
than the ring holds; minicpm-2b's, qwen2.5-14b's and deepseek-coder-33b's
smoke ``LM.forward`` and ``LM.loss`` and parameter counts; minicpm-2b's
``wsd`` learning rates; ``window_slice`` (the decode's window-sized
gather at a device start, the blocked fills) against the reference and
against the masked path (a layer within 1e-6 of its masked output).  Configs: qwen3-1.7b's
smoke (per-head qk-norm), qwen2.5-14b's (QKV bias, set non-zero here),
minicpm-2b's (MHA, tied embeddings) and qwen3's with ``sliding_window=8``.

f32 is held to 1e-5.  A layer at bf16 is held to ``BF16_TOL``, the
reference kernel test's bf16 bound (as ``tests/test_torch_attention.py``);
the whole LM's prefill and decode at bf16 to ``LM_BF16_TOL``, the bound
``tests/test_torch_mamba2.py`` holds mamba2's to: both sides compute in
bf16 but round at other places (XLA keeps fused elementwise chains in
f32, torch rounds after every op), one or two bf16 ulps a layer, and a
2-layer model's cache carries the first layer's into the second.  The
port writes the cache in place, so each port call gets its own copy of
the numpy cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jax_L  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as port_L  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2e-2
LM_BF16_TOL = 6e-2
DTYPES = ["float32", "bfloat16"]
WINDOW = 8
# (name, arch, ModelConfig overrides): the configs every test runs on
VARIANTS = [("qwen3", "qwen3-1.7b", {}),
            ("qwen2.5", "qwen2.5-14b", {}),
            ("minicpm", "minicpm-2b", {}),
            ("qwen3-window", "qwen3-1.7b", {"sliding_window": WINDOW})]
VARIANT_IDS = [v[0] for v in VARIANTS]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_config.get_smoke_config(arch).model,
                                dtype=dtype, **kw),
            dataclasses.replace(port_config.get_smoke_config(arch).model,
                                dtype=dtype, **kw))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _tree_close(got, want, tol):
    got = tree_map(lambda a: np.asarray(a, np.float32), tree_to_numpy(got))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def _randomise(tree, seed, names=("bq", "bk", "bv", "q_norm", "k_norm",
                                  "norm")):
    """numpy tree with the named leaves (biases, norm scales; zero at
    init) drawn non-zero, so every branch moves the numbers."""
    rng = np.random.default_rng(seed)

    def visit(path, a):
        if getattr(path[-1], "key", None) in names:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(visit, tree)


def _cast(a, dtype):
    return np.asarray(jnp.asarray(a, getattr(jnp, dtype)))


# -- the four cache functions -------------------------------------------------


@pytest.fixture(scope="module", params=VARIANTS, ids=VARIANT_IDS)
def layer(request):
    """(ref cfg f32, port cfg f32, numpy attention params)."""
    _, arch, kw = request.param
    rc, tc = _cfgs(arch, **kw)
    p = _randomise(jax_L.init_attention(jax.random.key(3), rc), seed=3)
    return rc, tc, p


def _layer_inputs(rc, b, s, s_max, dtype, seed):
    """x [b, s, d] and a cache [b, s_max, KV, D] of random contents, in
    ``dtype`` (numpy; bf16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    shape = (b, s_max, rc.n_kv_heads, rc.resolved_head_dim)
    x = rng.standard_normal((b, s, rc.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    return tuple(_cast(a, dtype) for a in (x, ck, cv))


def _t(a):
    return tree_from_numpy(a, "cpu")


def _configured(layer, dtype):
    rc, tc, p = layer
    return (dataclasses.replace(rc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype),
            jax.tree.map(jnp.asarray, p), _t(p))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,ref_impl", [("naive", "naive"),
                                           ("kernel", "pallas"),
                                           ("blocked", "blocked")])
def test_attention_fill_matches_reference(layer, impl, ref_impl, dtype):
    """K/V land at [0, S) (the rest of the cache untouched) and the output
    is ``attention``'s; the reference fills with naive attention where the
    port runs the kernel's op (its plain version on the CPU)."""
    rc, tc, jp, tp = _configured(layer, dtype)
    x, ck, cv = _layer_inputs(rc, 2, 12, 20, dtype, seed=4)
    pos = np.arange(12)
    want = jax_L.attention_fill(jp, rc, jnp.asarray(x), jnp.asarray(pos),
                                jnp.asarray(ck), jnp.asarray(cv),
                                impl=ref_impl)
    got = port_L.attention_fill(tp, tc, _t(x), torch.from_numpy(pos),
                                _t(ck), _t(cv), impl=impl)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, _tol(dtype))
    assert np.array_equal(_f32(got[1])[:, 12:], _f32(ck)[:, 12:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [5, WINDOW, 19])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention_fill_ring_matches_reference(impl, s, dtype):
    """The last min(S, ring) positions land at position mod ring: a short
    prompt, one that fills the ring exactly, one that wraps it."""
    rc, tc = _cfgs("qwen3-1.7b", sliding_window=WINDOW)
    p = _randomise(jax_L.init_attention(jax.random.key(5), rc), seed=5)
    rc, tc = (dataclasses.replace(c, dtype=dtype) for c in (rc, tc))
    x, ck, cv = _layer_inputs(rc, 2, s, WINDOW, dtype, seed=6)
    pos = np.arange(s)
    want = jax_L.attention_fill_ring(jax.tree.map(jnp.asarray, p), rc,
                                     jnp.asarray(x), jnp.asarray(pos),
                                     jnp.asarray(ck), jnp.asarray(cv))
    got = port_L.attention_fill_ring(_t(p), tc, _t(x), torch.from_numpy(pos),
                                     _t(ck), _t(cv), impl=impl)
    for g, w in zip(got, want):
        _close(g, w, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index", [0, 9, 19, 23])
def test_attention_decode_matches_reference(layer, index, dtype):
    """One token at a device-tensor index against a cache of 20: the
    write, the causal mask over S_max (and the window), and the
    reference's clamped write past the end (index 23)."""
    rc, tc, jp, tp = _configured(layer, dtype)
    x, ck, cv = _layer_inputs(rc, 3, 1, 20, dtype, seed=7 + index)
    want = jax_L.attention_decode(jp, rc, jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv),
                                  jnp.asarray(index, jnp.int32))
    got = port_L.attention_decode(tp, tc, _t(x), _t(ck), _t(cv),
                                  torch.tensor(index, dtype=torch.int32))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_ring_matches_reference(dtype):
    """A ring of 8 filled by a 5-token prompt, then 14 decode steps: the
    ring wraps and the window masks older slots; every step's output and
    ring equal the reference's."""
    rc, tc = _cfgs("qwen3-1.7b", dtype=dtype, sliding_window=WINDOW)
    p = _randomise(jax_L.init_attention(jax.random.key(8), rc), seed=8)
    jp, tp = jax.tree.map(jnp.asarray, p), _t(p)
    x, ck, cv = _layer_inputs(rc, 2, 5, WINDOW, dtype, seed=9)
    pos = np.arange(5)
    _, jk, jv = jax_L.attention_fill_ring(jp, rc, jnp.asarray(x),
                                          jnp.asarray(pos), jnp.asarray(ck),
                                          jnp.asarray(cv))
    _, tk, tv = port_L.attention_fill_ring(tp, tc, _t(x),
                                           torch.from_numpy(pos), _t(ck),
                                           _t(cv))
    rng = np.random.default_rng(10)
    for index in range(5, 19):
        xt = _cast(rng.standard_normal((2, 1, rc.d_model)).astype(
            np.float32), dtype)
        y_ref, jk, jv = jax_L.attention_decode_ring(
            jp, rc, jnp.asarray(xt), jk, jv, jnp.asarray(index, jnp.int32))
        y, tk, tv = port_L.attention_decode_ring(
            tp, tc, _t(xt), tk, tv, torch.tensor(index, dtype=torch.int32))
        for g, w in ((y, y_ref), (tk, jk), (tv, jv)):
            _close(g, w, _tol(dtype))


# a layer's window_slice output against its masked output: the same ops
# over a shorter row (summation order only), held to 1e-6; against the
# reference the f32 tier F32_TOL (one element of 768 was 1.39e-6 apart at
# 1e-6), and through a whole LM's decode, where layer 0's difference
# reaches layer 1's K and V, F32_TOL on / off too (2.7e-6 measured)
WS_TOL = 1e-6


@pytest.mark.parametrize("index", [0, 5, 9, 19, 23])
def test_window_slice_decode_matches_reference_and_the_masked_decode(index):
    """``window_slice``: one token against a cache of 20 reads only the
    window + 1 rows ending at it (the start clamped at 0 and at S_max -
    span, the write clamped past the end at index 23): the output and
    cache equal the reference's ``window_slice`` decode (``F32_TOL``) and
    the port's masked decode (1e-6)."""
    rc, tc = _cfgs("qwen3-1.7b", sliding_window=WINDOW)
    p = _randomise(jax_L.init_attention(jax.random.key(11), rc), seed=11)
    x, ck, cv = _layer_inputs(rc, 3, 1, 20, "float32", seed=12 + index)
    want = jax_L.attention_decode(jax.tree.map(jnp.asarray, p), rc,
                                  jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv),
                                  jnp.asarray(index, jnp.int32),
                                  window_slice=True)
    got, masked = (port_L.attention_decode(
        _t(p), tc, _t(x), _t(ck), _t(cv),
        torch.tensor(index, dtype=torch.int32), window_slice=ws)
        for ws in (True, False))
    for g, w, m in zip(got, want, masked):
        assert tuple(g.shape) == w.shape
        _close(g, w, F32_TOL)
        np.testing.assert_allclose(_f32(g), _f32(m), atol=WS_TOL,
                                   rtol=WS_TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_window_slice_fills_match_reference(ring):
    """``attention_fill`` and ``attention_fill_ring`` on the blocked path
    with ``window_slice``: output and cache equal the reference's
    (``F32_TOL``) and the port's without the option (1e-6)."""
    rc, tc = _cfgs("qwen3-1.7b", sliding_window=WINDOW)
    p = _randomise(jax_L.init_attention(jax.random.key(13), rc), seed=13)
    x, ck, cv = _layer_inputs(rc, 2, 19, WINDOW if ring else 24,
                              "float32", seed=14)
    pos = np.arange(19)
    ref_fill = jax_L.attention_fill_ring if ring else jax_L.attention_fill
    fill = port_L.attention_fill_ring if ring else port_L.attention_fill
    want = ref_fill(jax.tree.map(jnp.asarray, p), rc, jnp.asarray(x),
                    jnp.asarray(pos), jnp.asarray(ck), jnp.asarray(cv),
                    impl="blocked", window_slice=True)
    got, plain = (fill(_t(p), tc, _t(x), torch.from_numpy(pos), _t(ck),
                       _t(cv), impl="blocked", window_slice=ws)
                  for ws in (True, False))
    for g, w, m in zip(got, want, plain):
        _close(g, w, F32_TOL)
        np.testing.assert_allclose(_f32(g), _f32(m), atol=WS_TOL,
                                   rtol=WS_TOL)


def test_window_slice_decode_reads_nothing_back_to_the_host():
    """The slice starts at an index computed on the device: the decode
    runs on ``meta`` tensors (no values, so any read back to the host,
    ``.item()`` or a ``narrow`` at a tensor start, raises), and a whole
    ``LM.decode_step`` calls no host-reading tensor method."""
    from torch.overrides import TorchFunctionMode
    _, tc = _cfgs("qwen3-1.7b", sliding_window=WINDOW)
    p = tree_map(lambda t: t.to("meta"),
                 port_L.init_attention(torch.Generator().manual_seed(0), tc))
    ck = torch.zeros(2, 20, tc.n_kv_heads, tc.resolved_head_dim,
                     device="meta")
    y, k, _ = port_L.attention_decode(
        p, tc, torch.zeros(2, 1, tc.d_model, device="meta"), ck,
        ck.clone(), torch.tensor(13, device="meta"), window_slice=True)
    assert y.shape == (2, 1, tc.d_model) and k is ck

    class HostReads(TorchFunctionMode):
        names = ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "numpy", "narrow")

        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in self.names:
                self.seen.append(name)
            return func(*args, **(kwargs or {}))
    tm = LM(tc, window_slice=True, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros(2, 12, dtype=torch.int32)
    _, cache = tm.prefill(params, toks, tm.init_cache(2, 20))
    with HostReads() as mode:
        tm.decode_step(params, toks[:, :1], cache)
    assert mode.seen == []


def test_lm_window_slice_prefill_and_decode_match_reference():
    """``LM(window_slice=True)`` on the windowed qwen3 (window 8, cache
    32): a 9-token prefill and 15 decode steps, logits and caches within
    1e-5 of the reference's ``window_slice`` model and of the port's
    masked one."""
    rc, tc = _cfgs("qwen3-1.7b", sliding_window=WINDOW)
    rp = jax.tree.map(jnp.asarray, _randomise(
        jax_build(rc).init(jax.random.key(0)), seed=1))
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(2).integers(0, rc.vocab_size,
                                             (3, 24)).astype(np.int32)
    rm = jax_build(rc, window_slice=True)
    tm, masked = (LM(tc, window_slice=ws, device="cpu")
                  for ws in (True, False))
    ref_decode = jax.jit(rm.decode_step)
    out_ref = rm.prefill(rp, jnp.asarray(toks[:, :9]), rm.init_cache(3, 32))
    out = tm.prefill(tp, torch.from_numpy(toks[:, :9]), tm.init_cache(3, 32))
    out_m = masked.prefill(tp, torch.from_numpy(toks[:, :9]),
                           masked.init_cache(3, 32))
    for t in range(9, 25):
        _tree_close(out, out_ref, F32_TOL)
        _tree_close(out, tree_to_numpy(out_m), F32_TOL)
        if t == 24:
            break
        tok = toks[:, t:t + 1]
        out_ref = ref_decode(rp, jnp.asarray(tok), out_ref[1])
        out = tm.decode_step(tp, torch.from_numpy(tok), out[1])
        out_m = masked.decode_step(tp, torch.from_numpy(tok), out_m[1])


# -- the LM: prefill and decode -----------------------------------------------


@pytest.fixture(scope="module", params=VARIANTS, ids=VARIANT_IDS)
def lm(request):
    """(variant name, arch, overrides, ref params, port params, tokens)."""
    name, arch, kw = request.param
    rc, _ = _cfgs(arch, **kw)
    rp = jax_build(rc).init(jax.random.key(0))
    rp = jax.tree.map(jnp.asarray, _randomise(rp, seed=1))
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(2).integers(0, rc.vocab_size,
                                             (3, 24)).astype(np.int32)
    return name, arch, kw, rp, tp, toks


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,ref_impl", [("naive", "auto"),
                                           ("kernel", "pallas")])
def test_prefill_and_decode_steps_match_reference(lm, impl, ref_impl,
                                                  dtype):
    """A 9-token prefill into a cache of 32 (a ring of 8 for the windowed
    variant), then 15 decode steps: logits and the whole cache tree
    (stacked groups' K and V, the scalar index) after every call."""
    _, arch, kw, rp, tp, toks = lm
    rc, tc = _cfgs(arch, dtype, **kw)
    tol = F32_TOL if dtype == "float32" else LM_BF16_TOL
    ring = bool(kw)
    rm = jax_build(rc, attn_impl=ref_impl, ring_cache=ring)
    tm = LM(tc, attn_impl=impl, ring_cache=ring, device="cpu")
    assert tm.ring_cache == ring
    ref_decode = jax.jit(rm.decode_step)
    logits_ref, cache_ref = rm.prefill(rp, jnp.asarray(toks[:, :9]),
                                       rm.init_cache(3, 32))
    cache = tm.init_cache(3, 32)
    logits, cache = tm.prefill(tp, torch.from_numpy(toks[:, :9]), cache)
    assert logits.shape == (3, 9, tc.vocab_size)
    assert cache["groups"]["sub0"]["k"].shape[2] == (WINDOW if ring else 32)
    _tree_close({"logits": logits, "cache": cache},
                {"logits": logits_ref, "cache": cache_ref}, tol)
    for t in range(9, 24):
        tok = toks[:, t:t + 1]
        logits_ref, cache_ref = ref_decode(rp, jnp.asarray(tok), cache_ref)
        logits, cache = tm.decode_step(tp, torch.from_numpy(tok), cache)
        _tree_close({"logits": logits, "cache": cache},
                    {"logits": logits_ref, "cache": cache_ref}, tol)
    assert int(cache["index"]) == 24


def test_prefill_writes_the_cache_in_place(lm):
    """The stacked K/V the caller passed are the ones returned, filled:
    no per-call copy of the cache."""
    _, arch, kw, _, tp, toks = lm
    _, tc = _cfgs(arch, **kw)
    tm = LM(tc, ring_cache=bool(kw), device="cpu")
    cache = tm.init_cache(3, 32)
    k = cache["groups"]["sub0"]["k"]
    _, filled = tm.prefill(tp, torch.from_numpy(toks[:, :9]), cache)
    assert filled["groups"]["sub0"]["k"] is k and bool(k.abs().sum() > 0)
    _, stepped = tm.decode_step(tp, torch.from_numpy(toks[:, 9:10]), filled)
    assert stepped["groups"]["sub0"]["v"] is cache["groups"]["sub0"]["v"]


def test_prefill_fills_through_the_kernel_op_and_decode_does_not(lm,
                                                               monkeypatch):
    """With ``attn_impl="kernel"`` every attention layer's fill goes
    through ``flash_attention``'s op (its plain version here, the kernel
    on a CUDA tensor), once a layer a prefill; a decode step never does."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    _, arch, kw, _, tp, toks = lm
    _, tc = _cfgs(arch, **kw)
    calls = []
    forward = fa_ops._forward
    monkeypatch.setattr(fa_ops, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    tm = LM(tc, attn_impl="kernel", ring_cache=bool(kw), device="cpu")
    _, cache = tm.prefill(tp, torch.from_numpy(toks[:, :9]),
                          tm.init_cache(3, 32))
    assert len(calls) == tc.n_layers
    tm.decode_step(tp, torch.from_numpy(toks[:, 9:10]), cache)
    assert len(calls) == tc.n_layers


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_prefill_decode_matches_forward_in_the_port(variant):
    """prefill + decode logits == full-forward logits on the port's own
    init (the reference's ``test_prefill_decode_matches_forward``)."""
    _, arch, kw = variant
    _, tc = _cfgs(arch, **kw)
    m = LM(tc, ring_cache=bool(kw), device="cpu")
    params = m.init(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, (2, 20)).astype(np.int32))
    full, _ = m.forward(params, tokens)
    _, cache = m.prefill(params, tokens[:, :12], m.init_cache(2, 32))
    for t in range(12, 20):
        step, cache = m.decode_step(params, tokens[:, t:t + 1], cache)
        _close(step[:, 0], full[:, t], 1e-4)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_cache_tree_matches_reference(variant):
    _, arch, kw = variant
    rc, tc = _cfgs(arch, "bfloat16", **kw)
    ring = bool(kw)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax_build(rc, ring_cache=ring).init_cache(3, 16))
    got = tree_map(lambda t: (tuple(t.shape),
                              str(t.dtype).replace("torch.", "")),
                   LM(tc, ring_cache=ring, device="cpu").init_cache(3, 16))
    assert got == want


def test_ring_cache_needs_a_window():
    """As the reference's: ``ring_cache`` is off for a model without a
    sliding window, whose cache keeps every position."""
    _, tc = _cfgs("qwen3-1.7b")
    m = LM(tc, ring_cache=True, device="cpu")
    assert not m.ring_cache
    assert m.init_cache(2, 24)["groups"]["sub0"]["k"].shape[2] == 24


# -- the dense zoo: forward, loss, configs, schedule --------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-14b",
                                  "deepseek-coder-33b"])
def test_forward_and_loss_match_reference(arch, dtype):
    """Smoke ``LM.forward`` and ``LM.loss`` (with and without a loss mask)
    through the kernel path, as ``tests/test_torch_attention.py`` checks
    qwen3's (the whole LM: bf16 to ``LM_BF16_TOL``)."""
    rc, tc = _cfgs(arch, dtype)
    tol = F32_TOL if dtype == "float32" else LM_BF16_TOL
    rp = jax.tree.map(jnp.asarray, _randomise(
        jax_build(rc).init(jax.random.key(6)), seed=6))
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(7).integers(0, rc.vocab_size,
                                             (2, 33)).astype(np.int32)
    rm = jax_build(rc, attn_impl="pallas")
    tm = LM(tc, attn_impl="kernel", device="cpu")
    want, _ = rm.forward(rp, jnp.asarray(toks))
    got, _ = tm.forward(tp, torch.from_numpy(toks))
    _close(got, want, tol)
    mask = (np.arange(32)[None, :] % 4 != 0).astype(np.float32) \
        * np.ones((2, 1), np.float32)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        want_loss, _ = rm.loss(rp, jax.tree.map(jnp.asarray, batch))
        loss, _ = tm.loss(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        _close(loss, want_loss, tol)


@pytest.mark.parametrize("arch,n", [("minicpm-2b", 2_724_880_896),
                                    ("qwen2.5-14b", 14_770_033_664),
                                    ("deepseek-coder-33b", 33_342_991_360)])
def test_full_config_parameter_count(arch, n):
    """The analytic count, the reference's; the smoke trees hold as many
    leaves' elements as the reference's init."""
    cfg = port_config.get_config(arch).model
    assert cfg.num_params() == n == \
        jax_config.get_config(arch).model.num_params()
    rc, tc = _cfgs(arch)
    want = sum(a.size for a in jax.tree.leaves(
        jax_build(rc).init(jax.random.key(0))))
    got = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(a.size for a in jax.tree.leaves(tree_to_numpy(got))) \
        == want


def test_minicpm_wsd_learning_rates_match_reference():
    """minicpm-2b's own TrainConfig (``wsd``, 100 warmup steps, decay from
    90 % of the run): the first steps' tiny rates, the stable plateau and
    the decay tail."""
    port, ref = (port_config.get_config("minicpm-2b").train,
                 jax_config.get_config("minicpm-2b").train)
    assert port.schedule == "wsd" and port == port.__class__(
        **dataclasses.asdict(ref))
    total = port.total_steps
    for step in [0, 1, 2, 3, 50, 99, 100, 101, int(0.9 * total) - 1,
                 int(0.9 * total) + 1, total - 1, total, total + 10]:
        np.testing.assert_allclose(float(port_opt.lr_schedule(port, step)),
                                   float(jax_opt.lr_schedule(ref, step)),
                                   rtol=1e-6)
