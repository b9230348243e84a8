"""The port's attention stack and the qwen3 LM on the CPU vs the reference.

RoPE, the q/k/v projections (with qkv bias and per-head qk-norm), every
attention path (naive, blocked, and the kernel path: the reference's
Pallas kernel in interpret mode against the port's op, whose CPU path is
its plain version), the gated MLP, and qwen3-1.7b's smoke config through
``LM.forward`` and ``LM.loss`` and the loss gradient.  Parameters come
from the reference's initialisers and are carried into the port with
``tree_from_numpy``; inputs are drawn with numpy.  f32 is held to 1e-5
(the layers, the logits and the loss) and 1e-4 (the gradient tree); bf16
to ``BF16_TOL``, the reference kernel test's bf16 bound.
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
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as port_L  # noqa: E402
from repro_torch.train.state import loss_and_grads  # noqa: E402

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2

# a GQA layer with every option the attention code branches on
LAYER = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
             qkv_bias=True, qk_norm=True, rope_theta=1e6, d_ff=256)


def _cfgs(**kw):
    return jax_config.ModelConfig(**kw), port_config.ModelConfig(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _attn_params(rc, seed=0):
    """Reference-initialised attention params with non-zero biases and
    norm scales, as (jax tree, port tree)."""
    p = jax.tree.map(np.asarray, jax_L.init_attention(jax.random.key(seed),
                                                      rc))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm", "norm"):
        if name in p:
            p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(
                np.float32)
    return jax.tree.map(jnp.asarray, p), tree_from_numpy(p, "cpu")


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    x = np.random.default_rng(1).standard_normal((2, 16, 4, 64)).astype(
        np.float32)
    pos = np.arange(16)
    want = jax_L.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = port_L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, F32_TOL)
    _close(port_L.rope_freqs(64, theta), jax_L.rope_freqs(64, theta), 1e-7)


def test_qkv_with_bias_and_qk_norm_matches_reference():
    rc, tc = _cfgs(**LAYER)
    jp, tp = _attn_params(rc)
    x = _x(2, 24, rc.d_model, 2)
    pos = np.arange(24)
    want = jax_L._qkv(jp, rc, jnp.asarray(x), jnp.asarray(pos))
    got = port_L._qkv(tp, tc, torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("impl,ref_impl", [("naive", "naive"),
                                           ("blocked", "blocked"),
                                           ("kernel", "pallas")])
def test_attention_paths_match_reference(impl, ref_impl, window):
    rc, tc = _cfgs(**LAYER, sliding_window=window)
    jp, tp = _attn_params(rc, seed=3)
    x = _x(2, 48, rc.d_model, 4)
    pos = np.arange(48)
    want = jax_L.attention(jp, rc, jnp.asarray(x), jnp.asarray(pos),
                           impl=ref_impl)
    got = port_L.attention(tp, tc, torch.from_numpy(x), torch.from_numpy(pos),
                           impl=impl)
    _close(got, want, F32_TOL)


def test_blocked_attention_over_several_chunks_matches_reference():
    """40 rows in chunks of 16: three chunks, the last padded."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 40, h, 64)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.arange(40)
    want = jax_L._blocked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                    8, 0.125, block_q=16)
    got = port_L._blocked_attention(*map(torch.from_numpy, (q, k, v, pos,
                                                            pos)),
                                    8, 0.125, block_q=16)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("block_q", [4, 16])
def test_blocked_attention_window_slice_matches_reference(block_q):
    """``window_slice``: 40 rows, window 8, each chunk of ``block_q``
    rows against only the ``8 + block_q`` keys ending at its last row
    (the first chunks' spans clamped at 0): the reference's
    ``window_slice`` output within 1e-5, the port's own masked output
    (the same ops over every key) within 1e-6."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 40, h, 64)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.arange(40)
    want = jax_L._blocked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                    8, 0.125, block_q=block_q,
                                    window_slice=True)
    got, masked = (port_L._blocked_attention(
        *map(torch.from_numpy, (q, k, v, pos, pos)), 8, 0.125,
        block_q=block_q, window_slice=ws) for ws in (True, False))
    _close(got, want, F32_TOL)
    np.testing.assert_allclose(_np(got), _np(masked), atol=1e-6, rtol=1e-6)


def test_unknown_attention_impl_raises():
    _, tc = _cfgs(**LAYER)
    _, tp = _attn_params(_cfgs(**LAYER)[0])
    with pytest.raises(ValueError, match="impl"):
        port_L.attention(tp, tc, torch.zeros(1, 4, 128), torch.arange(4),
                         impl="pallas")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    p = jax.tree.map(np.asarray, jax_L.init_mlp(jax.random.key(2), 64, 96))
    x = _x(2, 8, 64, 5)
    want = jax_L.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = port_L.mlp(tree_from_numpy(p, "cpu"), torch.from_numpy(x), act)
    _close(got, want, F32_TOL)


# -- the qwen3 LM --------------------------------------------------------------


def _smoke(dtype="float32"):
    return (dataclasses.replace(
                jax_config.get_smoke_config("qwen3-1.7b").model, dtype=dtype),
            dataclasses.replace(
                port_config.get_smoke_config("qwen3-1.7b").model,
                dtype=dtype))


@pytest.fixture(scope="module")
def qwen():
    """(ref cfg, port cfg, ref params, port params, tokens [2, 40])."""
    rc, tc = _smoke()
    rp = jax_build(rc).init(jax.random.key(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(1).integers(0, rc.vocab_size,
                                             (2, 40)).astype(np.int32)
    return rc, tc, rp, tp, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,ref_impl", [("kernel", "pallas"),
                                           ("naive", "naive")])
def test_forward_and_loss_match_reference(qwen, impl, ref_impl, dtype):
    _, _, rp, tp, toks = qwen
    rc, tc = _smoke(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rm = jax_build(rc, attn_impl=ref_impl)
    tm = LM(tc, attn_impl=impl, device="cpu")
    want_logits, _ = rm.forward(rp, jnp.asarray(toks))
    logits, aux = tm.forward(tp, torch.from_numpy(toks))
    assert logits.dtype == getattr(torch, dtype)
    assert all(float(v) == 0.0 for v in aux.values())
    _close(logits, want_logits, tol)
    mask = (np.arange(39)[None, :] % 3 != 0).astype(np.float32) \
        * np.ones((2, 1), np.float32)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        want_loss, want_m = rm.loss(rp, jax.tree.map(jnp.asarray, batch))
        loss, m = tm.loss(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        assert set(m) == set(want_m)
        _close(loss, want_loss, tol)
        for key in want_m:
            _close(m[key], want_m[key], tol)


def test_loss_gradient_tree_matches_reference(qwen):
    rc, tc, rp, tp, toks = qwen
    rm = jax_build(rc, attn_impl="pallas")
    want = jax.grad(lambda p: rm.loss(p, {"tokens": jnp.asarray(toks)})[0])(
        rp)
    m, grads = loss_and_grads(LM(tc, attn_impl="kernel", device="cpu"), tp,
                              {"tokens": torch.from_numpy(toks)})
    got = tree_map(lambda a: a.astype(np.float32), tree_to_numpy(grads))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    assert m["loss"].grad_fn is None


def test_remat_gives_the_same_loss_and_gradients(qwen):
    """``cfg.remat`` checkpoints each layer group: same numbers, and the
    kernel path's forward runs once more per layer in the backward."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    _, tc, _, tp, toks = qwen
    batch = {"tokens": torch.from_numpy(toks)}
    plain = loss_and_grads(LM(tc, attn_impl="kernel", device="cpu"), tp,
                           batch)
    remat_cfg = dataclasses.replace(tc, remat=True)
    calls = []
    orig = fa_ops._forward
    try:
        fa_ops._forward = lambda *a: calls.append(1) or orig(*a)
        remat = loss_and_grads(LM(remat_cfg, attn_impl="kernel",
                                  device="cpu"), tp, batch)
    finally:
        fa_ops._forward = orig
    assert len(calls) == 2 * tc.n_layers
    _close(remat[0]["loss"], plain[0]["loss"], 0.0)
    for g, w in zip(jax.tree.leaves(tree_to_numpy(remat[1])),
                    jax.tree.leaves(tree_to_numpy(plain[1]))):
        np.testing.assert_array_equal(g, w)


def test_parameter_tree_carries_across(qwen):
    """The port's init has the reference's tree (keys, shapes, dtypes),
    and a reference tree survives the trip through the port unchanged."""
    rc, tc, rp, tp, _ = qwen
    mine = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    shape = lambda t: (tuple(t.shape), str(t.dtype).replace(  # noqa: E731
        "torch.", ""))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rp)
    assert tree_map(shape, mine) == want
    back = tree_to_numpy(tp)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        np.testing.assert_array_equal(g, np.asarray(w))
    # num_params() is the reference's analytic count: it leaves out the
    # per-head q/k norm scales (2 * head_dim per layer), in both packages
    n = sum(a.size for a in jax.tree.leaves(rp))
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == n
    assert n == tc.num_params() + tc.n_layers * 2 * tc.resolved_head_dim


def test_full_config_parameter_count():
    cfg = port_config.get_config("qwen3-1.7b").model
    assert cfg.num_params() == 1_720_567_808
    assert cfg.num_params() == \
        jax_config.get_config("qwen3-1.7b").model.num_params()


def test_kv_cache_tree_window_slice_and_fused_xent_match_reference():
    rc, tc = _smoke()
    # the KV cache: the reference's tree, K and V [n_groups, B, max_len,
    # KV, D]
    cache = LM(tc, device="cpu").init_cache(2, 16)
    want = jax.tree.map(lambda a: a.shape, jax_build(rc).init_cache(2, 16))
    assert tree_map(lambda t: tuple(t.shape), cache) == want
    # window_slice on the blocked path of a windowed model: the
    # reference's window_slice forward
    rw, tw = (dataclasses.replace(c, sliding_window=8) for c in (rc, tc))
    rp = jax_build(rw).init(jax.random.key(2))
    wtoks = np.random.default_rng(2).integers(0, rc.vocab_size,
                                              (2, 24)).astype(np.int32)
    want = jax_build(rw, attn_impl="blocked", window_slice=True).forward(
        rp, jnp.asarray(wtoks))[0]
    got = LM(tw, attn_impl="blocked", window_slice=True, device="cpu"
             ).forward(tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu"),
                       torch.from_numpy(wtoks))[0]
    _close(got, want, F32_TOL)
    # fused_xent: the same loss as log_softmax
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 12)).astype(np.int32))
    params = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    fused = LM(tc, fused_xent=True, device="cpu").loss(params,
                                                       {"tokens": toks})[0]
    plain = LM(tc, device="cpu").loss(params, {"tokens": toks})[0]
    np.testing.assert_allclose(float(fused), float(plain), rtol=1e-6)
    with pytest.raises(ValueError, match="attn_impl"):
        LM(tc, attn_impl="pallas", device="cpu")
