"""Multi-codebook heads and prefix embeddings in the port, on the CPU vs
the reference.

musicgen-medium (4 codebooks: tokens ``[B, 4, S]``, the codebooks'
embeddings summed, one head per codebook, logits ``[B, 4, S, V]``) and
paligemma-3b (MQA, tied embeddings, precomputed ``prefix_emb [B, P, d]``
before the text) at smoke width, plus a tiny paligemma at head_dim 256
(2 query heads, 1 KV head; the smoke config's head_dim is 64), each from
the reference's own init carried across as numpy (norm scales drawn
non-zero): ``forward`` and ``loss`` (logits and loss within 1e-5) with
``fused_xent`` on and off against the reference's ``LM(fused_xent=True)``
and ``LM()``, the gradient tree within 1e-4; ``prefill`` (with the
prefix for paligemma) and 15 ``decode_step``s, logits and caches within
1e-5; the serving engine's greedy tokens against the reference engine's
with ``[CB, S]`` prompts and mid-flight admission, and its sampled
tokens under the reference engine's replayed Gumbel draws (one a
codebook, each slot's temperature over its codebooks); the step
factories; ``launch/serve.main(--smoke)``; ``SyntheticLMData``'s shapes
and dtypes; the codebook sum and the prefix at bf16 within the
per-function bf16 bound 2e-2; the full configs' parameter counts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train import state as jax_state  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_leaves, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.train.state import loss_and_grads  # noqa: E402

F32_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
ARCHS = ["musicgen-medium", "paligemma-3b"]
# (id, arch, ModelConfig overrides)
VARIANTS = [("musicgen", "musicgen-medium", {}),
            ("paligemma", "paligemma-3b", {}),
            ("paligemma-d256", "paligemma-3b",
             {"n_heads": 2, "n_kv_heads": 1, "head_dim": 256})]
VARIANT_IDS = [v[0] for v in VARIANTS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops on a CPU that other test processes load: one intra-op
    thread for this module (as ``tests/test_torch_moe.py``), restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_config.get_smoke_config(arch).model,
                                dtype=dtype, **kw),
            dataclasses.replace(port_config.get_smoke_config(arch).model,
                                dtype=dtype, **kw))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _tree_close(got, want, tol):
    got = tree_map(lambda a: np.asarray(a, np.float32), tree_to_numpy(got))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def _randomise(tree, seed):
    """numpy tree with the norm scales (zero at init) drawn non-zero."""
    rng = np.random.default_rng(seed)

    def visit(path, a):
        if getattr(path[-1], "key", None) in ("norm", "final_norm"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(visit, tree)


@functools.lru_cache(maxsize=None)
def _model(name):
    """(ref cfg, port cfg, ref params, port params) of a variant."""
    _, arch, kw = next(v for v in VARIANTS if v[0] == name)
    rc, tc = _cfgs(arch, **kw)
    rp = jax.tree.map(jnp.asarray, _randomise(
        jax.jit(jax_build(rc).init)(jax.random.key(0)), seed=1))
    return rc, tc, rp, tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _inputs(cfg, b, s, seed):
    """numpy tokens ([b, s] or [b, CB, s]) and, for a prefix model,
    prefix_emb [b, P, d]."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks > 1 else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.num_prefix_embeddings:
        out["prefix_emb"] = (0.5 * rng.standard_normal(
            (b, cfg.num_prefix_embeddings, cfg.d_model))).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=VARIANT_IDS)
def lm(request):
    return (request.param, *_model(request.param))


def test_trees_match_reference(lm):
    """The port's own init and cache have the reference's shapes:
    ``embed`` [CB, V, d] and ``lm_head`` [CB, d, V] with codebooks, a
    tied table (no head) for paligemma."""
    name, rc, tc, rp, tp = lm
    tm, rm = LM(tc, device="cpu"), jax_build(rc)
    shapes = jax.tree.map(lambda a: a.shape, rp)
    if name == "musicgen":
        assert shapes["embed"] == (4, rc.vocab_size, rc.d_model)
        assert shapes["lm_head"] == (4, rc.d_model, rc.vocab_size)
    else:
        assert "lm_head" not in shapes
    own = tm.init(torch.Generator().manual_seed(0))
    for tree in (own, tp):
        assert jax.tree.map(lambda a: a.shape, tree_to_numpy(tree)) == shapes
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        rm.init_cache(3, 16))
    got = tree_map(lambda t: (tuple(t.shape),
                              str(t.dtype).replace("torch.", "")),
                   tm.init_cache(3, 16))
    assert got == want


def test_forward_loss_and_gradients_match_reference(lm):
    """``forward``'s logits ([B, CB, S, V] with codebooks; P + S
    positions with a prefix), ``loss`` under a broadcast ``loss_mask``
    with ``fused_xent`` off and on (each against the reference's own
    form, and the fused one against the plain reference too), and the
    gradient of the loss to every leaf."""
    name, rc, tc, rp, tp = lm
    batch = _inputs(rc, 3, 20, seed=2)
    batch["loss_mask"] = (np.arange(19) % 4 != 0).astype(np.float32)
    rms = {fx: jax_build(rc, fused_xent=fx) for fx in (False, True)}

    @functools.partial(jax.jit, static_argnums=0)
    def ref(fx, p, b):
        return rms[fx].forward(p, b["tokens"], b.get("prefix_emb")), \
            jax.value_and_grad(rms[fx].loss, has_aux=True)(p, b)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {fx: ref(fx, rp, jb) for fx in (False, True)}
    (logits_ref, _), _ = out[False]
    logits, _ = LM(tc, device="cpu").forward(tp, tb["tokens"],
                                             tb.get("prefix_emb"))
    want_shape = ((3, 4, 20, rc.vocab_size) if name == "musicgen"
                  else (3, rc.num_prefix_embeddings + 20, rc.vocab_size))
    assert tuple(logits.shape) == want_shape == logits_ref.shape
    _close(logits, logits_ref, F32_TOL)
    for fx in (False, True):
        _, ((_, m_ref), g_ref) = out[fx]
        metrics, grads = loss_and_grads(
            LM(tc, fused_xent=fx, device="cpu"), tp, tb)
        assert metrics.keys() == m_ref.keys()
        for key in m_ref:
            _close(metrics[key], m_ref[key], F32_TOL)
        _close(metrics["loss"], out[not fx][1][0][1]["loss"], F32_TOL)
        got, want = tree_leaves(tree_to_numpy(grads)), jax.tree.leaves(g_ref)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, GRAD_TOL)


def test_prefill_and_decode_steps_match_reference(lm):
    """A 9-token prefill (after the P prefix embeddings for paligemma)
    into a cache of P + 32, then 15 decode steps (``[B, CB, 1]`` inputs,
    ``[B, CB, 1, V]`` logits with codebooks): logits and the whole cache
    tree after every call; the index counts the prefix."""
    name, rc, tc, rp, tp = lm
    inp = _inputs(rc, 3, 24, seed=5)
    toks, prefix = inp["tokens"], inp.get("prefix_emb")
    n_prefix = 0 if prefix is None else prefix.shape[1]
    rm, tm = jax_build(rc), LM(tc, device="cpu")
    ref_decode = jax.jit(rm.decode_step)
    logits_ref, cache_ref = jax.jit(rm.prefill)(
        rp, jnp.asarray(toks[..., :9]), rm.init_cache(3, n_prefix + 32),
        None if prefix is None else jnp.asarray(prefix))
    logits, cache = tm.prefill(
        tp, torch.from_numpy(toks[..., :9]), tm.init_cache(3, n_prefix + 32),
        None if prefix is None else torch.from_numpy(prefix))
    _tree_close({"logits": logits, "cache": cache},
                {"logits": logits_ref, "cache": cache_ref}, F32_TOL)
    for t in range(9, 24):
        tok = toks[..., t:t + 1]
        logits_ref, cache_ref = ref_decode(rp, jnp.asarray(tok), cache_ref)
        logits, cache = tm.decode_step(tp, torch.from_numpy(tok), cache)
        _tree_close({"logits": logits, "cache": cache},
                    {"logits": logits_ref, "cache": cache_ref}, F32_TOL)
    assert int(cache["index"]) == n_prefix + 24
    if name == "musicgen":
        assert tuple(logits.shape) == (3, 4, 1, rc.vocab_size)


@pytest.mark.parametrize("name", VARIANT_IDS[:2])
def test_engine_greedy_tokens_match_reference_with_mid_flight_admission(
        name):
    """Two slots, three requests (``[CB, S]`` prompts for musicgen, text
    for paligemma, as the reference's engine takes them): the third is
    admitted mid-flight into the slot the first frees; every greedy token
    (codebook 0's) equals the reference engine's."""
    rc, tc, rp, tp = _model(name)
    port = ServingEngine(LM(tc, device="cpu"), tp, n_slots=2, max_len=64)
    ref = JaxEngine(jax_build(rc), rp, n_slots=2, max_len=64)
    rng = np.random.default_rng(6)
    lead = (rc.n_codebooks,) if rc.n_codebooks > 1 else ()
    for uid, (n, new) in enumerate([(8, 3), (8, 9), (6, 5)]):
        prompt = rng.integers(0, rc.vocab_size,
                              size=lead + (n,)).astype(np.int32)
        port.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
        ref.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=new))
    done = []
    for _ in range(4):                 # prefill, 2 decodes, then admission
        done += port.step()
    assert [r.uid for r in done] == [0]
    assert {r.uid for r in port.slot_req if r is not None} == {1, 2}
    done += port.run()
    want = {r.uid: list(r.output) for r in ref.run()}
    assert {r.uid: list(r.output) for r in done} == want
    assert [len(want[u]) for u in range(3)] == [3, 9, 5]


def test_engine_samples_every_codebook_as_the_reference():
    """Hot sampling with codebooks: the reference engine's ``jax.random``
    Gumbel draws (``[slots, CB, V]`` a step) replayed through the RNG
    seam give its tokens, for slots at different temperatures beside a
    greedy one."""
    rc, tc, rp, tp = _model("musicgen")
    n_slots, seed, steps = 3, 7, 64
    key, gumbels = jax.random.key(seed), []
    for _ in range(steps):            # the reference engine's key schedule
        key, sub = jax.random.split(key)
        gumbels.append(np.asarray(jax.random.gumbel(
            sub, (n_slots, rc.n_codebooks, rc.vocab_size), jnp.float32)))
    port = ServingEngine(LM(tc, device="cpu"), tp, n_slots=n_slots,
                         max_len=64, draws=ReplayDraws(
                             gumbel=np.stack(gumbels)))
    ref = JaxEngine(jax_build(rc), rp, n_slots=n_slots, max_len=64,
                    seed=seed)
    rng = np.random.default_rng(4)
    for uid, temp in enumerate((0.7, 0.0, 1.5, 1.0)):
        prompt = rng.integers(0, rc.vocab_size, size=(rc.n_codebooks,
                                                      6 + uid)
                              ).astype(np.int32)
        for eng, req in ((port, Request), (ref, JaxRequest)):
            eng.submit(req(uid=uid, prompt=prompt, max_new_tokens=5,
                           temperature=temp))
    got = {r.uid: list(r.output) for r in port.run()}
    assert got == {r.uid: list(r.output) for r in ref.run()}
    assert len(got) == 4 and all(len(o) == 5 for o in got.values())


def test_step_factories_match_reference():
    """``make_prefill_step`` (the prefix from the batch, ``last_only``)
    and ``make_decode_step`` against the reference's."""
    rc, tc, rp, tp = _model("paligemma")
    inp = _inputs(rc, 2, 10, seed=8)
    tb = {k: torch.from_numpy(v) for k, v in inp.items()}
    jb = jax.tree.map(jnp.asarray, inp)
    rm, tm = jax_build(rc), LM(tc, device="cpu")
    for last in (False, True):
        _close(make_prefill_step(tm, last)(tp, tb),
               jax_state.make_prefill_step(rm, last)(rp, jb), F32_TOL)
    tok = inp["tokens"][:, :1]
    got = make_decode_step(tm)(tp, torch.from_numpy(tok),
                               tm.init_cache(2, 8))
    want = jax_state.make_decode_step(rm)(rp, jnp.asarray(tok),
                                          rm.init_cache(2, 8))
    _tree_close(got, want, F32_TOL)


@pytest.mark.parametrize("name", VARIANT_IDS[:2])
def test_embed_at_bf16_within_the_bf16_bound(name):
    """The codebook sum (4 bf16 rows) and the prefix concatenation at
    bf16: torch and XLA may round the sum differently, within 2e-2."""
    rc, tc, rp, tp = _model(name)
    rc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (rc, tc))
    inp = _inputs(rc, 2, 12, seed=9)
    want = jax_build(rc).embed(rp, jnp.asarray(inp["tokens"]),
                               None if "prefix_emb" not in inp
                               else jnp.asarray(inp["prefix_emb"]))
    got = LM(tc, device="cpu").embed(
        tp, torch.from_numpy(inp["tokens"]),
        None if "prefix_emb" not in inp
        else torch.from_numpy(inp["prefix_emb"]))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_data_shapes_and_dtypes(arch):
    """``SyntheticLMData.for_model``: int32 tokens [B, CB, S] in the
    vocabulary for musicgen; [B, S] and f32 ``prefix_emb`` [B, P, d] of
    std ~0.02 for paligemma; pure in (edge, step), the prefix its own
    stream."""
    cfg = port_config.get_smoke_config(arch).model
    data = SyntheticLMData.for_model(cfg, 3, 16, seed=4)
    b = data.batch(1, 2, device="cpu")
    again = data.batch(1, 2, device="cpu")
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].min()) >= 0 and \
        int(b["tokens"].max()) < cfg.vocab_size
    assert torch.equal(b["tokens"], again["tokens"])
    if arch == "musicgen-medium":
        assert tuple(b["tokens"].shape) == (3, 4, 16)
        assert "prefix_emb" not in b
    else:
        assert tuple(b["tokens"].shape) == (3, 16)
        p = b["prefix_emb"]
        assert p.dtype == torch.float32 and \
            tuple(p.shape) == (3, cfg.num_prefix_embeddings, cfg.d_model)
        assert torch.equal(p, again["prefix_emb"])
        assert 0.015 < float(p.std()) < 0.025
        assert not torch.equal(p, data.batch(1, 3, device="cpu")
                               ["prefix_emb"])
    # the one-codebook, prefix-less stream is the one it always was
    plain = SyntheticLMData(vocab=cfg.vocab_size, seq_len=16, batch_size=3,
                            seed=4).batch(1, 2, device="cpu")
    assert set(plain) == {"tokens"} and tuple(plain["tokens"].shape) == (3,
                                                                         16)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--tokens", "3"])
    assert out["tokens"].shape == (2, 4)


@pytest.mark.parametrize("arch,n", [("musicgen-medium", 1_827_816_960),
                                    ("paligemma-3b", 2_508_662_784)])
def test_full_config_parameter_count(arch, n):
    """The analytic count is the reference's: it counts one embedding
    table, so musicgen's tree holds (CB - 1) V d more (in both packages);
    the smoke trees hold as many elements as the reference's init."""
    full = port_config.get_config(arch).model
    assert full.num_params() == n == \
        jax_config.get_config(arch).model.num_params()
    rc, tc = _cfgs(arch)
    want = sum(a.size for a in jax.tree.leaves(
        jax.eval_shape(jax_build(rc).init, jax.random.key(0))))
    got = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(got)) == want
    assert want == tc.num_params() + (tc.n_codebooks - 1) * \
        tc.vocab_size * tc.d_model
