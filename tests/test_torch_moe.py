"""The port's MoE FFN and the MoE LM family vs the reference, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` at the widths of
``tests/test_moe.py`` (f32, the reference's own init carried across as
numpy): both dispatch modes, grouped dispatch, shared experts and a tight
capacity that drops assignments, each with identical expert choices,
y within 1e-5, every aux value within 1e-6 and gradients to x and every
weight within 1e-4; the dropless decode rule, a constructed top-k tie.
Then olmoe-1b-7b and deepseek-moe-16b at smoke width (2 layers: no
unstacked prefix) and a 4-layer deepseek-moe (its dense first layer is
the reference's ``prefix_layers``): ``forward`` with its aux, ``loss``
with its router terms and the gradient tree; on the 4-layer model
``prefill`` + 15 ``decode_step``s (logits and caches at 1e-5) and the
serving engine's greedy tokens against the reference engine's, with
mid-flight admission; ``launch/serve.main(--smoke)`` for both ids.

The aux values of a whole LM are sums over layers (``expert_frac_max``
too, as in the reference), so they are held to 1e-6 absolute plus 1e-6
relative.
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_leaves, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train.state import loss_and_grads  # noqa: E402

Y_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops on a CPU that other test processes load: torch's OpenMP
    pool spin-waits between them (this module's launcher tests took 10-18
    s each under the suite's 6 workers, 0.1 s alone).  One intra-op
    thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_cfgs(e=4, k=2, d=32, f=16, shared=0, cf=1.25, **moe_kw):
    """``tests/test_moe.py``'s ``make_cfg`` in both packages."""
    def make(pkg):
        return pkg.ModelConfig(
            d_model=d, moe=pkg.MoEConfig(
                num_experts=e, top_k=k, expert_ffn_dim=f,
                num_shared_experts=shared, shared_ffn_dim=f * max(shared, 1),
                capacity_factor=cf, **moe_kw),
            dtype="float32")
    return make(jax_config), make(port_config)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, rtol=None):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                               rtol=tol if rtol is None else rtol)


def _ref_expert_idx(p, x, k):
    """The reference's routing lines (``_moe_ffn_flat``) on x [B, S, d]."""
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ p["router"].astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


# (case id, make_cfg overrides, x shape): both dispatch modes, grouped
# dispatch, shared experts; then T*k > 4096 at a quarter of the capacity,
# where assignments drop, in both modes and in groups
MOE_CASES = [
    ("cumsum", {}, (4, 16, 32)),
    ("sort", {"dispatch": "sort"}, (4, 16, 32)),
    ("groups2", {"dispatch_groups": 2}, (4, 16, 32)),
    ("shared", {"shared": 2}, (2, 8, 32)),
    ("tight-cumsum", {"cf": 0.25}, (4, 1100, 32)),
    ("tight-sort", {"cf": 0.25, "dispatch": "sort"}, (4, 1100, 32)),
    ("tight-groups2", {"cf": 0.25, "dispatch_groups": 2, "shared": 1},
     (4, 2100, 32)),
]


@pytest.mark.parametrize("case,kw,shape", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_matches_reference(case, kw, shape):
    rc, tc = _moe_cfgs(**kw)
    rp = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(0), rc))
    tp = tree_from_numpy(rp, "cpu")
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    w_aux = {"load_balance_loss": 0.3, "router_z_loss": 0.7}

    # expert choices
    want_idx = _ref_expert_idx(rp, x, rc.moe.top_k)
    got_idx = port_moe.route(tp["router"],
                             torch.from_numpy(x).reshape(-1, shape[-1]),
                             tc.moe.top_k)[3]
    assert np.array_equal(got_idx.numpy(), want_idx)
    if case.startswith("tight"):        # the capacity does drop
        per_expert = np.bincount(want_idx.ravel(), minlength=4)
        groups = max(kw.get("dispatch_groups", 1), 1)
        cap = jax_moe.capacity(x.shape[0] * x.shape[1] // groups, rc)
        assert per_expert.max() // groups > cap

    # values, and gradients of <y, ct> + the weighted aux to x and every
    # weight the FFN reads (the pre-norm scale is the block's)
    names = sorted(k for k in tp if k != "norm")

    @jax.jit
    def ref(p, xx):
        def f(p, xx):
            yy, a = jax_moe.moe_ffn(p, rc, xx)
            obj = jnp.sum(yy * ct) + sum(w * a[k] for k, w in w_aux.items())
            return obj, (yy, a)
        return jax.grad(f, argnums=(0, 1), has_aux=True)(p, xx)
    (gp_ref, gx_ref), (y_ref, aux_ref) = ref(
        {n: jnp.asarray(rp[n]) for n in names}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {n: tp[n].clone().requires_grad_() for n in names}
    y, aux = port_moe.moe_ffn(leaves, tc, xt)
    _close(y, y_ref, Y_TOL)
    assert aux.keys() == aux_ref.keys()
    for key in aux_ref:
        _close(aux[key], aux_ref[key], AUX_TOL)
    obj = (y * torch.from_numpy(ct)).sum() + sum(
        w * aux[k] for k, w in w_aux.items())
    grads = torch.autograd.grad(obj, [xt] + [leaves[n] for n in names])
    _close(grads[0], gx_ref, GRAD_TOL)
    for n, g in zip(names, grads[1:]):
        _close(g, gp_ref[n], GRAD_TOL)


@pytest.mark.parametrize("t,e,k,cf", [(1, 64, 8, 1.25), (4, 64, 6, 1.25),
                                      (512, 64, 8, 1.25), (513, 64, 8, 1.25),
                                      (2048, 64, 8, 1.25), (3000, 4, 2, 0.25),
                                      (7, 4, 2, 8.0)])
def test_capacity_matches_reference(t, e, k, cf):
    """The Python arithmetic as written, the dropless rule at T*k <= 4096
    (512 tokens of top-8) included."""
    rc, tc = _moe_cfgs(e=e, k=k, cf=cf)
    assert port_moe.capacity(t, tc) == jax_moe.capacity(t, rc)


def test_single_token_decode_equals_its_slice_of_the_full_pass():
    """The reference's ``test_decode_dropless_consistency``: a one-token
    dispatch is dropless and equals the token's row of the full pass."""
    rc, tc = _moe_cfgs()
    tp = tree_from_numpy(jax.tree.map(
        np.asarray, jax_moe.init_moe(jax.random.key(0), rc)), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, 32)).astype(np.float32))
    y_full, _ = port_moe.moe_ffn(tp, tc, x)
    for t in (0, 7, 15):
        y_t, _ = port_moe.moe_ffn(tp, tc, x[:, t:t + 1])
        _close(y_t[:, 0], y_full[:, t], Y_TOL)


def test_top_k_tie_resolves_to_the_lower_expert_index():
    """Experts 1 and 3 get the same router column, so every token's
    probabilities tie between them: top-1 picks expert 1 and top-2 puts 1
    before 3 when both lead, as ``lax.top_k`` does."""
    rng = np.random.default_rng(5)
    router = rng.standard_normal((32, 4)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, [0, 2]] -= 4.0 * np.abs(router[:, [0, 2]])
    x = np.abs(rng.standard_normal((1, 6, 32))).astype(np.float32)
    for k in (1, 2):
        got = port_moe.route(torch.from_numpy(router),
                             torch.from_numpy(x[0]), k)[3].numpy()
        want = np.asarray(jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(x[0]) @ router, axis=-1), k)[1])
        assert np.array_equal(got, want)
        assert (got[:, 0] == 1).all()
    assert (got[:, 1] == 3).all()


# -- the MoE LMs --------------------------------------------------------------


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_config.get_smoke_config(arch).model,
                                dtype="float32", **kw),
            dataclasses.replace(port_config.get_smoke_config(arch).model,
                                dtype="float32", **kw))


def _randomise(tree, seed):
    """numpy tree with the norm scales (zero at init) drawn non-zero."""
    rng = np.random.default_rng(seed)

    def visit(path, a):
        if getattr(path[-1], "key", None) in ("norm", "q_norm", "k_norm"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(visit, tree)


# (id, arch, overrides): the two smoke configs (2 layers; deepseek-moe's
# dense first layer lands in a 2-layer group, no prefix) and deepseek-moe
# at 4 layers, where layer_groups makes the dense layer a prefix
VARIANTS = [("olmoe", "olmoe-1b-7b", {}),
            ("deepseek-moe", "deepseek-moe-16b", {}),
            ("deepseek-moe-4l", "deepseek-moe-16b", {"n_layers": 4})]


@functools.lru_cache(maxsize=None)
def _model(name):
    """(ref cfg, port cfg, ref params, port params) of a variant: the
    reference's init (its norm scales drawn non-zero), carried across."""
    _, arch, kw = next(v for v in VARIANTS if v[0] == name)
    rc, tc = _cfgs(arch, **kw)
    rp = jax.tree.map(jnp.asarray, _randomise(
        jax.jit(jax_build(rc).init)(jax.random.key(0)), seed=1))
    return rc, tc, rp, tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


@pytest.fixture(scope="module", params=[v[0] for v in VARIANTS])
def lm(request):
    """(id, ref cfg, port cfg, ref params, port params, tokens)."""
    model = _model(request.param)
    toks = np.random.default_rng(2).integers(0, model[0].vocab_size,
                                             (3, 24)).astype(np.int32)
    return (request.param, *model, toks)


def test_trees_match_reference(lm):
    """The port's own init and cache have the reference's structure and
    shapes (``prefix_layers`` a list, where the split has one), and the
    reference's tree carried across keeps it."""
    name, rc, tc, rp, tp, _ = lm
    tm, rm = LM(tc, device="cpu"), jax_build(rc)
    assert ("prefix_layers" in rp) == (name == "deepseek-moe-4l")
    assert tm.prefix == rm.prefix and tm.group == rm.group
    shapes = jax.tree.map(lambda a: a.shape, rp)
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
    """``forward``'s logits and aux (summed over layers, expert_frac_max
    included), ``loss`` with its router terms (loss != ce_loss), and the
    gradient of the loss to every leaf."""
    _, rc, tc, rp, tp, toks = lm
    rm, tm = jax_build(rc), LM(tc, device="cpu")
    mask = (np.arange(23)[None, :] % 5 != 0).astype(np.float32) \
        * np.ones((3, 1), np.float32)
    batch = {"tokens": toks, "loss_mask": mask}

    @jax.jit
    def ref(p, b):                   # one compile for both
        return rm.forward(p, b["tokens"]), jax.value_and_grad(
            rm.loss, has_aux=True)(p, b)
    (logits_ref, aux_ref), ((_, m_ref), g_ref) = ref(
        rp, jax.tree.map(jnp.asarray, batch))
    logits, aux = tm.forward(tp, torch.from_numpy(toks))
    _close(logits, logits_ref, Y_TOL)
    assert aux.keys() == aux_ref.keys()
    for key in aux_ref:
        _close(aux[key], aux_ref[key], AUX_TOL, AUX_TOL)
    assert float(aux["n_moe"]) == sum(f == "moe" for f in rc.ffn_kinds())

    metrics, grads = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics.keys() == m_ref.keys()
    for key in m_ref:
        _close(metrics[key], m_ref[key], Y_TOL)
    assert abs(float(metrics["loss"]) - float(metrics["ce_loss"])) > 1e-4
    got, want = tree_leaves(tree_to_numpy(grads)), jax.tree.leaves(g_ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


DEEP = "deepseek-moe-4l"            # the one variant with a prefix layer


def _tree_close(got, want, tol):
    got = tree_map(lambda a: np.asarray(a, np.float32), tree_to_numpy(got))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def test_prefill_and_decode_steps_match_reference():
    """A 9-token prefill into a cache of 32, then 15 decode steps (each a
    dropless 3-token MoE dispatch): logits and the whole cache tree (the
    prefix layer's K/V, the stacked groups', the index) after every
    call."""
    rc, tc, rp, tp = _model(DEEP)
    toks = np.random.default_rng(5).integers(0, rc.vocab_size,
                                             (3, 24)).astype(np.int32)
    rm, tm = jax_build(rc), LM(tc, device="cpu")
    ref_decode = jax.jit(rm.decode_step)
    logits_ref, cache_ref = jax.jit(rm.prefill)(
        rp, jnp.asarray(toks[:, :9]), rm.init_cache(3, 32))
    logits, cache = tm.prefill(tp, torch.from_numpy(toks[:, :9]),
                               tm.init_cache(3, 32))
    assert len(cache["prefix_layers"]) == 1
    _tree_close({"logits": logits, "cache": cache},
                {"logits": logits_ref, "cache": cache_ref}, Y_TOL)
    for t in range(9, 24):
        tok = toks[:, t:t + 1]
        logits_ref, cache_ref = ref_decode(rp, jnp.asarray(tok), cache_ref)
        logits, cache = tm.decode_step(tp, torch.from_numpy(tok), cache)
        _tree_close({"logits": logits, "cache": cache},
                    {"logits": logits_ref, "cache": cache_ref}, Y_TOL)
    assert int(cache["index"]) == 24


def test_engine_greedy_tokens_match_reference_with_mid_flight_admission():
    """Two slots, three requests: the third is admitted mid-flight into
    the slot the first frees, so its prefix-layer cache rows (axis 0) and
    the groups' (axis 1) are scattered into the live cache; every greedy
    token equals the reference engine's."""
    rc, tc, rp, tp = _model(DEEP)
    port = ServingEngine(LM(tc, device="cpu"), tp, n_slots=2, max_len=64)
    ref = JaxEngine(jax_build(rc), rp, n_slots=2, max_len=64)
    rng = np.random.default_rng(6)
    for uid, (n, new) in enumerate([(8, 3), (8, 9), (6, 5)]):
        prompt = rng.integers(0, rc.vocab_size, size=n).astype(np.int32)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--tokens", "3"])
    assert out["tokens"].shape == (2, 4)


@pytest.mark.parametrize("arch,n", [("olmoe-1b-7b", 6_919_096_320),
                                    ("deepseek-moe-16b", 16_317_138_944)])
def test_full_config_parameter_count(arch, n):
    """The analytic count is the reference's; the smoke trees hold as many
    elements as the reference's init (olmoe's per-head q/k norm scales
    included: ``num_params()`` leaves them out, in both packages)."""
    cfg = port_config.get_config(arch).model
    assert cfg.num_params() == n == \
        jax_config.get_config(arch).model.num_params()
    rc, tc = _cfgs(arch)
    want = sum(a.size for a in jax.tree.leaves(
        jax.eval_shape(jax_build(rc).init, jax.random.key(0))))
    got = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(got)) == want
    extra = 2 * tc.resolved_head_dim * tc.n_layers if tc.qk_norm else 0
    assert want == tc.num_params() + extra
