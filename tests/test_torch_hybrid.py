"""jamba-1.5's hybrid attention/SSM/MoE stack and unstacked
(``scan_layers=False``) trees vs the reference, on the CPU.

Three models, each from the reference's own init (its norm scales drawn
non-zero) carried across as numpy, at f32:

  * ``smoke``: jamba-1.5-large-398b's smoke config, one group of
    ``(MAMBA, DENSE_FFN), (ATTN, MOE_FFN)``;
  * ``full2g``: two groups of the full config's 8-layer pattern
    ``(MAMBA, DENSE), (MAMBA, MOE)`` x 2, ``(ATTN, DENSE), (MAMBA, MOE)``,
    ``(MAMBA, DENSE), (MAMBA, MOE)`` at narrow widths (16 layers: every
    block kind of the full model, the attention sub at position 4);
  * ``unstacked``: the smoke config at 4 layers with
    ``scan_layers=False``, two groups whose ``groups`` is a list of
    per-group trees in both packages.

Held: logits and loss within 1e-5, every gradient within 1e-4, the MoE
aux values (sums over layers, ``n_moe`` and ``expert_frac_max``
included) within 1e-6; ``prefill`` and 15 ``decode_step``s, logits and
the whole cache tree, within 1e-5; the engine's greedy tokens equal to
the reference engine's with a mid-flight admission into a freed slot;
checkpoints across the packages bit for bit.  The 1e-5 tiers hold each
element (absolute plus relative) on the 2- and 4-layer models, and on
the 16-layer ``full2g`` each tensor's largest difference against its
largest magnitude: every block there is within a few f32 ulps of its
update's magnitude of the reference's, each kind alike, and 16 such
blocks put single logits of magnitude ~0.1 up to 1.2e-5 apart (as this
test's element-wise form measured), past an element-wise 1e-5.  Then
what the port adds: within a stacked group the attention sub's K/V is
written in place and kept while the SSM subs' state is new; ``remat``
checkpoints each mixed group once; an admitted slot keeps nothing of its
previous request's SSM state; the launchers; the full config's
parameter count.
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
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_leaves, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import transformer as port_transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train import checkpoint as port_ckpt  # noqa: E402
from repro_torch.train.state import loss_and_grads  # noqa: E402

ARCH = "jamba-1.5-large-398b"
Y_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small ops (torch's OpenMP
    pool spin-waits between them under the suite's workers), restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _full_pattern(pkg):
    full = pkg.get_config(ARCH).model
    return {"layer_pattern": full.layer_pattern,
            "ffn_pattern": full.ffn_pattern}


# (id, overrides of the smoke config) for both packages' configs; the
# 2-group models at d_model 64 (4 heads of 16, Mamba-2 d_inner 128 in 4
# heads of 32, d_state 16) keep the suite's CPU time small
VARIANTS = [("smoke", {}),
            ("full2g", {"n_layers": 16, "d_model": 64, "d_ff": 128,
                        "vocab_size": 128}),
            ("unstacked", {"n_layers": 4, "scan_layers": False})]
IDS = [v[0] for v in VARIANTS]
DEEP = "full2g"              # held to 1e-5 of each tensor's magnitude


def _cfg(pkg, name):
    kw = dict(next(v[1] for v in VARIANTS if v[0] == name))
    base = pkg.get_smoke_config(ARCH).model
    if name == DEEP:
        kw.update(_full_pattern(pkg), moe=dataclasses.replace(
            base.moe, expert_ffn_dim=64))
    return dataclasses.replace(base, dtype="float32", **kw)


def _randomise(tree, seed):
    """numpy tree with the norm scales (zero at init) drawn non-zero."""
    rng = np.random.default_rng(seed)

    def visit(path, a):
        if getattr(path[-1], "key", None) in ("norm", "q_norm", "k_norm"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(visit, tree)


@functools.lru_cache(maxsize=None)
def _model(name):
    """(ref cfg, port cfg, ref params, port params) of a variant."""
    rc, tc = _cfg(jax_config, name), _cfg(port_config, name)
    rp = jax.tree.map(jnp.asarray, _randomise(
        jax.jit(jax_build(rc).init)(jax.random.key(0)), seed=1))
    return rc, tc, rp, tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


@pytest.fixture(scope="module", params=IDS)
def lm(request):
    """(id, ref cfg, port cfg, ref params, port params, tokens)."""
    model = _model(request.param)
    toks = np.random.default_rng(2).integers(0, model[0].vocab_size,
                                             (3, 24)).astype(np.int32)
    return (request.param, *model, toks)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, rtol=None, scaled=False):
    """Element-wise within ``tol`` (absolute plus relative), or with
    ``scaled`` the largest difference within ``tol`` of the largest
    magnitude."""
    got, want = _f32(got), _f32(want)
    if scaled:
        assert got.shape == want.shape
        err = float(np.abs(got - want).max(initial=0.0))
        assert err <= tol * float(np.abs(want).max(initial=0.0)), err
    else:
        np.testing.assert_allclose(got, want, atol=tol,
                                   rtol=tol if rtol is None else rtol)


def _tree_close(got, want, tol, scaled=False):
    got = tree_map(lambda a: np.asarray(a, np.float32), tree_to_numpy(got))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w, tol, scaled=scaled)


def test_configs_hold_every_block_kind():
    """The full config's group is 8 layers with the attention sub at
    position 4, a dense FFN there; its smoke config pairs attention with
    MoE; the 2-group variants repeat the full group twice."""
    full = port_config.get_config(ARCH).model
    tm = LM(full, device="cpu")          # builds no tree
    assert tm.prefix == () and tm.n_groups == 9
    assert tm.group == (("mamba", "dense"), ("mamba", "moe")) * 2 + (
        ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"))
    assert LM(_cfg(port_config, "smoke"), device="cpu").group == (
        ("mamba", "dense"), ("attn", "moe"))
    m = LM(_cfg(port_config, DEEP), device="cpu")
    assert m.group == tm.group and m.n_groups == 2
    m = LM(_cfg(port_config, "unstacked"), device="cpu")
    assert m.group == (("mamba", "dense"), ("attn", "moe"))
    assert m.n_groups == 2 and not m.cfg.scan_layers


def test_trees_match_reference(lm):
    """The port's own init and cache have the reference's structure,
    shapes and dtypes (``groups`` stacked, or a list of group trees), and
    the reference's tree carried across keeps them."""
    name, rc, tc, rp, tp, _ = lm
    tm, rm = LM(tc, device="cpu"), jax_build(rc)
    assert tm.prefix == rm.prefix and tm.group == rm.group
    assert isinstance(rp["groups"], list) == (name == "unstacked")
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
    """``forward``'s logits and aux (the reference's tree add over mixed
    groups: ``n_moe`` counts the MoE layers, ``expert_frac_max`` is a sum
    of per-layer maxima), ``loss`` with its router terms, and the
    gradient of the loss to every leaf (unstacked trees: one list entry
    a group)."""
    name, rc, tc, rp, tp, toks = lm
    scaled = name == DEEP
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
    _close(logits, logits_ref, Y_TOL, scaled=scaled)
    assert aux.keys() == aux_ref.keys()
    for key in aux_ref:
        _close(aux[key], aux_ref[key], AUX_TOL, AUX_TOL)
    assert float(aux["n_moe"]) == sum(f == "moe" for f in rc.ffn_kinds())

    metrics, grads = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics.keys() == m_ref.keys()
    for key in m_ref:
        _close(metrics[key], m_ref[key], Y_TOL, scaled=scaled)
    assert abs(float(metrics["loss"]) - float(metrics["ce_loss"])) > 1e-5
    assert jax.tree.structure(tree_to_numpy(grads)) == \
        jax.tree.structure(jax.tree.map(np.asarray, g_ref))
    got, want = tree_leaves(tree_to_numpy(grads)), jax.tree.leaves(g_ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


def test_prefill_and_decode_steps_match_reference(lm):
    """A 9-token prefill into a cache of 32, then 15 decode steps: the
    logits and the whole cache tree (every group's K/V and SSM and conv
    state, the index) after every call."""
    name, rc, tc, rp, tp, toks = lm
    scaled = name == DEEP
    rm, tm = jax_build(rc), LM(tc, device="cpu")
    ref_decode = jax.jit(rm.decode_step)
    logits_ref, cache_ref = jax.jit(rm.prefill)(
        rp, jnp.asarray(toks[:, :9]), rm.init_cache(3, 32))
    logits, cache = tm.prefill(tp, torch.from_numpy(toks[:, :9]),
                               tm.init_cache(3, 32))
    _tree_close({"logits": logits, "cache": cache},
                {"logits": logits_ref, "cache": cache_ref}, Y_TOL,
                scaled)
    for t in range(9, 24):
        tok = toks[:, t:t + 1]
        logits_ref, cache_ref = ref_decode(rp, jnp.asarray(tok), cache_ref)
        logits, cache = tm.decode_step(tp, torch.from_numpy(tok), cache)
        _tree_close({"logits": logits, "cache": cache},
                    {"logits": logits_ref, "cache": cache_ref}, Y_TOL,
                    scaled)
    assert int(cache["index"]) == 24


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _drive(engine, prompts, news):
    """Submit the requests, step until the first one finishes and the
    third is admitted mid-flight into its slot, then run to the end."""
    for uid, (prompt, new) in enumerate(zip(prompts, news)):
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    done = []
    for _ in range(4):                 # prefill, 2 decodes, then admission
        done += engine.step()
    assert [r.uid for r in done] == [0]
    assert {r.uid for r in engine.slot_req if r is not None} == {1, 2}
    return {r.uid: list(r.output) for r in done + engine.run()}


def test_engine_greedy_tokens_match_reference_with_mid_flight_admission():
    """Two slots, three requests: the third is admitted mid-flight into
    the slot the first frees, so its rows of every K/V and SSM leaf are
    scattered into the live cache; every greedy token equals the
    reference engine's."""
    rc, tc, rp, tp = _model("smoke")
    prompts, news = _prompts(rc.vocab_size, (8, 8, 6), 6), (3, 9, 5)
    got = _drive(ServingEngine(LM(tc, device="cpu"), tp, n_slots=2,
                               max_len=64), prompts, news)
    ref = JaxEngine(jax_build(rc), rp, n_slots=2, max_len=64)
    for uid, (prompt, new) in enumerate(zip(prompts, news)):
        ref.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=new))
    want = {r.uid: list(r.output) for r in ref.run()}
    assert got == want and [len(want[u]) for u in range(3)] == [3, 9, 5]


def test_unstacked_engine_scatters_list_groups_as_the_stacked_one():
    """The same two groups as a list (``scan_layers=False``: the
    admitted rows scattered along axis 0 of each group's leaves) and
    stacked (axis 1): the same greedy tokens, admission included."""
    _, tc, _, tp = _model("unstacked")
    stacked = dict(tp, groups=port_transformer._stack(tp["groups"]))
    prompts, news = _prompts(tc.vocab_size, (8, 8, 6), 6), (3, 9, 5)
    got = _drive(ServingEngine(LM(tc, device="cpu"), tp, n_slots=2,
                               max_len=64), prompts, news)
    want = _drive(ServingEngine(LM(dataclasses.replace(
        tc, scan_layers=True), device="cpu"), stacked, n_slots=2,
        max_len=64), prompts, news)
    assert got == want and [len(want[u]) for u in range(3)] == [3, 9, 5]


def test_mid_flight_admission_resets_the_slots_ssm_state():
    """Slot 0 first serves request A, then a request admitted mid-flight.
    Run twice with different A prompts (same lengths, so the same
    schedule): after the admission slot 0's SSM and conv state, and the
    admitted request's tokens, are bit for bit the same, so nothing of A
    was carried over."""
    rc, tc, _, tp = _model("smoke")
    other, admitted = _prompts(rc.vocab_size, (8, 6), 7)
    states, outputs = [], []
    for seed in (8, 9):
        (first,) = _prompts(rc.vocab_size, (8,), seed)
        eng = ServingEngine(LM(tc, device="cpu"), tp, n_slots=2, max_len=32)
        for uid, (prompt, new) in enumerate(
                [(first, 2), (other, 8), (admitted, 4)]):
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
        for _ in range(3):             # prefill, a decode, the admission
            eng.step()
        assert [r.uid if r else None for r in eng.slot_req] == [2, 1]
        states.append(tree_map(lambda t: t[:, 0].clone(),
                               eng.cache["groups"]["sub0"]))
        outputs.append({r.uid: r.output for r in eng.run()})
    assert set(states[0]) == {"ssm", "conv"}
    for key in states[0]:
        assert torch.equal(states[0][key], states[1][key]), key
    assert outputs[0][2] == outputs[1][2] and len(outputs[0][2]) == 4


def test_stacked_group_keeps_kv_in_place_and_restacks_ssm_state():
    """In a stacked 2-group cache, ``prefill`` and ``decode_step`` return
    the attention sub's K and V as the very tensors given (written in
    place, no copy), and every SSM sub's state as new tensors."""
    _, tc, _, tp = _model(DEEP)
    toks = np.random.default_rng(3).integers(0, 128, (2, 10)).astype(
        np.int32)
    tm = LM(tc, device="cpu")
    attn = [f"sub{i}" for i, (k, _) in enumerate(tm.group) if k == "attn"]
    ssm = [f"sub{i}" for i, (k, _) in enumerate(tm.group) if k == "mamba"]
    assert attn == ["sub4"] and len(ssm) == 7
    cache = tm.init_cache(2, 16)
    for step in range(2):
        given = cache["groups"]
        if step == 0:
            _, cache = tm.prefill(tp, torch.from_numpy(toks[:, :9]), cache)
        else:
            _, cache = tm.decode_step(tp, torch.from_numpy(toks[:, 9:]),
                                      cache)
        for sub in attn:
            for leaf in ("k", "v"):
                assert cache["groups"][sub][leaf] is given[sub][leaf]
        assert float(cache["groups"]["sub4"]["k"].abs().sum()) > 0
        for sub in ssm:
            for leaf in ("ssm", "conv"):
                new, old = cache["groups"][sub][leaf], given[sub][leaf]
                assert new is not old
                assert new.data_ptr() != old.data_ptr()
                assert new.shape == old.shape


def test_remat_checkpoints_each_mixed_group_once(monkeypatch):
    """``cfg.remat`` wraps each group, mixers and FFNs of every kind,
    in one checkpoint, as ``jax.checkpoint`` does: the loss and gradients
    are the un-rematerialised ones, bit for bit."""
    _, tc, _, tp = _model(DEEP)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (2, 12)).astype(np.int32))
    calls = []
    real = port_transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(port_transformer, "checkpoint", counting)
    out = {}
    for remat in (False, True):
        tm = LM(dataclasses.replace(tc, remat=remat), device="cpu")
        out[remat] = loss_and_grads(tm, tp, {"tokens": toks})
    assert len(calls) == 2
    assert torch.equal(out[True][0]["loss"], out[False][0]["loss"])
    for g, w in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["smoke", "unstacked"])
def test_checkpoints_cross_the_packages_bit_for_bit(name, tmp_path):
    """The port's parameters saved and restored by the reference (paths
    ``groups/0/sub0/...`` for an unstacked tree), and the reference's by
    the port: every leaf bit for bit, the key sets equal."""
    rc, tc, rp, tp = _model(name)
    port_ckpt.save(str(tmp_path / "port.npz"), tp, step=3)
    jax_ckpt.save(str(tmp_path / "ref.npz"), rp, step=3)
    keys = {p: set(np.load(tmp_path / f"{p}.npz").files)
            for p in ("port", "ref")}
    assert keys["port"] == keys["ref"]
    if name == "unstacked":
        assert "groups/1/sub1/mix/wq" in keys["port"]
    got_ref = jax_ckpt.restore(str(tmp_path / "port.npz"),
                               jax.tree.map(jnp.zeros_like, rp))
    got_port = port_ckpt.restore(str(tmp_path / "ref.npz"),
                                 tree_map(torch.zeros_like, tp))
    for g, w in zip(jax.tree.leaves(got_ref), tree_leaves(tp)):
        assert np.array_equal(np.asarray(g), w.numpy())
    for g, w in zip(tree_leaves(got_port), jax.tree.leaves(rp)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_launchers_serve_and_train_jamba_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--tokens", "3"])
    assert out["tokens"].shape == (2, 4)
    args = port_train.parse_args(["--arch", ARCH, "--smoke", "--device",
                                  "cpu", "--steps", "2", "--batch", "2",
                                  "--seq", "16"])
    res = port_train.train_standard(port_config.get_smoke_config(ARCH),
                                    args)
    assert len(res["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])


def test_full_config_parameter_count():
    """The analytic count is the reference's, 397,645,830,912, counted
    from the config alone; the smoke and 2-group trees hold as many
    elements as the reference's init (the Mamba-2 layers' dt_bias and
    conv bias beyond ``num_params()``, in both packages)."""
    cfg = port_config.get_config(ARCH).model
    assert cfg.num_params() == 397_645_830_912 == \
        jax_config.get_config(ARCH).model.num_params()
    for name in ("smoke", DEEP):
        rc, tc = _cfg(jax_config, name), _cfg(port_config, name)
        want = sum(a.size for a in jax.tree.leaves(
            jax.eval_shape(jax_build(rc).init, jax.random.key(0))))
        got = LM(tc, device="cpu").init(torch.Generator().manual_seed(0))
        assert sum(t.numel() for t in tree_leaves(got)) == want
        mc = tc.mamba
        n_ssm = sum(k == "mamba" for k in tc.layer_kinds())
        assert want == tc.num_params() + n_ssm * (
            mc.n_heads(tc.d_model) + 2 * mc.d_state)
