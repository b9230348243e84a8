"""The port's serving engine vs the reference's (``tests/test_serving.py``
mirrored), on mamba2-370m's smoke config (the SSM cache) and qwen3-1.7b's
(the KV cache), every engine test a case of each.

For exact tokens both engines run at f32 on the same parameters (the
reference's ``LM.init``, carried with ``tree_from_numpy``): every greedy
request must produce the reference engine's tokens, token for token, and
so must sampled requests when the port's engine replays the reference
engine's Gumbel draws through the RNG seam.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, restored after: its runs are
    many small ops, and beside the other test workers torch's OpenMP pool
    spin-waits between them (the same loaded test ran 4x faster so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["mamba2-370m", "qwen3-1.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    rc = dataclasses.replace(jax_smoke(request.param).model, dtype="float32")
    tc = dataclasses.replace(get_smoke_config(request.param).model,
                             dtype="float32")
    rm = jax_build(rc)
    rp = rm.init(jax.random.key(0))
    tm = build_model(tc, device="cpu")
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rm, rp, tm, tp


def _engines(models, n_slots, max_len=96):
    rm, rp, tm, tp = models
    return (ServingEngine(tm, tp, n_slots=n_slots, max_len=max_len),
            JaxEngine(rm, rp, n_slots=n_slots, max_len=max_len))


def _submit(engines, uid, prompt, **kw):
    port, ref = engines
    port.submit(Request(uid=uid, prompt=prompt, **kw))
    ref.submit(JaxRequest(uid=uid, prompt=prompt, **kw))


def _outputs(done):
    return {r.uid: list(r.output) for r in done}


def _run_both(engines):
    port, ref = engines
    out, want = _outputs(port.run()), _outputs(ref.run())
    assert out == want
    return out


def test_engine_completes_all_requests(models):
    engines = _engines(models, n_slots=3)
    vocab = engines[0].cfg.vocab_size
    rng = np.random.default_rng(0)
    for uid in range(5):                     # 5 requests > 3 slots: 2 waves
        _submit(engines, uid, rng.integers(
            0, vocab, size=int(rng.integers(4, 12))).astype(np.int32),
            max_new_tokens=5)
    out = _run_both(engines)
    assert len(out) == 5 and all(len(o) == 5 for o in out.values())
    assert all(0 <= t < vocab for o in out.values() for t in o)


def test_engine_eos_terminates_early(models):
    engines = _engines(models, n_slots=3)
    port = engines[0]
    prompt = np.arange(1, 9, dtype=np.int32)
    batch = torch.from_numpy(np.tile(prompt, (port.n_slots, 1)))
    logits, _ = port.model.prefill(port.params, batch,
                                   port.model.init_cache(port.n_slots, 96))
    eos = int(logits[0, -1].argmax())
    _submit(engines, 0, prompt, max_new_tokens=8, eos_id=eos)
    out = _run_both(engines)
    assert out[0] == [eos]                   # first sampled token == EOS


def test_engine_matches_single_request_decode(models):
    """Batch slots must not leak across requests: a request decoded in a
    full wave equals the same request decoded alone."""
    prompt = np.arange(2, 10, dtype=np.int32)
    solo = _engines(models, n_slots=1)
    _submit(solo, 0, prompt, max_new_tokens=4)
    solo_out = _run_both(solo)[0]

    engines = _engines(models, n_slots=3)
    rng = np.random.default_rng(1)
    _submit(engines, 0, prompt, max_new_tokens=4)
    for uid in (1, 2):
        _submit(engines, uid, rng.integers(
            0, engines[0].cfg.vocab_size, size=8).astype(np.int32),
            max_new_tokens=4)
    assert _run_both(engines)[0] == solo_out


def test_engine_admits_into_free_slot_mid_flight(models):
    engines = _engines(models, n_slots=2)
    port = engines[0]
    rng = np.random.default_rng(2)
    p = lambda n: rng.integers(0, port.cfg.vocab_size,  # noqa: E731
                               size=n).astype(np.int32)
    _submit(engines, 0, p(8), max_new_tokens=3)
    _submit(engines, 1, p(8), max_new_tokens=9)
    _submit(engines, 2, p(6), max_new_tokens=4)
    done = []
    for _ in range(3):                  # prefill + 2 decodes: uid0 exits
        done += port.step()
    assert [r.uid for r in done] == [0]
    assert port.active == 1 and len(port.waiting) == 1
    done += port.step()                 # uid2 admits into the freed slot
    assert port.active == 2 and not port.waiting
    assert {r.uid for r in port.slot_req if r is not None} == {1, 2}
    done += port.run()
    assert _outputs(done) == _outputs(engines[1].run())
    assert all(len(r.output) == r.max_new_tokens for r in done)


def test_engine_mid_flight_admission_matches_solo_decode(models):
    """A greedy request admitted mid-flight decodes exactly like a solo
    run of the same (position-aligned) prompt — the scratch-cache prefill
    and row copy must not disturb numerics."""
    prompt = np.arange(2, 8, dtype=np.int32)        # len 6 < cur_len 8
    engines = _engines(models, n_slots=2)
    _submit(engines, 0, np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    _submit(engines, 1, np.arange(3, 11, dtype=np.int32), max_new_tokens=9)
    _submit(engines, 2, prompt, max_new_tokens=4)
    batched = _run_both(engines)[2]
    # uid0 exits after 3 tokens, so uid2 admits at shared position 10
    solo = _engines(models, n_slots=1)
    _submit(solo, 2, np.pad(prompt, (10 - len(prompt), 0)), max_new_tokens=4)
    assert _run_both(solo)[2] == batched


def test_engine_defers_prompt_longer_than_shared_position(models):
    engines = _engines(models, n_slots=2)
    port = engines[0]
    rng = np.random.default_rng(3)
    p = lambda n: rng.integers(0, port.cfg.vocab_size,  # noqa: E731
                               size=n).astype(np.int32)
    _submit(engines, 0, p(8), max_new_tokens=3)
    _submit(engines, 1, p(8), max_new_tokens=5)
    _submit(engines, 2, p(40), max_new_tokens=2)
    done = []
    for _ in range(4):
        done += port.step()
    # uid0 exited, but uid2 (longer than the shared position) must wait
    assert port.active == 1 and len(port.waiting) == 1
    done += port.run()
    assert _outputs(done) == _outputs(engines[1].run())
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.output) == r.max_new_tokens for r in done)


def test_engine_per_slot_temperature(models):
    """Each slot samples with its own request's temperature: a greedy
    request beside a hot one decodes exactly as it does alone (and as
    the reference decodes it)."""
    prompt = np.arange(2, 10, dtype=np.int32)
    solo = _engines(models, n_slots=1)
    _submit(solo, 0, prompt, max_new_tokens=4, temperature=0.0)
    greedy_solo = _run_both(solo)[0]

    port, _ = _engines(models, n_slots=2)
    port.submit(Request(uid=1, prompt=np.arange(5, 13, dtype=np.int32),
                        max_new_tokens=4, temperature=5.0))
    port.submit(Request(uid=0, prompt=prompt, max_new_tokens=4,
                        temperature=0.0))
    out = _outputs(port.run())
    assert out[0] == greedy_solo
    assert all(0 <= t < port.cfg.vocab_size for t in out[1])


def test_sampling_is_seeded(models):
    """Hot sampling draws from the engine's seeded generator: the same
    seed repeats its tokens, and they vary with the seed."""
    _, _, tm, tp = models

    def hot(seed):
        eng = ServingEngine(tm, tp, n_slots=1, max_len=64, seed=seed)
        eng.submit(Request(uid=0, prompt=np.arange(1, 9, dtype=np.int32),
                           max_new_tokens=12, temperature=50.0))
        return eng.run()[0].output

    assert hot(0) == hot(0)
    assert hot(0) != hot(1)


def _jax_engine_gumbels(seed, n_steps, shape):
    """The reference engine's sampling draws, key for key: ``rng =
    key(seed)``, then per sampling step ``rng, sub = split(rng)`` and the
    Gumbel array ``categorical(sub, ...)`` adds to the logits."""
    rng, out = jax.random.key(seed), []
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        out.append(np.array(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


def test_engine_sampled_tokens_match_reference_under_replayed_draws(models):
    """Hot sampling is a Gumbel-max on both sides: fed the reference
    engine's ``jax.random`` Gumbel draws through the RNG seam, the port's
    engine samples the reference's tokens, token for token (f32), for
    slots at different temperatures beside a greedy one."""
    rm, rp, tm, tp = models
    n_slots, seed = 3, 7
    draws = ReplayDraws(gumbel=_jax_engine_gumbels(
        seed, 64, (n_slots, tm.cfg.vocab_size)))
    port = ServingEngine(tm, tp, n_slots=n_slots, max_len=96, seed=seed,
                         draws=draws)
    ref = JaxEngine(rm, rp, n_slots=n_slots, max_len=96, seed=seed)
    rng = np.random.default_rng(2)
    for uid, temp in enumerate((0.7, 0.0, 1.5, 1.0)):
        prompt = rng.integers(0, tm.cfg.vocab_size, size=6 + uid
                              ).astype(np.int32)
        _submit((port, ref), uid, prompt, max_new_tokens=6,
                temperature=temp)
    out = _run_both((port, ref))
    assert len(out) == 4 and all(len(o) == 6 for o in out.values())
    # the draws made a difference: hot slots left the greedy path
    greedy = _engines(models, n_slots=n_slots)
    rng = np.random.default_rng(2)
    for uid in range(4):
        prompt = rng.integers(0, tm.cfg.vocab_size, size=6 + uid
                              ).astype(np.int32)
        _submit(greedy, uid, prompt, max_new_tokens=6)
    cold = _run_both(greedy)
    assert out[1] == cold[1]
    assert any(out[u] != cold[u] for u in (0, 2, 3))


def test_ring_cache_engine_matches_reference():
    """A sliding-window qwen3 (window 8) on ring caches of 8 slots a
    layer: prompts longer than the ring, decodes that wrap it, a request
    admitted mid-flight; greedy tokens equal the reference engine's."""
    kw = dict(dtype="float32", sliding_window=8)
    rc = dataclasses.replace(jax_smoke("qwen3-1.7b").model, **kw)
    tc = dataclasses.replace(get_smoke_config("qwen3-1.7b").model, **kw)
    rm = jax_build(rc, ring_cache=True)
    rp = rm.init(jax.random.key(4))
    tm = build_model(tc, ring_cache=True, device="cpu")
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    engines = (ServingEngine(tm, tp, n_slots=2, max_len=64),
               JaxEngine(rm, rp, n_slots=2, max_len=64))
    assert engines[0].cache["groups"]["sub0"]["k"].shape[2] == 8
    rng = np.random.default_rng(5)
    for uid, (n, new) in enumerate([(11, 3), (13, 12), (6, 9)]):
        _submit(engines, uid, rng.integers(0, tc.vocab_size, size=n).astype(
            np.int32), max_new_tokens=new)
    out = _run_both(engines)
    assert sorted(len(o) for o in out.values()) == [3, 9, 12]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "12", "--tokens", "3",
                      "--device", "cpu"])
    assert tuple(out["tokens"].shape) == (2, 4)
    vocab = get_smoke_config(arch).model.vocab_size
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < vocab)).all())


def test_synthetic_lm_data_is_per_edge_and_reproducible():
    data = SyntheticLMData(vocab=64, seq_len=32, batch_size=4, seed=3)
    a = data.batch(0, 5, device="cpu")["tokens"]
    assert a.dtype == torch.int32 and tuple(a.shape) == (4, 32)
    assert torch.equal(a, data.batch(0, 5, device="cpu")["tokens"])
    assert not torch.equal(a, data.batch(0, 6, device="cpu")["tokens"])
    assert not torch.equal(a, data.batch(1, 5, device="cpu")["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 64
    # Zipf over a per-edge permutation: each edge has its own top token
    big = SyntheticLMData(vocab=64, seq_len=512, batch_size=8, seed=0)
    top = [int(torch.bincount(big.batch(e, 0, device="cpu")["tokens"]
                              .flatten().long()).argmax()) for e in range(4)]
    assert len(set(top)) > 1
