"""The LM engine in the ``dense`` serve mode, inside the port (CPU).

* The engine tests of JAX ``tests/test_serving.py``, in ``dense`` on
  the ``tiny`` preset: the engine against a manual greedy decode, slot
  refills, the prefill buckets (power-of-two widths; the port keeps no
  program cache, so JAX's LRU test becomes the buckets' widths),
  budgets of one token, an EOS from the prefill, over-long prompts and
  budgets, and storage that shrinks from ``dense`` to ``int8`` to
  ``sparse_cfmm``; a recurrent stack
  (RWKV6, Jamba) prefills at exact length.  The bucketed (end-padded)
  prefill equals the unpadded one bit for bit in ``dense``: logits,
  ``pos``, the length counters and the KV rows below the length (a
  recurrent stack's states differ).
* ``tests/test_decode.py`` for every config at ``reduced()`` (OLMoE's
  and DeepSeek's MoE at JAX's loose capacity, and Whisper over 24
  frames of an ``S_enc = 24`` cross cache, as there): a prefill and four
  decode steps against ``forward_train`` of the whole sequence, within
  0.06 of max |logit| and greedy tokens equal wherever the full
  forward's margin exceeds 0.05 of it.
* ``nn.vmap_init`` fills its preallocated stacks with the values the
  list-then-``torch.stack`` version gave, bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import nn
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch.serve import build_cfg
from repro_torch.models import lm, moe
from repro_torch.serving.engine import Request, ServingEngine

# the configs the engine serves: all but the encoder-decoder, whose
# requests would need frames (lm.forward_prefill serves it)
ENGINE_IDS = tuple(a for a in ARCH_IDS
                   if not get_config(a).encoder_decoder)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch runs one thread: beside the other processes of a parallel
    test run, its own pool oversubscribes the cores (this file, 40 tests,
    took 452 s in each of six concurrent runs at 8 threads and 11.4 s at
    one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    cfg = build_cfg("smollm_360m", "tiny")
    return cfg, lm.init(torch.Generator().manual_seed(0), cfg)


def _engine(tiny, mode="dense", slots=1, max_seq=32):
    cfg, params = tiny
    return ServingEngine(cfg, params, mode=mode, batch_slots=slots,
                         max_seq=max_seq, device="cpu")


def _manual_greedy(cfg, params, prompt, n, max_seq=32):
    """Unpadded prefill + batch-1 greedy decode: the engine's oracle."""
    pv = nn.unbox(params)
    cache = nn.unbox(lm.cache_init(cfg, 1, max_seq))
    toks = torch.tensor([prompt], dtype=torch.long)
    logits, cache = lm.forward_prefill(pv, {"tokens": toks}, cfg, cache)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, cache = lm.forward_decode(
            pv, {"token": torch.tensor([[out[-1]]])}, cfg, cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_engine_matches_manual_greedy_decode(tiny):
    cfg, params = tiny
    prompt = list(np.random.RandomState(0).randint(1, cfg.vocab, 10))
    req = Request(rid=0, prompt=prompt, max_new_tokens=6)
    _engine(tiny, slots=2).run([req])
    assert req.tokens_out == _manual_greedy(cfg, params, prompt, 6)


def test_engine_continuous_batching_refills_slots(tiny):
    cfg, _ = tiny
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=list(rng.randint(1, cfg.vocab, 8)),
                    max_new_tokens=4) for i in range(5)]
    _engine(tiny, slots=2).run(reqs)
    assert all(r.done for r in reqs)
    assert all(len(r.tokens_out) == 4 for r in reqs)


def _prefill_widths(monkeypatch):
    """Spy on ``lm.forward_prefill``: the width of every prefill."""
    widths, orig = [], lm.forward_prefill

    def spy(params, batch, cfg, cache):
        widths.append(batch["tokens"].shape[1])
        return orig(params, batch, cfg, cache)
    monkeypatch.setattr(lm, "forward_prefill", spy)
    return widths


def test_prefill_cache_bucketed_and_bounded(tiny, monkeypatch):
    """16 distinct prompt lengths prefill at 3 widths (8, 16, 32), and
    the bucketed prefill reproduces the unpadded greedy decode."""
    cfg, params = tiny
    widths = _prefill_widths(monkeypatch)
    rng = np.random.RandomState(2)
    reqs = [Request(rid=i, prompt=list(rng.randint(1, cfg.vocab, L)),
                    max_new_tokens=3) for i, L in enumerate(range(3, 19))]
    _engine(tiny, max_seq=64).run(reqs)
    assert all(r.done for r in reqs)
    assert set(widths) == {8, 16, 32}
    for r in (reqs[0], reqs[-1]):
        fresh = Request(rid=0, prompt=list(r.prompt), max_new_tokens=3)
        _engine(tiny, max_seq=64).run([fresh])
        assert fresh.tokens_out == _manual_greedy(cfg, params, r.prompt, 3,
                                                  64)


def test_prefill_cache_lru_eviction(tiny, monkeypatch):
    """The port compiles no prefill programs, so it has no LRU to evict:
    what stays of JAX's test is that lengths 5, 12 and 30 prefill at
    their buckets 8, 16 and 32, and that the bucket is capped at
    max_seq."""
    cfg, _ = tiny
    widths = _prefill_widths(monkeypatch)
    rng = np.random.RandomState(3)
    eng = _engine(tiny, max_seq=256)
    for L in (5, 12, 30):
        eng.run([Request(rid=L, prompt=list(rng.randint(1, cfg.vocab, L)),
                         max_new_tokens=1)])
    _engine(tiny, max_seq=24).run([Request(
        rid=0, prompt=list(rng.randint(1, cfg.vocab, 20)), max_new_tokens=1)])
    assert widths == [8, 16, 32, 24]


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_v01_52b"])
def test_recurrent_arch_prefills_exact_length(arch, monkeypatch):
    """JAX's test of the same name: bucketing is gated on attention-only
    stacks (pad tokens would advance the recurrent states), so a
    recurrent engine prefills a 5-token prompt at width 5, not its
    bucket 8, and its tokens equal the manual unpadded greedy decode
    (RWKV6 and Jamba at the ``tiny`` preset)."""
    cfg = build_cfg(arch, "tiny")
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    engine = ServingEngine(cfg, params, mode="dense", batch_slots=1,
                           max_seq=32, device="cpu")
    assert not engine._bucket_prefill
    widths = _prefill_widths(monkeypatch)
    prompt = list(np.random.RandomState(4).randint(1, cfg.vocab, 5))
    req = Request(rid=0, prompt=prompt, max_new_tokens=3)
    engine.run([req])
    assert widths == [5]
    assert req.tokens_out == _manual_greedy(cfg, params, prompt, 3)


def test_max_new_tokens_one_gets_exactly_one_token(tiny):
    cfg, _ = tiny
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, prompt=list(rng.randint(1, cfg.vocab, 6)),
                    max_new_tokens=1) for i in range(3)]
    eng = _engine(tiny, slots=2)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [len(r.tokens_out) for r in reqs] == [1, 1, 1]
    assert all(s is None for s in eng.active)


def test_prefill_eos_completes_without_decode(tiny):
    cfg, _ = tiny
    prompt = list(np.random.RandomState(6).randint(1, cfg.vocab, 7))
    probe = Request(rid=0, prompt=list(prompt), max_new_tokens=4)
    _engine(tiny).run([probe])
    first = probe.tokens_out[0]
    req = Request(rid=1, prompt=list(prompt), max_new_tokens=4,
                  eos_id=first)
    _engine(tiny).run([req])
    assert req.done and req.tokens_out == [first]


def test_overlong_prompt_rejected_at_submit(tiny):
    cfg, _ = tiny
    eng = _engine(tiny, max_seq=16)
    long_prompt = list(np.random.RandomState(7).randint(1, cfg.vocab, 17))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=0, prompt=long_prompt))
    assert not eng.queue
    with pytest.raises(ValueError, match="decode budget"):
        eng.submit(Request(rid=2, prompt=long_prompt[:16], max_new_tokens=4))
    ok = Request(rid=1, prompt=long_prompt[:16], max_new_tokens=1)
    eng.run([ok])
    assert ok.done and len(ok.tokens_out) == 1
    ok2 = Request(rid=3, prompt=long_prompt[:13], max_new_tokens=4)
    eng.run([ok2])
    assert ok2.done and len(ok2.tokens_out) == 4


def test_compiled_modes_storage_shrinks(tiny):
    def nbytes(eng):
        return sum(t.numel() * t.element_size() for t in nn.tree_leaves(
            eng.params) if isinstance(t, torch.Tensor))

    dense, int8, sparse = (nbytes(_engine(tiny, mode, max_seq=16))
                           for mode in ("dense", "int8", "sparse_cfmm"))
    assert sparse < int8 < dense


# ---------------------------------------------------------------------------
# The five configs at reduced()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """arch -> (reduced config, unboxed float tree from the port's init)."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = get_config(arch).reduced()
            out[arch] = (cfg, nn.unbox(lm.init(
                torch.Generator().manual_seed(0), cfg)))
        return out[arch]
    return get


def _prefill(cfg, params, toks, width, S=64):
    cache = nn.unbox(lm.cache_init(cfg, 1, S))
    padded = np.zeros((1, width), np.int64)
    padded[0, :len(toks)] = toks
    batch = {"tokens": torch.from_numpy(padded)}
    if width != len(toks):
        batch["length"] = torch.tensor([len(toks)], dtype=torch.int32)
    return lm.forward_prefill(params, batch, cfg, cache)


# the sequence axis of each cache leaf: k/v (..., S, KVH, D), MLA's
# latent c_kv and rotary k_rope (..., S, C)
SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _kv_layers(cache):
    return ([c for c in cache["prefix"]] + [c for c in cache["template"]]
            + [c for c in cache["suffix"]])


def _loose_capacity(monkeypatch):
    """MoE capacity for every token, as JAX's ``test_decode.py`` sets it:
    the capacity follows the token count, so runs over other lengths
    would otherwise drop other picks (tests/test_torch_moe.py holds the
    drops)."""
    monkeypatch.setattr(moe, "moe_forward", functools.partial(
        moe.moe_forward, capacity_factor=16.0))


@pytest.mark.parametrize("arch", ENGINE_IDS)
def test_dense_bucketed_prefill_bit_exact(reduced, arch, monkeypatch):
    """In ``dense`` nothing couples a row to the pad rows (no shared
    activation scale), and causal attention hides them: the bucketed
    prefill's logits and the KV rows (MLA: the latent rows) below the
    length are the unpadded prefill's, bit for bit (Gemma3: a 37-token
    prompt, past the reduced window of 32).  OLMoE's pad rows queue
    behind the real ones, so at a capacity that keeps every pick they
    displace none.  A recurrent stack (RWKV6, Jamba's Mamba layers) is
    causal too, but not to the bit: RWKV's chunk factors its decays
    through the mid-chunk position, which a pad token can fill, so its
    logits agree within 0.06 of max |logit|, Mamba's exactly; and the
    pad tokens advance every recurrent state, which no length rewind
    undoes: the states differ, which is why the engine prefills a
    recurrent stack at exact length."""
    _loose_capacity(monkeypatch)
    cfg, params = reduced(arch)
    for L, width in ((13, 16), (37, 64)):
        toks = np.random.RandomState(L).randint(1, cfg.vocab, L)
        la, ca = _prefill(cfg, params, toks, L)
        lb, cb = _prefill(cfg, params, toks, width)
        if any(sig["kind"] == "rwkv" for sig in cfg.layer_sigs()):
            scale = float(la.float().abs().max())
            assert float((la.float() - lb.float()).abs().max()) / scale \
                < 0.06, (arch, L)
        else:
            assert torch.equal(la, lb), (arch, L)
        assert torch.equal(cb["pos"], torch.tensor([L], dtype=torch.int32))
        for a, b in zip(_kv_layers(ca), _kv_layers(cb)):
            if "length" not in a:                   # a recurrent state
                leaves = [(x, y) for x, y in zip(_leaves(a), _leaves(b))]
                assert leaves and any(not torch.equal(x, y)
                                      for x, y in leaves), (arch, L)
                continue
            assert torch.equal(a["length"], b["length"])
            keys = set(a) - {"length"}
            assert keys in ({"k", "v"}, {"c_kv", "k_rope"}), keys
            for key in keys:
                rows = a[key].narrow(SEQ_AXIS[key], 0, L)
                assert torch.equal(rows, b[key].narrow(SEQ_AXIS[key], 0, L)
                                   ), (arch, L, key)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_full_forward(reduced, arch, monkeypatch):
    """JAX ``test_decode.py`` in the port: prefill T - 4 tokens, decode
    four, against ``forward_train`` of all T, MoE at JAX's loose
    capacity, an encoder-decoder over the same 24 frames throughout; aux
    is a dense stack's zeros, and an MoE stack drops no pick."""
    _loose_capacity(monkeypatch)
    cfg, params = reduced(arch)
    B, T = 2, 16
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab, (B, T)))
    kw, cache_kw = {}, {}
    if cfg.encoder_decoder:
        kw["frames"] = torch.from_numpy(np.random.RandomState(1).randn(
            B, 24, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
        cache_kw["S_enc"] = 24
    full, aux = lm.forward_train(params, {**kw, "tokens": toks,
                                          "labels": toks}, cfg)
    assert full.shape == (B, T, cfg.vocab) and full.dtype == torch.bfloat16
    if cfg.moe is None:
        assert aux == {"lb_loss": 0.0, "z_loss": 0.0, "dropped_frac": 0.0}
    else:
        assert float(aux["dropped_frac"]) == 0.0
        assert float(aux["lb_loss"]) > 0 and float(aux["z_loss"]) > 0
    cache = nn.unbox(lm.cache_init(cfg, B, 32, **cache_kw))
    lg, cache = lm.forward_prefill(params, {**kw, "tokens": toks[:, :T - 4]},
                                   cfg, cache)
    outs = [lg]
    for t in range(T - 4, T):
        lg, cache = lm.forward_decode(params, {"token": toks[:, t:t + 1]},
                                      cfg, cache)
        outs.append(lg)
    dec = torch.cat(outs[:-1], dim=1).float()
    ref = full[:, T - 5:T - 1].float()
    scale = float(ref.abs().max())
    assert float((dec - ref).abs().max()) / scale < 0.06, arch
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / scale
    disagree = dec.argmax(-1) != ref.argmax(-1)
    assert not bool((disagree & (margin > 0.05)).any()), arch


def test_forward_train_qat_raises(reduced):
    """``forward_train(qat=True)`` (it raised before the training slice)
    runs the INT7 fake-quant forward: finite logits off the plain ones,
    within the INT7 error of them, and a gradient that reaches every
    leaf through the straight-through round."""
    cfg, params = reduced("smollm_360m")
    toks = torch.arange(1, 9, dtype=torch.long)[None]
    with torch.no_grad():
        plain = lm.forward_train(params, {"tokens": toks}, cfg)[0].float()
        qat = lm.forward_train(params, {"tokens": toks}, cfg,
                               qat=True)[0].float()
    assert bool(torch.isfinite(qat).all()) and not torch.equal(qat, plain)
    assert float((qat - plain).abs().max()) <= 0.06 * float(
        plain.abs().max())
    live = [t.detach().requires_grad_() for t in nn.tree_leaves(params)]
    it = iter(live)
    p = nn.tree_map(lambda _: next(it), params)
    logits, aux = lm.forward_train(p, {"tokens": toks}, cfg, qat=True)
    loss, _ = lm.loss_fn(logits, toks, aux)
    grads = torch.autograd.grad(loss, live)
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
               for g in grads)


# ---------------------------------------------------------------------------
# vmap_init at one copy
# ---------------------------------------------------------------------------

def _vmap_init_stacked_list(init_fn, gen, n, *args, **kwargs):
    """The list-then-stack ``vmap_init`` this one replaced (two copies
    of every stacked leaf at its peak): the values to hold it to."""
    copies = [init_fn(gen, *args, **kwargs) for _ in range(n)]

    def build(trees):
        first = trees[0]
        if isinstance(first, nn.Param):
            return nn.Param(torch.stack([t.value for t in trees]),
                            ("layers",) + first.axes, first.kind)
        if isinstance(first, dict):
            return {k: build([t[k] for t in trees]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(build([t[i] for t in trees])
                               for i in range(len(first)))
        return first
    return build(copies)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_vmap_init_fills_the_same_values(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    new = lm.init(torch.Generator().manual_seed(3), cfg)
    monkeypatch.setattr(nn, "vmap_init", _vmap_init_stacked_list)
    old = lm.init(torch.Generator().manual_seed(3), cfg)
    is_param = lambda x: isinstance(x, nn.Param)
    a, b = nn.tree_leaves(new, is_param), nn.tree_leaves(old, is_param)
    assert len(a) == len(b) and any(p.axes[0] == "layers" for p in a)
    for p, q in zip(a, b):
        assert (p.axes, p.kind) == (q.axes, q.kind)
        assert p.value.dtype == q.value.dtype
        assert torch.equal(p.value, q.value)
