"""Shared harness of the LM parity files (``test_torch_lm_*.py``): JAX
``lm.init`` -> ``params_from_numpy`` -> each package compiles its own
tree (or keeps it dense) -> the port's ``ServingEngine(device="cpu")``
against the JAX package's ``ServingEngine``, whose jitted forwards are
the oracle, under ``REPRO_PALLAS=jnp``.

``LMParity`` holds the tests every dense LM config runs at
``reduced()``; a file subclasses it as ``Test<Name>`` and sets ``ARCH``
and its traffic.  The logit bound is SmolLM's (tests/test_torch_lm.py,
``LOGIT_BOUND``): bf16 rounds where XLA's fusion puts it, the jnp flash
lowering rounds its scores and ``p.v`` to bf16 where the port follows the
Pallas kernel (f32), and in the compiled modes one flipped int8
activation code moves a layer's output by a step of its scale.  Configs
with an untied head have logits 4.4x as wide: their compiled modes,
which measure above 0.06, are held to ``UNTIED_LOGIT_BOUND``; their
``dense`` mode keeps 0.06.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs.base import get_config as jget_config
from repro.core import compiled_linear as jcl
from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng

# max |dlogit| measured for SmolLM (tests/test_torch_lm.py) over every
# compared call: 0.0352 with jax 0.9.0 (logits of std about 0.2 at these
# sizes); the bound leaves room for XLA versions that round bf16 elsewhere
LOGIT_BOUND = 0.06
# An untied head (StableLM, Phi-3) is a 1/sqrt(d)-scaled linear: logits
# of std ~0.88, against ~0.20 from a tied 0.02-scaled embedding (SmolLM,
# Gemma3), so the same relative error is 4.4x as many logit units.
# Measured max |dlogit| (jax 0.9.0): StableLM 0.044 / 0.125 / 0.092 and
# Phi-3 0.041 / 0.148 / 0.078 in dense / int8 / sparse_cfmm, i.e. 0.05-0.17
# logit std, as SmolLM's 0.035 is 0.18 of its 0.20.  0.06 scaled by 4.4,
# for the two compiled modes only: dense stays within 0.06.
UNTIED_LOGIT_BOUND = 0.25
MODES = ("dense", "int8", "sparse_cfmm")
# per mode: an untied config's bounds (``LMParity.BOUND``)
UNTIED_BOUNDS = {"dense": LOGIT_BOUND, "int8": UNTIED_LOGIT_BOUND,
                 "sparse_cfmm": UNTIED_LOGIT_BOUND}


def flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jnn.Param))[0]
    return {jax.tree_util.keystr(p): v for p, v in leaves}


def flat_port(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_port(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_port(v, f"{path}[{i}]"))
        return out
    if isinstance(tree, (tcl.KDim, tcl.ConvGeom)):
        return {}                 # JAX's markers are childless nodes
    return {path: tree}


def to_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if getattr(x, "dtype", None) == jnp.bfloat16 else np.asarray(x)


def requests(vocab, cls, prompts, max_new, seed=11):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=[int(t) for t in rng.randint(1, vocab, L)],
                max_new_tokens=max_new) for i, L in enumerate(prompts)]


def run_engines(jcfg, tcfg, jc, tc, mode, prompts, slots, max_seq, max_new):
    """The two engines over the same requests.  ``jc``/``tc`` are the
    boxed trees each package serves (compiled in ``mode``, or the float
    tree for ``dense``).  Returns per forward call (in order) its kind,
    the active rows and both packages' last-position logits, and both
    engines' tokens.  Without EOS the schedule of calls is the same in
    both, whatever tokens they pick."""
    jcalls, tcalls = [], []
    # jc is already what JAX serves: its dense mode only unboxes it
    je = jeng.ServingEngine(jcfg, jc, mode="dense", batch_slots=slots,
                            max_seq=max_seq)
    prefill_fn, decode = je._prefill_fn, je._decode

    def rec_prefill_fn(bucket):
        fn = prefill_fn(bucket)

        def call(p, c, b):
            logits, nc = fn(p, c, b)
            jcalls.append(("prefill", [0], to_np(logits[:, -1])))
            return logits, nc
        return call

    def rec_decode(p, c, b):
        logits, nc = decode(p, c, b)
        active = [i for i, r in enumerate(je.active) if r is not None]
        jcalls.append(("decode", active, to_np(logits[:, -1])))
        return logits, nc

    je._prefill_fn, je._decode = rec_prefill_fn, rec_decode
    jreqs = je.run(requests(jcfg.vocab, jeng.Request, prompts, max_new))

    te = teng.ServingEngine(tcfg, tnn.unbox(tc), mode=mode,
                            batch_slots=slots, max_seq=max_seq, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for fname in ("forward_prefill", "forward_decode"):
            def rec(*a, _f=getattr(tlm, fname), **kw):
                logits, nc = _f(*a, **kw)
                tcalls.append(logits[:, -1].float().numpy())
                return logits, nc
            mp.setattr(tlm, fname, rec)
        treqs = te.run(requests(tcfg.vocab, teng.Request, prompts, max_new))
    assert len(jcalls) == len(tcalls)
    return dict(calls=[(kind, rows, jl, tl) for (kind, rows, jl), tl
                       in zip(jcalls, tcalls)],
                jax_tokens=[r.tokens_out for r in jreqs],
                port_tokens=[r.tokens_out for r in treqs])


def compare_calls(run):
    """Walk the calls in order.  A prefill sees only its prompt, so every
    prefill is compared; decode steps are compared up to the first step
    at which a greedy token differs (after it every row sees other
    inputs).  Returns (max |dlogit| over the rows compared, tokens
    compared, the JAX margins between its top token and the port's
    where they differ)."""
    worst, n_tok, margins, parted = 0.0, 0, [], False
    for kind, rows, jl, tl in run["calls"]:
        if kind == "decode" and parted:
            continue
        for r in rows:
            worst = max(worst, float(np.abs(jl[r] - tl[r]).max()))
            jt, tt = int(np.argmax(jl[r])), int(np.argmax(tl[r]))
            if jt != tt:
                margins.append(float(jl[r][jt] - jl[r][tt]))
                parted = True
            n_tok += 1
    return worst, n_tok, margins


def check_run(run, n_prompts, max_new, bound, label):
    """Every compared call within ``bound``; greedy tokens equal
    wherever JAX's margin exceeds twice the bound, the whole streams when
    no step parted."""
    worst, n_tok, margins = compare_calls(run)
    assert {kind for kind, _, _, _ in run["calls"]} == {"prefill", "decode"}
    assert n_tok >= n_prompts + 1       # every prefill and a decode step
    assert worst <= bound, (label, worst)
    assert all(m <= 2 * bound for m in margins), (label, margins)
    if not margins:
        assert n_tok == n_prompts * max_new
        assert run["port_tokens"] == run["jax_tokens"]
    return worst


class LMParity:
    """The parity tests of one dense LM config at ``reduced()``.  A
    subclass sets ``ARCH``, ``PROMPTS``, ``SLOTS``, ``MAX_SEQ`` and
    ``MAX_NEW``, and its ``BOUND`` (mode -> bound) if its head is
    untied."""

    ARCH = None
    BOUND = {mode: LOGIT_BOUND for mode in MODES}
    PROMPTS = (5, 13, 8)
    SLOTS, MAX_SEQ, MAX_NEW = 2, 32, 4

    @pytest.fixture(scope="class", autouse=True)
    def _jnp_lowering_one_torch_thread(self):
        """The JAX side runs its exact jnp lowering.  Torch runs one
        thread: beside XLA's CPU thread pool, torch's own pool
        oversubscribes the cores and slows these small ops by an order
        of magnitude."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_PALLAS", "jnp")
                yield
        finally:
            torch.set_num_threads(threads)

    @classmethod
    def configs(cls, **over):
        """(JAX config, port config) at ``reduced()``, with ``over``."""
        return tuple(dataclasses.replace(get(cls.ARCH).reduced(), **over)
                     for get in (jget_config, tget_config))

    @classmethod
    def init_trees(cls, jcfg):
        """(JAX boxed tree, the port's boxed tree): the same f32
        weights on both sides."""
        jt = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
        return jt, tnn.params_from_numpy(jt)

    @pytest.fixture(scope="class")
    def served_trees(self):
        """mode -> (JAX boxed tree, port boxed tree) each engine serves:
        the float trees for ``dense``, else each package's compile."""
        jt, tt = self.init_trees(self.configs()[0])
        cache = {"dense": (jt, tt)}

        def get(mode):
            if mode not in cache:
                cache[mode] = (jcl.compile_params(jt, mode=mode),
                               tcl.compile_params(tt, mode=mode))
            return cache[mode]
        return get

    @pytest.fixture(scope="class")
    def served(self, served_trees):
        runs = {}

        def get(mode):
            if mode not in runs:
                jcfg, tcfg = self.configs()
                runs[mode] = run_engines(jcfg, tcfg, *served_trees(mode), mode,
                                         self.PROMPTS, self.SLOTS,
                                         self.MAX_SEQ, self.MAX_NEW)
            return runs[mode]
        return get

    def test_config_matches_jax(self):
        """The full config and ``reduced()`` equal JAX's field for field,
        and both packages group the layers alike."""
        jfull, tfull = jget_config(self.ARCH), tget_config(self.ARCH)
        assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
        jcfg, tcfg = self.configs()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for cfg in (tfull, tcfg):
            sigs = cfg.layer_sigs()
            assert tlm.group_layers(sigs) == jlm.group_layers(sigs)

    @pytest.mark.parametrize("mode", ["int8", "sparse_cfmm"])
    def test_compiled_bytes_equal_jax(self, served_trees, mode):
        """Tier 1: codes, scales, bitmap and values of every leaf — the
        stacked (layers, K, N) template leaves included — are the same
        bytes, under the same logical axes."""
        jc, tc = served_trees(mode)
        jf, tf = flat_jax(jc), flat_port(tc)
        assert jf.keys() == tf.keys()
        n_stacked = 0
        for k, jp in jf.items():
            tp = tf[k]
            assert tp.axes == jp.axes, k
            a, b = np.asarray(jp.value), tp.value.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
            n_stacked += "['template']" in k and tp.axes[0] == "layers"
        assert n_stacked >= 7 * 2          # seven linears, two parts each

    @pytest.mark.parametrize("mode", MODES)
    def test_prefill_and_decode_logits_match_jitted_jax(self, served, mode):
        worst, _, _ = compare_calls(served(mode))
        assert worst <= self.BOUND[mode], (self.ARCH, mode, worst)

    @pytest.mark.parametrize("mode", MODES)
    def test_engine_greedy_tokens_match_jitted_jax(self, served, mode):
        """Greedy tokens equal wherever JAX's margin exceeds twice the
        logit bound; with no step parted, the whole token streams are
        equal."""
        check_run(served(mode), len(self.PROMPTS), self.MAX_NEW,
                  self.BOUND[mode], (self.ARCH, mode))
