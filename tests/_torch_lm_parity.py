"""Shared harness of the LM parity files (``test_torch_lm_*.py``): JAX
``lm.init`` -> ``params_from_numpy`` (or, with ``PORT_INIT``, the port's
``lm.init`` -> ``jax_tree_from_port``) -> each package compiles its own
tree (or keeps it dense) -> the port's ``ServingEngine(device="cpu")``
against the JAX package's ``ServingEngine``, whose jitted forwards are
the oracle, under ``REPRO_PALLAS=jnp``.  Every compared logit must be
finite on both sides.

``LMParity`` holds the tests every dense LM config runs at
``reduced()``; a file subclasses it as ``Test<Name>`` and sets ``ARCH``
and its traffic.  ``MoEParity`` adds an MoE config's routing replay
(``RoutingTape``) and aux.  The logit bound is SmolLM's
(tests/test_torch_lm.py, ``LOGIT_BOUND``): bf16 rounds where XLA's
fusion puts it, the jnp flash lowering rounds its scores and ``p.v`` to
bf16 where the port follows the Pallas kernel (f32), and in the compiled
modes one flipped int8 activation code moves a layer's output by a step
of its scale.  Configs with an untied head have logits 4.4x as wide:
their compiled modes, which measure above 0.06, are held to
``UNTIED_LOGIT_BOUND``; their ``dense`` mode keeps 0.06.
"""
import contextlib
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
from repro_torch.configs import base as tbase
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
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


def port_config(cfg):
    """The port's ``ArchConfig`` equal to JAX's ``cfg``, field for
    field."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tbase, type(v).__name__)(**{
                f.name: conv(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        return v
    return conv(cfg)


def jax_tree_from_port(tree):
    """The port's boxed tree as JAX ``Param`` boxes holding the same
    bits (the inverse of ``params_from_numpy``)."""
    return tnn.tree_map(
        lambda p: jnn.Param(jnp.asarray(p.value.numpy()), p.axes, p.kind),
        tree, is_leaf=lambda x: isinstance(x, tnn.Param))


def to_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if getattr(x, "dtype", None) == jnp.bfloat16 else np.asarray(x)


def requests(vocab, cls, prompts, max_new, seed=11):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=[int(t) for t in rng.randint(1, vocab, L)],
                max_new_tokens=max_new) for i, L in enumerate(prompts)]


def run_engines(jcfg, tcfg, jc, tc, mode, prompts, slots, max_seq, max_new,
                force_tokens=False):
    """The two engines over the same requests.  ``jc``/``tc`` are the
    boxed trees each package serves (compiled in ``mode``, or the float
    tree for ``dense``).  Returns per forward call (in order) its kind,
    the active rows and both packages' last-position logits, and both
    engines' tokens.  Without EOS the schedule of calls is the same in
    both, whatever tokens they pick.  With ``force_tokens`` the port's
    engine takes JAX's greedy token at every call (its own logits are
    recorded first), so every call of both runs sees the same inputs."""
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
                if force_tokens:          # JAX's pick, for the engine
                    _, rows, jl = jcalls[len(tcalls) - 1]
                    logits = torch.zeros_like(logits[:, -1:])
                    for r in rows:
                        logits[r, 0, int(np.argmax(jl[r]))] = 1
                return logits, nc
            mp.setattr(tlm, fname, rec)
        treqs = te.run(requests(tcfg.vocab, teng.Request, prompts, max_new))
    assert len(jcalls) == len(tcalls)
    return dict(calls=[(kind, rows, jl, tl) for (kind, rows, jl), tl
                       in zip(jcalls, tcalls)],
                jax_tokens=[r.tokens_out for r in jreqs],
                port_tokens=[r.tokens_out for r in treqs],
                forced=force_tokens)


def compare_calls(run):
    """Walk the calls in order.  A prefill sees only its prompt, so every
    prefill is compared; decode steps are compared up to the first step
    at which a greedy token differs (after it every row sees other
    inputs), every one in a run with forced tokens.  Returns (max
    |dlogit| over the rows compared, tokens compared, the JAX margins
    between its top token and the port's where they differ)."""
    worst, n_tok, margins, parted = 0.0, 0, [], False
    for kind, rows, jl, tl in run["calls"]:
        if kind == "decode" and parted:
            continue
        for r in rows:
            # a NaN would drop out of the max below
            assert np.isfinite(jl[r]).all() and np.isfinite(tl[r]).all()
            worst = max(worst, float(np.abs(jl[r] - tl[r]).max()))
            jt, tt = int(np.argmax(jl[r])), int(np.argmax(tl[r]))
            if jt != tt:
                margins.append(float(jl[r][jt] - jl[r][tt]))
                parted = not run["forced"]
            n_tok += 1
    return worst, n_tok, margins


def check_run(run, n_prompts, max_new, bound, label):
    """Every compared call within ``bound``; greedy tokens equal
    wherever JAX's margin exceeds twice the bound, the whole streams when
    no step parted; every call compared when the tokens were forced."""
    worst, n_tok, margins = compare_calls(run)
    assert {kind for kind, _, _, _ in run["calls"]} == {"prefill", "decode"}
    assert n_tok >= n_prompts + 1       # every prefill and a decode step
    assert worst <= bound, (label, worst)
    assert all(m <= 2 * bound for m in margins), (label, margins)
    if run["forced"] or not margins:
        assert n_tok == n_prompts * max_new
    if not margins:
        assert run["port_tokens"] == run["jax_tokens"]
    return worst


class LMParity:
    """The parity tests of one dense LM config at ``reduced()``.  A
    subclass sets ``ARCH``, ``PROMPTS``, ``SLOTS``, ``MAX_SEQ`` and
    ``MAX_NEW``, its ``BOUND`` (mode -> bound) if its head is untied, and
    ``MODES`` to run fewer than the three."""

    ARCH = None
    BOUND = {mode: LOGIT_BOUND for mode in MODES}
    # the serve modes the class's ``mode`` tests run in (a config's file
    # may split them over two classes to keep each file's time down)
    MODES = MODES
    PROMPTS = (5, 13, 8)
    SLOTS, MAX_SEQ, MAX_NEW = 2, 32, 4
    # the port's engine takes JAX's greedy tokens (``run_engines``)
    FORCE_TOKENS = False

    def pytest_generate_tests(self, metafunc):
        """Every test taking ``mode`` runs in each of ``MODES`` (the
        compiled-bytes test in the compiled ones)."""
        if "mode" in metafunc.fixturenames:
            modes = self.MODES
            if metafunc.function.__name__ == "test_compiled_bytes_equal_jax":
                modes = [m for m in modes if m != "dense"]
            metafunc.parametrize("mode", modes)

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

    # the port initialises the weights and JAX takes them through numpy
    # (``jax_tree_from_port``), where JAX's jitted init of a deep reduced
    # stack would cost seconds of compile per file
    PORT_INIT = False

    @classmethod
    def init_trees(cls, jcfg):
        """(JAX boxed tree, the port's boxed tree): the same f32
        weights on both sides."""
        if cls.PORT_INIT:
            tt = tlm.init(torch.Generator().manual_seed(0),
                          port_config(jcfg))
            return jax_tree_from_port(tt), tt
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
                                         self.MAX_SEQ, self.MAX_NEW,
                                         self.FORCE_TOKENS)
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

    def test_prefill_and_decode_logits_match_jitted_jax(self, served, mode):
        worst, n_tok, _ = compare_calls(served(mode))
        print(f"{self.ARCH}/{mode}: max|dlogit| {worst:.4g} over {n_tok} "
              f"compared tokens")
        assert worst <= self.BOUND[mode], (self.ARCH, mode, worst)

    def test_engine_greedy_tokens_match_jitted_jax(self, served, mode):
        """Greedy tokens equal wherever JAX's margin exceeds twice the
        logit bound; with no step parted, the whole token streams are
        equal."""
        check_run(served(mode), len(self.PROMPTS), self.MAX_NEW,
                  self.BOUND[mode], (self.ARCH, mode))


# JAX's margin at a token whose picks the port, on JAX's routing so far,
# would make otherwise (``RoutingTape.flips``).  Measured (jax 0.9.0, the
# three modes' engine runs at reduced(), 8 experts whose router logits have
# a std of about 0.2, so probabilities near 1/8 sit close together): 3-9
# flips per mode among the tokens that reach a compared logit, margins
# 8.5e-5 to 1.23e-3 for OLMoE (4x headroom) and 1.2e-5 to 2.0e-3 for
# DeepSeek-V2-Lite (2.5x).
FLIP_MARGIN = 0.005
# forward_train's aux on JAX's routing: ``dropped_frac`` follows from the
# picks alone (1e-6: one f32 mean); ``lb_loss`` and ``z_loss`` read the
# router's probabilities and logits, whose inputs past the first layer
# carry the stack's bf16 spread: measured 9.4e-5 and 7.5e-5 relative
# (OLMoE), 1.1e-4 and 3.4e-5 (DeepSeek-V2-Lite), held to 1e-3.  At one
# input (tests/test_torch_moe.py) they hold 1e-5.
AUX_RTOL = {"dropped_frac": 1e-6, "lb_loss": 1e-3, "z_loss": 1e-3}


class RoutingTape:
    """JAX's routing picks, recorded inside its jitted forwards (an ordered
    debug callback on ``jax.lax.top_k``: one record per MoE layer and
    call, in order) and replayed into the port's ``moe.pick_experts``,
    which records its own picks beside them."""

    def __init__(self):
        self.jax, self.port = [], []

    @contextlib.contextmanager
    def record_jax(self):
        orig = jax.lax.top_k

        def rec(operand, k):
            vals, idx = orig(operand, k)
            jax.debug.callback(lambda o, i: self.jax.append(
                (np.asarray(o), np.asarray(i))), operand, idx, ordered=True)
            return vals, idx

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.lax, "top_k", rec)
            yield self

    @contextlib.contextmanager
    def replay_port(self):
        orig = tmoe.pick_experts

        def replay(probs, k):
            own = orig(probs, k)
            _, picks = self.jax[len(self.port)]
            assert picks.shape == tuple(own.shape)
            self.port.append(own.numpy().copy())
            return torch.from_numpy(picks.astype(np.int64))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmoe, "pick_experts", replay)
            yield self

    def flips(self, calls=None, prompts=None, forced=False):
        """(record, token, JAX's margin) of every token whose own port
        picks differ from JAX's.  The margin is JAX's probability of its
        pick over that of the port's pick, at the first choice where they
        differ: how near JAX itself was to picking as the port did.

        Given an engine run's ``calls`` and its ``prompts``, only the
        tokens that reach a compared logit count: a prefill's first L
        rows (its pad rows queue behind them and attend to nothing
        real), a decode step's active rows, and no decode step after the
        greedy tokens part (``compare_calls``; with forced tokens they
        never do)."""
        assert len(self.port) == len(self.jax)
        per_call = len(self.jax) // len(calls) if calls else None
        lengths, parted, out = iter(prompts or ()), False, []
        real = {}
        for c, (kind, rows, jl, tl) in enumerate(calls or ()):
            if kind == "prefill":
                real[c] = set(range(next(lengths)))
            elif not parted:
                real[c] = set(rows)
            parted = parted or (not forced and kind == "decode" and any(
                np.argmax(jl[r]) != np.argmax(tl[r]) for r in rows))
        for i, ((probs, picks), own) in enumerate(zip(self.jax, self.port)):
            for t in np.nonzero((picks != own).any(-1))[0]:
                if calls and int(t) not in real.get(i // per_call, ()):
                    continue
                j = int(np.argmax(picks[t] != own[t]))
                out.append((i, int(t), float(probs[t, picks[t, j]]
                                             - probs[t, own[t, j]])))
        return out


class MoEParity(LMParity):
    """``LMParity`` for an MoE config: the engine runs replay JAX's
    routing into the port (``RoutingTape``), so the logits compare the
    arithmetic; every pick the port would have made otherwise is held to
    a near-tie; ``forward_train``'s aux against JAX's.  A subclass may
    set its own ``FLIP_MARGINS`` (mode -> margin; ``forward_train`` runs
    the dense tree)."""

    FLIP_MARGINS = {mode: FLIP_MARGIN for mode in MODES}

    @classmethod
    def n_moe(cls) -> int:
        """MoE layers of the reduced stack: routed layer calls per
        forward."""
        return sum(bool(s["moe"]) for s in cls.configs()[1].layer_sigs())

    @pytest.fixture(scope="class")
    def served(self, served_trees):
        """``LMParity.served`` with JAX's routing replayed into the port
        (``RoutingTape``): the runs make the same discrete choices, so
        the logits compare the arithmetic.  mode -> the run, with its
        tape under ``"tape"``."""
        runs = {}

        def get(mode):
            if mode not in runs:
                jcfg, tcfg = self.configs()
                tape = RoutingTape()
                with tape.record_jax(), tape.replay_port():
                    runs[mode] = run_engines(
                        jcfg, tcfg, *served_trees(mode), mode, self.PROMPTS,
                        self.SLOTS, self.MAX_SEQ, self.MAX_NEW,
                        self.FORCE_TOKENS)
                runs[mode]["tape"] = tape
            return runs[mode]
        return get

    def test_routing_flips_are_near_ties(self, served, mode):
        """Where the port, on JAX's routing so far, would pick otherwise
        than JAX, JAX's own margin at that token is under
        ``FLIP_MARGINS[mode]``: a near-tie that a bf16 rounding upstream
        turns.  The flips are counted and named; none is hidden."""
        run = served(mode)
        tape = run["tape"]
        flips = tape.flips(run["calls"], self.PROMPTS, run["forced"])
        print(f"{mode}: {len(flips)} routing flips over "
              f"{len(tape.jax)} MoE layer calls; JAX margins "
              f"{sorted(round(m, 6) for _, _, m in flips)}")
        assert len(tape.jax) == len(run["calls"]) * self.n_moe()
        assert all(m <= self.FLIP_MARGINS[mode] for _, _, m in flips), flips

    def test_forward_train_aux_matches_jax(self, served_trees):
        """The aux summed over the MoE layers, on JAX's routing
        (replayed); the logits within the dense bound."""
        jcfg, tcfg = self.configs()
        jt, tt = served_trees("dense")
        toks = np.random.RandomState(4).randint(1, jcfg.vocab, (2, 24))
        tape = RoutingTape()
        with tape.record_jax():
            jl, jaux = jax.jit(lambda p, b: jlm.forward_train(p, b, jcfg))(
                jnn.unbox(jt), {"tokens": jnp.asarray(toks)})
            jax.effects_barrier()
        with tape.replay_port():
            tl, taux = tlm.forward_train(tnn.unbox(tt),
                                         {"tokens": torch.from_numpy(toks)},
                                         tcfg)
        assert len(tape.jax) == len(tape.port) == self.n_moe()
        assert set(taux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=AUX_RTOL[k], err_msg=k)
        assert float(taux["lb_loss"]) > 0 and float(taux["dropped_frac"]) > 0
        assert all(m <= self.FLIP_MARGINS["dense"]
                   for _, _, m in tape.flips())
        d = float(np.abs(np.asarray(jl.astype(jnp.float32))
                         - tl.float().numpy()).max())
        assert d <= self.BOUND["dense"], d
