"""The port's training path against the JAX package's, on the CPU with
``REPRO_PALLAS=jnp``: ``train_step`` at the ``tiny`` preset (SmolLM,
seq 64, batch 2, the Markov stream) with and without QAT against JAX's
jitted ``train_step`` over 3 steps, the first step's gradients, the
layer remat, one step of every family the port serves (a port of
``tests/test_models_smoke.py::test_one_train_step``) and the trainer's
crash and resume.  Weights are JAX's, carried across through numpy.

Bounds, each beside what these cases measure (jax 0.9.0, torch 2.x):

* loss: 1e-3 absolute (measured at most 2.2e-4 over the 3 steps, QAT
  included): the attention rounds its scores in bf16 in JAX's jnp
  lowering and not in the port's (tests/test_torch_flash_attention.py).
* grad norm: 5e-3 relative (measured at most 1.3e-3).
* the first step's gradient, per leaf: relative L2 within 0.05 (measured
  at most 0.017).
* the QAT forward's logits: 0.06 of max |logit|, the serve paths' parity
  bound (measured 0.013).
* every leaf after each step: max |d| within 2.5 x the summed learning
  rate of the steps so far (measured at most 2.0 x): Adam's first steps
  move each weight by about lr times the sign of its gradient, so a
  gradient near 0 whose sign the bf16 noise turns moves it by 2 lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.data.pipeline import DataConfig, SyntheticDataset
from repro.launch.train import build_cfg as jbuild
from repro.models import lm as jlm
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jmake
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

LOSS_ATOL = 1e-3
GNORM_RTOL = 5e-3
GRAD_REL_L2 = 0.05
LEAF_LR_FACTOR = 2.5
OPT = dict(lr=3e-3, warmup_steps=20, total_steps=100)
SERVED = ("smollm_360m", "gemma3_1b", "stablelm_3b", "phi3_medium_14b",
          "olmoe_1b_7b", "deepseek_v2_lite_16b", "rwkv6_7b",
          "jamba_v01_52b", "qwen2_vl_7b")


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    """The JAX side runs its jnp lowering; torch runs one thread beside
    XLA's pool (the two pools oversubscribe the cores and slow these
    small ops by an order of magnitude)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


def _both(arch="smollm_360m"):
    """(JAX cfg, port cfg, JAX params, port params) at ``tiny``."""
    jcfg = jbuild(arch, "tiny")
    boxed = jlm.init(jax.random.PRNGKey(0), jcfg)
    return (jcfg, ttrain.build_cfg(arch, "tiny"), jnn.unbox(boxed),
            tnn.unbox(tnn.params_from_numpy(boxed)))


def _batch(step):
    b = SyntheticDataset(DataConfig(512, 64, 2)).batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("qat", [False, True], ids=["plain", "qat"])
def test_train_step_matches_jax_jit(qat):
    jcfg, tcfg, jp, tp = _both()
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jmake(jcfg, jopt.OptConfig(**OPT), qat=qat))
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**OPT), qat=qat)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert int(ts.step) == int(js.step) == i + 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
        assert abs(float(tm["ce"]) - float(jm["ce"])) <= LOSS_ATOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            GNORM_RTOL * float(jm["grad_norm"])
        assert float(tm["lr"]) == float(jm["lr"])
        lr_sum += float(jm["lr"])
        jl = jax.tree_util.tree_flatten_with_path(jp)[0]
        tl = tnn.tree_flatten_with_path(tp)
        assert len(jl) == len(tl)
        for (jpath, a), (tpath, t) in zip(jl, tl):
            d = np.abs(np.asarray(a, np.float32) - t.float().numpy()).max()
            assert d <= LEAF_LR_FACTOR * lr_sum, (tpath, d, lr_sum)


@pytest.mark.parametrize("qat", [False, True], ids=["plain", "qat"])
def test_first_step_gradients_match_jax(qat):
    jcfg, tcfg, jp, tp = _both()
    jb, tb = _batch(0)

    def loss_of(p):
        logits, aux = jlm.forward_train(p, jb, jcfg, qat=qat)
        return jlm.loss_fn(logits, jb["labels"], aux)

    (jloss, _), jg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jp)
    tloss, _, tg = tts.value_and_grad(tp, tb, tcfg, qat=qat)
    assert abs(float(tloss) - float(jloss)) <= LOSS_ATOL
    jl = jax.tree_util.tree_flatten_with_path(jg)[0]
    tl = tnn.tree_flatten_with_path(tg)
    for (_, a), (tpath, t) in zip(jl, tl, strict=True):
        assert _rel_l2(t.numpy(), a) <= GRAD_REL_L2, tpath


def test_remat_gives_the_same_gradients():
    _, tcfg, _, tp = _both()
    _, tb = _batch(1)
    assert tcfg.remat
    a = tts.value_and_grad(tp, tb, tcfg)
    b = tts.value_and_grad(tp, tb, dataclasses.replace(tcfg, remat=False))
    assert torch.equal(a[0], b[0])
    for x, y in zip(tnn.tree_leaves(a[2]), tnn.tree_leaves(b[2])):
        assert torch.equal(x, y)


def test_qat_forward_matches_jax():
    """``forward_train(qat=True)``: every dense linear fake-quantized, the
    logits within the serve paths' parity bound (0.06 of max |logit|)."""
    jcfg, tcfg, jp, tp = _both("stablelm_3b")     # an untied head too
    jb, tb = _batch(2)
    want = np.asarray(jlm.forward_train(jp, jb, jcfg, qat=True)[0],
                      np.float32)
    with torch.no_grad():
        got = tlm.forward_train(tp, tb, tcfg, qat=True)[0].float().numpy()
        plain = tlm.forward_train(tp, tb, tcfg)[0].float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.06 * scale
    assert np.abs(got - plain).max() > 0          # the fake-quant acts


@pytest.mark.parametrize("arch", SERVED)
def test_one_train_step(arch):
    """Port of ``tests/test_models_smoke.py::test_one_train_step``:
    ``reduced()`` config, one jitless step, finite loss, the step counted
    and the parameters moved."""
    cfg = get_config(arch).reduced()
    params = tnn.unbox(tlm.init(torch.Generator().manual_seed(0), cfg))
    before = [t.clone() for t in tnn.tree_leaves(params)]
    opt_state = topt.init(params)
    step = tts.make_train_step(cfg, topt.OptConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=10))
    toks = torch.randint(1, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(0))
    new_p, new_o, metrics = step(params, opt_state,
                                 {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(new_o.step) == 1
    moved = [float((a - b).abs().max())
             for a, b in zip(before, tnn.tree_leaves(new_p))]
    assert max(moved) > 0


def _run(tmp_path, *extra, steps=8, hist=None):
    args = ["--device", "cpu", "--preset", "tiny", "--seq", "32",
            "--batch", "2", "--steps", str(steps), "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", *extra]
    return ttrain.main(args, on_step=None if hist is None else
                       lambda s, m, dt: hist.append((s, m["loss"])))


def test_trainer_crash_and_resume(tmp_path, capsys):
    """A crash at step 5 exits 42 after the step-4 checkpoint; the resumed
    run replays steps 4-7 with the uninterrupted run's losses, to the
    bit."""
    full, crashed, resumed = [], [], []
    _run(tmp_path / "a", hist=full)
    with pytest.raises(SystemExit) as e:
        _run(tmp_path / "b", "--fail-at-step", "5", hist=crashed)
    assert e.value.code == 42
    assert "injected failure at step 5" in capsys.readouterr().out
    metrics = _run(tmp_path / "b", "--resume", hist=resumed)
    assert "resumed from step 4" in capsys.readouterr().out
    assert [s for s, _ in crashed] == [0, 1, 2, 3, 4]
    assert [s for s, _ in resumed] == [4, 5, 6, 7]
    assert crashed[:4] + resumed == full
    assert metrics["loss"] == full[-1][1]


def test_trainer_options(tmp_path, capsys):
    """--qat and --grad-compress int8 train (finite, other losses than the
    plain run); without --device the trainer wants CUDA."""
    plain = _run(tmp_path / "p", steps=3)
    qat = _run(tmp_path / "q", "--qat", steps=3)
    gc = _run(tmp_path / "g", "--grad-compress", "int8", steps=3)
    for m in (qat, gc):
        assert np.isfinite(m["loss"]) and m["loss"] != plain["loss"]
    assert "final ce=" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--preset", "tiny", "--steps", "1"])


def test_prefill_and_serve_steps():
    """``prefill_step`` / ``serve_step`` (``make_serve_step``): the greedy
    token of the last position of ``forward_prefill`` / ``forward_decode``,
    int32, the cache advanced by one position per step."""
    _, tcfg, _, tp = _both()
    toks = torch.from_numpy(SyntheticDataset(DataConfig(512, 12, 2))
                            .batch(3)["tokens"])
    prefill = tts.make_serve_step(tcfg, kind="prefill")
    decode = tts.make_serve_step(tcfg)
    cache = tnn.unbox(tlm.cache_init(tcfg, 2, 16))
    with torch.no_grad():
        want = tlm.forward_prefill(tp, {"tokens": toks}, tcfg, tnn.unbox(
            tlm.cache_init(tcfg, 2, 16)))[0][:, -1].argmax(-1)
    token, cache = prefill(tp, cache, {"tokens": toks})
    assert token.dtype == torch.int32 and torch.equal(token.long(), want)
    assert cache["pos"].tolist() == [12, 12]
    for i in range(2):
        token, cache = decode(tp, cache, {"token": token[:, None]})
        assert token.shape == (2,) and token.dtype == torch.int32
        assert cache["pos"].tolist() == [13 + i] * 2
