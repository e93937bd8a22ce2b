"""LM assembly from an ``ArchConfig``: attention, Mamba and RWKV blocks
with a dense, MoE or RWKV channel-mix FFN (ports ``repro/models/lm.py``).

Layers group into (prefix, periodic template x n_groups, suffix) exactly
as in the JAX package, and the template's parameters and caches carry a
leading ``layers`` axis, so the two packages' trees match leaf for leaf.
JAX scans the template (with remat); the port runs it as a Python loop
over that axis, on views of the stacked tensors.

Ported: GQA stacks (SmolLM, Gemma3, StableLM, Phi-3) and MLA stacks
(DeepSeek-V2-Lite, with its dense first layer in the prefix) with dense
or MoE FFNs (OLMoE, models/moe.py; ``moe_pattern`` mixes both in one
template), sliding-window layers, the recurrent mixers of
models/ssm.py (RWKV-6 with its channel-mix FFN; Mamba, which Jamba
interleaves with attention and the MoE), the full forward
(``forward_train``, with QAT, the per-layer remat, and the MoE aux summed
over the layers) and its loss (``loss_fn``), prefill (with the serving
engine's bucketed ``length`` path for attention-only stacks) and decode,
on compiled or dense (float) weight leaves, M-RoPE (Qwen2-VL: a batch
may carry ``positions`` (3, B, T); else the text positions fill all
three streams) and the int8 KV cache (``cache_init(kv_dtype=torch.int8)``).
The encoder-decoder raises ``NotImplementedError`` (ROADMAP A8).

Cache counters (``length``, ``pos``) live on the host; ``k``/``v`` (MLA:
``c_kv``/``k_rope``) live with the parameters and are written in place
(models/attention.py); a recurrent layer's state (Mamba ``conv``/``ssm``,
RWKV ``tm``/``cm``) is replaced by the new one at every call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.core.compiled_linear import apply_linear
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, embed_init, ffn, ffn_init,
                                       layernorm, layernorm_init, lm_head,
                                       lm_head_init, rmsnorm, rmsnorm_init)

_A8 = "is not ported (ROADMAP A8)"


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------

def _sig_key(sig):
    return (sig["kind"], bool(sig["moe"]), sig["attn_type"])


def group_layers(sigs):
    """-> (n_prefix, period, n_groups, n_suffix) covering the layer list."""
    n = len(sigs)
    keys = [_sig_key(s) for s in sigs]
    best = None
    for pre in range(0, 3):
        for suf in range(0, 3):
            m = n - pre - suf
            if m <= 0:
                continue
            for p in range(1, min(m, 8) + 1):
                if m % p:
                    continue
                mid = keys[pre:n - suf]
                if all(mid[i] == mid[i % p] for i in range(m)):
                    cand = (pre, p, m // p, suf)
                    # prefer fewer unrolled layers, then smaller period
                    score = (pre + suf, p)
                    if best is None or score < best[0]:
                        best = (score, cand)
                    break
    assert best is not None, "no periodic grouping found"
    return best[1]


# ---------------------------------------------------------------------------
# Single block (mixer + FFN/MoE)
# ---------------------------------------------------------------------------

def _norm_init(gen, cfg, d=None):
    d = d or cfg.d_model
    return (rmsnorm_init(gen, d) if cfg.norm == "rmsnorm"
            else layernorm_init(gen, d))


def _norm(p, x, cfg):
    return (rmsnorm(p, x, cfg.norm_eps) if cfg.norm == "rmsnorm"
            else layernorm(p, x, cfg.norm_eps))


def _check_ported(cfg: ArchConfig):
    if cfg.encoder_decoder:
        raise NotImplementedError(f"the encoder-decoder {_A8}")


def block_init(gen, cfg: ArchConfig, sig, cross=False):
    _check_ported(cfg)
    if cross:
        raise NotImplementedError(f"cross-attention blocks {_A8}")
    p = {"ln1": _norm_init(gen, cfg)}
    if sig["kind"] == "attn":
        p["mixer"] = (attn.mla_init if cfg.mla else attn.gqa_init)(gen, cfg)
    elif sig["kind"] == "mamba":
        p["mixer"] = ssm_mod.mamba_init(gen, cfg)
    elif sig["kind"] == "rwkv":
        p["mixer"] = ssm_mod.rwkv6_init(gen, cfg)
    else:
        raise ValueError(sig)
    p["ln2"] = _norm_init(gen, cfg)
    if sig["moe"]:
        p["ffn"] = moe_mod.moe_init(gen, cfg)
    elif sig["kind"] == "rwkv":
        p["ffn"] = rwkv_cm_init(gen, cfg)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff,
                            gated=cfg.act in ("silu", "gelu"))
    if cfg.post_block_norm:
        p["post_ln1"] = _norm_init(gen, cfg)
        p["post_ln2"] = _norm_init(gen, cfg)
    return p


def rwkv_cm_init(gen, cfg):
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": nn.param(gen, (d,), ("embed",), scale=0.5),
        "mu_r": nn.param(gen, (d,), ("embed",), scale=0.5),
        "wk": nn.linear_param(gen, d, dff, ("embed", "ffn_in")),
        "wr": nn.linear_param(gen, d, d, ("embed", "embed_out")),
        "wv": nn.linear_param(gen, dff, d, ("ffn_in", "embed")),
    }


def rwkv_cm(p, x, state=None, qat=False):
    """RWKV channel-mix with token shift; returns (y, new_shift).  The
    shift arithmetic stays in x's dtype (bf16 in the LM), as in JAX."""
    if state is not None:
        prev = torch.cat([state.to(x.dtype), x[:, :-1]], dim=1)
    else:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    new_shift = x[:, -1:]
    xk = x + (prev - x) * p["mu_k"].to(x.dtype)
    xr = x + (prev - x) * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(apply_linear(p["wk"], xk, qat)))
    r = ssm_mod.sigmoid(apply_linear(p["wr"], xr, qat))
    return r * apply_linear(p["wv"], k, qat), new_shift


def block_cache_init(cfg, sig, B, S_max, cross=False, kv_dtype=None,
                     device="cpu"):
    _check_ported(cfg)
    if sig["kind"] == "attn":
        spec = attn.mla_cache_spec if cfg.mla else attn.gqa_cache_spec
        return spec(cfg, B, S_max, kv_dtype or torch.bfloat16, device)
    if sig["kind"] == "mamba":
        return ssm_mod.mamba_state_spec(cfg, B, device)
    return {"tm": ssm_mod.rwkv6_state_spec(cfg, B, device),
            "cm": nn.Param(torch.zeros((B, 1, cfg.d_model),
                                       dtype=torch.bfloat16, device=device),
                           ("batch", None, "embed_s"))}


def block_apply(p, x, cfg, sig, positions, cache=None, cross_kv=None,
                qat=False, decode=False, causal=True):
    """Returns (x, new_cache, aux).  ``cache`` None: no state; given with
    decode=False: prefill (written from position 0; a recurrent state
    starts from zero); with decode=True: one decode step.  ``qat``
    fake-quantizes every dense linear (``apply_linear``)."""
    aux = {"lb_loss": 0.0, "z_loss": 0.0, "dropped_frac": 0.0}
    h = _norm(p["ln1"], x, cfg)
    new_cache = None
    if sig["kind"] == "attn":
        if cfg.mla:
            out, new_cache = attn.mla_forward(p["mixer"], h, cfg, positions,
                                              cache=cache, qat=qat)
        else:
            window = cfg.window if sig["attn_type"] == "local" else None
            out, new_cache = attn.gqa_forward(p["mixer"], h, cfg, positions,
                                              window=window, causal=causal,
                                              cache=cache, cross_kv=cross_kv,
                                              qat=qat)
    elif sig["kind"] == "mamba":
        out, st = ssm_mod.mamba_forward(
            p["mixer"], h, cfg, state=cache if decode else None, qat=qat)
        new_cache = st if cache is not None else None
    else:  # rwkv
        tm_state = cache["tm"] if (cache is not None and decode) else None
        out, tm_new = ssm_mod.rwkv6_forward(p["mixer"], h, cfg,
                                            state=tm_state, qat=qat)
    if cfg.post_block_norm:
        out = _norm(p["post_ln1"], out, cfg)
    x = x + out
    h2 = _norm(p["ln2"], x, cfg)
    if sig["moe"]:
        y, aux = moe_mod.moe_forward(p["ffn"], h2, cfg, qat=qat)
    elif sig["kind"] == "rwkv":
        cm_state = cache["cm"] if (cache is not None and decode) else None
        y, cm_new = rwkv_cm(p["ffn"], h2, state=cm_state, qat=qat)
        if cache is not None:
            new_cache = {"tm": tm_new, "cm": cm_new}
    else:
        y = ffn(p["ffn"], h2, act=cfg.act, qat=qat)
    if cfg.post_block_norm:
        y = _norm(p["post_ln2"], y, cfg)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig):
    """Boxed parameter tree, on the device of ``gen``."""
    if cfg.encoder_decoder:
        raise NotImplementedError(f"the encoder-decoder {_A8}")
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model),
              "final_norm": _norm_init(gen, cfg)}
    if not cfg.tie_embeddings:
        params["head"] = lm_head_init(gen, cfg.d_model, cfg.vocab)
    sigs = cfg.layer_sigs()
    pre, period, groups, suf = group_layers(sigs)
    params["prefix"] = [block_init(gen, cfg, sigs[i]) for i in range(pre)]
    params["template"] = [
        nn.vmap_init(lambda g, j=j: block_init(g, cfg, sigs[pre + j]), gen,
                     groups)
        for j in range(period)]
    params["suffix"] = [block_init(gen, cfg, sigs[pre + groups * period + i])
                        for i in range(suf)]
    return params


def cache_init(cfg: ArchConfig, B: int, S_max: int, S_enc: int | None = None,
               kv_dtype=None, device="cpu"):
    """Decode cache tree (Param-boxed, like the JAX package's): ``k``/``v``
    on ``device``, the ``length`` and ``pos`` counters on the host.
    ``kv_dtype=torch.int8`` stores every attention layer's KV cache as
    int8 codes with per-(token, head) bf16 scales ``k_s``/``v_s``."""
    if cfg.encoder_decoder:
        raise NotImplementedError(f"the encoder-decoder {_A8}")
    pos = nn.Param(torch.zeros((B,), dtype=torch.int32), ("batch",))
    sigs = cfg.layer_sigs()
    pre, period, groups, suf = group_layers(sigs)

    def one(i):
        return block_cache_init(cfg, sigs[i], B, S_max, kv_dtype=kv_dtype,
                                device=device)

    return {
        "prefix": [one(i) for i in range(pre)],
        "template": [_stack_caches([one(pre + j) for _ in range(groups)])
                     for j in range(period)],
        "suffix": [one(pre + groups * period + i) for i in range(suf)],
        "pos": pos,
    }


def _stack_caches(caches: list):
    first = caches[0]
    if isinstance(first, dict):                # RWKV nests {tm: {...}, cm}
        return {k: _stack_caches([c[k] for c in caches]) for k in first}
    return nn.Param(torch.stack([c.value for c in caches]),
                    ("layers",) + first.axes, first.kind)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _positions(cfg, batch, B, T, offset=None):
    """(B, T) int32 positions on the host; under M-RoPE (3, B, T): the
    batch's ``positions`` as given, else the text positions (plus
    ``offset`` in decode) in all three streams."""
    if cfg.pos == "mrope" and "positions" in batch:
        return torch.as_tensor(batch["positions"])
    base = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    if offset is not None:
        base = base + offset[:, None]
    if cfg.pos == "mrope":
        return base[None].expand(3, B, T)
    return base


def _layer(tree, g: int):
    """Layer ``g`` of a stacked subtree (views; markers pass through)."""
    return nn.tree_map(lambda a: a[g] if isinstance(a, torch.Tensor)
                       else a, tree)


def _restack(stacked, per_layer: list):
    """A stacked cache from its layers' new caches: leaves written in
    place (views of the stacked tensor) keep the stacked tensor; the
    rest (the new ``length`` counters, the recurrent states) stack
    anew."""
    if isinstance(stacked, dict):
        return {key: _restack(full, [c[key] for c in per_layer])
                for key, full in stacked.items()}
    in_place = all(v.data_ptr() == stacked[g].data_ptr()
                   and v.shape == stacked[g].shape
                   for g, v in enumerate(per_layer))
    return stacked if in_place else torch.stack(per_layer)


def _run_stack(params, x, cfg, sigs_info, positions, cache=None,
               cross_kv=None, qat=False, decode=False, causal=True,
               remat=False):
    """Prefix blocks, the template looped over its layers axis, suffix
    blocks.  ``remat`` (training: no cache) recomputes each template
    layer in the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` of the scan
    body does; the prefix and suffix run as they are, as in JAX."""
    pre, period, groups, suf = sigs_info["grouping"]
    sigs = sigs_info["sigs"]
    aux_sum = {"lb_loss": 0.0, "z_loss": 0.0, "dropped_frac": 0.0}
    new_cache = {"prefix": [], "suffix": []} if cache is not None else None

    def run_one(p, x, sig, c):
        return block_apply(p, x, cfg, sig, positions, cache=c,
                           cross_kv=cross_kv, qat=qat, decode=decode,
                           causal=causal)

    def run_layer(p, x, sig):          # (x, aux) of one cacheless layer
        x, _, aux = run_one(p, x, sig, None)
        return x, aux

    for i in range(pre):
        c = cache["prefix"][i] if cache is not None else None
        x, nc, aux = run_one(params["prefix"][i], x, sigs[i], c)
        aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
        if cache is not None:
            new_cache["prefix"].append(nc)

    new_layers = [[] for _ in range(period)]
    layers = [nn.unstack(params["template"][j], groups)
              for j in range(period)]
    for g in range(groups):
        for j in range(period):
            p_g = layers[j][g]
            if remat:
                x, aux = checkpoint(run_layer, p_g, x, sigs[pre + j],
                                    use_reentrant=False)
                nc = None
            else:
                c = _layer(cache["template"][j], g) if cache is not None \
                    else None
                x, nc, aux = run_one(p_g, x, sigs[pre + j], c)
            aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
            new_layers[j].append(nc)
    if cache is not None:
        new_cache["template"] = [_restack(cache["template"][j],
                                          new_layers[j])
                                 for j in range(period)]

    for i in range(suf):
        li = pre + groups * period + i
        c = cache["suffix"][i] if cache is not None else None
        x, nc, aux = run_one(params["suffix"][i], x, sigs[li], c)
        aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
        if cache is not None:
            new_cache["suffix"].append(nc)
    return x, new_cache, aux_sum


def _grouping_info(cfg):
    sigs = cfg.layer_sigs()
    return {"sigs": sigs, "grouping": group_layers(sigs)}


def _logits(params, x, cfg, qat=False):
    x = _norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return lm_head(None, x, tied_embed=params["embed"]["table"])
    return lm_head(params["head"], x, qat=qat)


def _embed_tokens(params, tokens, cfg):
    x = embed(params["embed"], tokens.long()).to(torch.bfloat16)
    if cfg.post_block_norm:  # gemma-style embed scaling
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(x.dtype).to(x.device)
    return x


def forward_train(params, batch, cfg: ArchConfig, qat=False):
    """-> (logits, aux): every position's logits, no cache.  ``aux`` is
    the MoE aux (``lb_loss``, ``z_loss``, ``dropped_frac``) summed over
    the layers, zero for a dense stack, as the JAX package gives it.
    ``qat`` fake-quantizes every dense linear but the tied head (INT7
    forward, straight-through gradient).  With ``cfg.remat`` (the
    default) each template layer is recomputed in the backward pass, as
    JAX rematerialises its scanned layers: under autograd the attention
    forward then runs twice per layer and step."""
    if cfg.encoder_decoder:
        raise NotImplementedError(f"the encoder-decoder {_A8}")
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    positions = _positions(cfg, batch, B, T).to(x.device)
    x, _, aux = _run_stack(params, x, cfg, _grouping_info(cfg), positions,
                           qat=qat, remat=cfg.remat)
    return _logits(params, x, cfg, qat), aux


def forward_prefill(params, batch, cfg: ArchConfig, cache):
    """Prompt ingestion: returns (last-token logits, filled cache).

    ``batch`` may carry a ``length`` (B,) int32 of true prompt lengths
    beside ``tokens`` end-padded to a bucketed width (the serving engine
    pads to powers of two).  Causal attention makes the pad suffix
    invisible to every real position, so the bucketed prefill is exact
    when all rows share one length — the engine's B=1 path: logits are
    gathered at position length-1 and every cache ``length`` counter is
    rewound to the true length, which decode masking then honours.  The
    counters are batch-shared scalars (per-row lengths live in ``pos``),
    as in the JAX package.
    """
    if cfg.encoder_decoder:
        raise NotImplementedError(f"the encoder-decoder {_A8}")
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    # the JAX package constrains x's sharding here (distributed/sharding
    # ``shard``), a no-op without a mesh; the port has no mesh
    positions = _positions(cfg, batch, B, T).to(x.device)
    info = _grouping_info(cfg)
    x, new_cache, _ = _run_stack(params, x, cfg, info, positions,
                                 cache=cache, decode=False)
    length = batch.get("length")
    if length is None:
        new_cache["pos"] = torch.full((B,), T, dtype=torch.int32)
        logits = _logits(params, x[:, -1:], cfg)
    else:
        length = torch.as_tensor(length, dtype=torch.int32).cpu().reshape(B)
        new_cache["pos"] = length
        new_cache = _rewind_lengths(new_cache, int(length.max()))
        idx = (length - 1).long().to(x.device)
        last = x[torch.arange(B, device=x.device), idx][:, None]
        logits = _logits(params, last, cfg)
    return logits, new_cache


def _rewind_lengths(cache, length: int):
    """Clamp every attention-cache ``length`` counter to the true prompt
    length: a bucketed prefill writes pad-token KV at positions >= length,
    and decode masks keys by ``pos < length``, so the clamp makes the pad
    rows unreachable (the next decode step overwrites the first one)."""
    if isinstance(cache, dict):
        return {k: (torch.clamp_max(v, length) if k == "length"
                    else _rewind_lengths(v, length))
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [_rewind_lengths(v, length) for v in cache]
    return cache


def forward_decode(params, batch, cfg: ArchConfig, cache):
    """One decode step: token (B, 1) + cache -> (logits, cache)."""
    if cfg.encoder_decoder:
        raise NotImplementedError(f"the encoder-decoder {_A8}")
    token = batch["token"]
    B = token.shape[0]
    x = _embed_tokens(params, token, cfg)
    positions = _positions(cfg, batch, B, 1,
                           offset=cache["pos"]).to(x.device)
    info = _grouping_info(cfg)
    x, new_cache, _ = _run_stack(params, x, cfg, info, positions,
                                 cache=cache, decode=True)
    new_cache["pos"] = cache["pos"] + 1
    return _logits(params, x, cfg), new_cache


def loss_fn(logits, labels, aux=None, z_coef=1e-4, lb_coef=1e-2):
    """Causal-LM cross entropy (next token) + MoE aux losses: the mean
    over positions of ``logsumexp(logits) - logits[target]`` in f32, as
    the JAX package computes it.  Returns (total, metrics)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long().to(logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    total = ce
    metrics = {"ce": ce}
    if aux is not None:
        total = total + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
        metrics.update(aux)
    return total, metrics
