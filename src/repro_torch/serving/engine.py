"""Batched LM serving engine: persistent compiled weights + continuous
batching over fixed decode slots (ports ``repro/serving/engine.py``).

The paper's deployment model is a persistent network: weights compiled
once (``core.compiled_linear``) and kept on the device for the process
lifetime, requests streamed through.  Requests fill a fixed set of decode
slots; a prefill fills one slot's cache, one decode step advances every
slot, and finished slots are refilled.

The JAX engine keeps an LRU of jitted prefill programs, one per length
bucket; eager PyTorch compiles nothing, so the port has no such cache.
The power-of-two bucketing and the ``length`` rewind stay: they decide
what the prefill computes (end-padded prompts, pad rows masked later).
The slot merge writes the prefilled cache into the shared decode cache
in place.

``mode="dense"`` serves the unboxed float tree as it is (each linear a
``torch.matmul`` in bf16, the weights cast per call); there the bucketed
prefill is exact, as nothing couples a row to the pad rows.

An encoder-decoder (Whisper) raises at construction: requests carry no
audio frames here, as in the JAX package; ``lm.forward_prefill`` and
``lm.forward_decode`` serve it.

The engine runs on the card by default (``device="cuda"``) and raises
when CUDA is absent unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.core.compiled_linear import ensure_compiled
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 32
    eos_id: int | None = None
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket_len(L: int, max_seq: int) -> int:
    """Prompt-length bucket: the next power of two (>= 8), capped at the
    engine's max_seq.  End-padding is exact under causal attention
    (lm.forward_prefill)."""
    b = 8
    while b < L:
        b <<= 1
    return min(b, max_seq)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, *, mode: str = "int8",
                 sparsity: float = 0.8, batch_slots: int = 4,
                 max_seq: int = 256, device="cuda"):
        if cfg.encoder_decoder:
            # as in the JAX package, whose engine builds prefill batches
            # without ``frames``
            raise ValueError(
                f"{cfg.name}: the serving engine takes no encoder frames; "
                f"serve an encoder-decoder through lm.forward_prefill (a "
                f"batch with 'frames' and 'tokens', a cache from "
                f"lm.cache_init(S_enc=...)) and lm.forward_decode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.slots = batch_slots
        self.max_seq = max_seq
        # a boxed training tree compiles where it lives; a compiled tree
        # passes through; either way the weights then move to the device
        self.params = nn.to_device(ensure_compiled(params, mode, sparsity),
                                   self.device)
        self.cache = nn.unbox(lm.cache_init(cfg, batch_slots, max_seq,
                                            device=self.device))
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * batch_slots
        # bucketed (end-padded) prefill is exact only when every mixer is
        # causal attention (recurrent states would see the pad tokens)
        self._bucket_prefill = all(sig["kind"] == "attn"
                                   for sig in cfg.layer_sigs())

    # -- request management --------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) > self.max_seq:
            # _prefill_one writes all L prompt tokens into a (1, bucket)
            # buffer whose bucket is capped at max_seq
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the engine's "
                f"max_seq={self.max_seq}; truncate the prompt or build "
                f"the engine with a larger max_seq")
        if len(req.prompt) + req.max_new_tokens - 1 > self.max_seq:
            # decode token i lands at cache position L + i - 2: past
            # max_seq it would overrun the cache
            raise ValueError(
                f"prompt length {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} - 1 exceeds max_seq="
                f"{self.max_seq}; the decode budget would overrun the "
                f"cache — shorten one or raise max_seq")
        self.queue.append(req)

    @staticmethod
    def _check_done(req: Request) -> bool:
        """Token budget spent, or the latest token is EOS."""
        if (len(req.tokens_out) >= req.max_new_tokens or
                (req.eos_id is not None and req.tokens_out and
                 req.tokens_out[-1] == req.eos_id)):
            req.done = True
        return req.done

    def _prefill_one(self, slot: int, req: Request):
        """Prefill one request into batch slot ``slot``: a batch-1 cache,
        then merged into the shared decode cache.  Attention-only stacks
        end-pad the prompt to its power-of-two bucket and pass the true
        length (lm.forward_prefill)."""
        L = len(req.prompt)
        bucket = _bucket_len(L, self.max_seq) if self._bucket_prefill else L
        cache1 = nn.unbox(lm.cache_init(self.cfg, 1, self.max_seq,
                                        device=self.device))
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :L] = np.asarray(req.prompt, np.int64)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if bucket != L:
            batch["length"] = torch.tensor([L], dtype=torch.int32)
        logits, cache1 = lm.forward_prefill(self.params, batch, self.cfg,
                                            cache1)
        req.tokens_out.append(int(torch.argmax(logits[0, -1])))
        _merge_slot_cache(self.cache, cache1, slot)

    def step(self):
        """Admit queued requests into free slots, then one decode step.
        A request done right after its prefill (budget 1, or EOS) frees
        its slot before any decode step."""
        for slot in range(self.slots):
            while self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                self._prefill_one(slot, req)
                if not self._check_done(req):
                    self.active[slot] = req
        if not any(self.active):
            return False
        last = np.zeros((self.slots, 1), np.int64)
        for slot, req in enumerate(self.active):
            if req is not None and req.tokens_out:
                last[slot, 0] = req.tokens_out[-1]
        logits, self.cache = lm.forward_decode(
            self.params, {"token": torch.from_numpy(last).to(self.device)},
            self.cfg, self.cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.tokens_out.append(int(nxt[slot]))
            if self._check_done(req):
                self.active[slot] = None
        return True

    def run(self, requests):
        for r in requests:
            self.submit(r)
        while self.queue or any(self.active):
            self.step()
        return requests


def _merge_slot_cache(batch_cache, one_cache, slot: int):
    """Copy a batch-1 cache tree into slot ``slot`` of the batch cache,
    in place, with the JAX engine's rules: batch-leading leaves (dim 0 ==
    slots) get the row written; scalar counters take the max; stacked
    (layers-leading) leaves apply the same rules one axis in."""
    if isinstance(batch_cache, dict):
        for k in batch_cache:
            batch_cache[k] = _merge_slot_cache(batch_cache[k], one_cache[k],
                                               slot)
        return batch_cache
    if isinstance(batch_cache, list):
        return [_merge_slot_cache(f, o, slot)
                for f, o in zip(batch_cache, one_cache)]
    full, one = batch_cache, one_cache
    if one.ndim == 0:
        return torch.maximum(full, one)
    if full.shape[0] != one.shape[0]:          # batch-leading leaf
        full[slot:slot + 1] = one.to(full.dtype)
        return full
    if one.ndim == 1:                          # stacked scalar counters
        return torch.maximum(full, one)
    # stacked-layer leaf, or a batch-leading one when there is one slot
    # (dims 0 agree): JAX's dynamic_update_slice one axis in, whose start
    # is clamped so that the row fits
    start = min(slot, full.shape[1] - one.shape[1])
    full[:, start:start + one.shape[1]] = one.to(full.dtype)
    return full
