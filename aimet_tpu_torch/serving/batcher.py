"""Continuous batching over fixed decode slots — counterpart of
``aimet_tpu/serving/batcher.py`` with its pure-Python scheduler.

A fixed pool of cache slots; pending requests are admitted into free slots
in power-of-two waves with one batched prefill; every engine step decodes
all slots together with per-slot cache positions, in the model's mode
(on the card: the decode attention kernel per layer, and in ``w4`` mode
the fused W_o + MLP kernel); finished requests free their slots at once.
The slot caches are updated in place: admission copies each wave's cache
rows into its slots with ``index_copy_``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .quantized_llm import QuantizedLLM


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, llm: QuantizedLLM, num_slots: int = 4,
                 step_chunk: int = 1):
        """``step_chunk``: decode this many tokens per engine step before
        reading them back on the host (one synchronisation per chunk).
        Admission and slot-freeing happen at chunk boundaries; a request
        that finishes mid-chunk wastes at most ``step_chunk - 1`` slot-steps
        (its extra tokens are discarded, and the stale cache rows are masked
        by the per-slot position when the slot is reused)."""
        self.llm = llm
        self.num_slots = num_slots
        self.step_chunk = max(1, int(step_chunk))
        self.caches = llm.new_caches(num_slots)
        self.positions = np.zeros(num_slots, np.int32)
        self.next_token = np.zeros(num_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self._uid = 0
        self.pending: List[Request] = []

    # -- API ---------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        req = Request(self._uid, list(prompt), max_new_tokens, eos_id)
        self._uid += 1
        self.pending.append(req)
        return req

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def run_until_done(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.pending or self.num_active) and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def step(self) -> bool:
        """Admit pending requests into free slots, then decode
        ``step_chunk`` tokens for every active slot."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        quota = (self._wave_quota(min(len(free), len(self.pending)))
                 if free and self.pending else 0)
        wave = [(slot, self.pending.pop(0)) for slot in free[:quota]]
        if wave:
            firsts = self._prefill_batch([s for s, _ in wave],
                                         [r for _, r in wave])
            for (slot, req), tok in zip(wave, firsts):
                req.generated.append(tok)
                self.slot_req[slot] = req
                self.positions[slot] = len(req.prompt)
                self.next_token[slot] = tok
                self._maybe_finish(slot)

        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        self._consume(self._decode_tokens(), active)
        return True

    # -- internals -----------------------------------------------------------
    def _maybe_finish(self, slot: int):
        req = self.slot_req[slot]
        if req is None:
            return
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and req.generated
                    and req.generated[-1] == req.eos_id)
                or int(self.positions[slot]) >= self.llm.max_len - 1):
            req.done = True
            self.slot_req[slot] = None

    @staticmethod
    def _wave_quota(n: int) -> int:
        """Largest power of two <= n: admission waves come in at most
        log2(num_slots) + 1 batch shapes."""
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _prefill_batch(self, slots: List[int], reqs: List[Request]
                       ) -> List[int]:
        """Admit a wave with one batched prefill: prompts right-padded to
        the wave's longest, rounded up to a multiple of 32 (``lengths``
        keeps the padding out of the KV scales, and the per-slot position
        masks the padded rows until decode overwrites them)."""
        llm = self.llm
        real_max = max(len(r.prompt) for r in reqs)
        maxlen = -(-real_max // 32) * 32
        if maxlen > llm.max_len - 1:     # rounding must not exceed the cache
            maxlen = real_max
        toks = np.zeros((len(reqs), maxlen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt)] = r.prompt
        dev = llm.device
        lengths = torch.tensor([len(r.prompt) for r in reqs], device=dev)
        rows = torch.tensor(slots, device=dev)
        first = self._admit(torch.from_numpy(toks).to(dev), lengths, rows)
        return [int(t) for t in first.cpu()]

    @torch.no_grad()
    def _admit(self, toks, lengths, rows):
        """Wave-cache prefill + first-token argmax, then copy the wave's
        cache rows into the slot caches in place."""
        n = toks.shape[0]
        kc = self.llm.new_caches(n)
        logits, kc = self.llm.prefill(toks, kc, prompt_lengths=lengths)
        first = logits[torch.arange(n, device=toks.device), lengths - 1] \
            .argmax(-1)
        for c, w in zip(self.caches, kc):
            c.k.index_copy_(0, rows, w.k)
            c.v.index_copy_(0, rows, w.v)
            c.k_scale.index_copy_(0, rows, w.k_scale)
            c.v_scale.index_copy_(0, rows, w.v_scale)
        return first

    @torch.no_grad()
    def _decode_tokens(self) -> np.ndarray:
        """``step_chunk`` decode steps on the device, one host read at the
        end. Returns (step_chunk, num_slots) tokens in order."""
        dev = self.llm.device
        tok = torch.from_numpy(self.next_token[:, None].astype(np.int64)).to(
            dev)
        pos = torch.from_numpy(self.positions.copy()).to(dev)
        out = []
        for _ in range(self.step_chunk):
            logits, self.caches = self.llm.decode(tok, self.caches, pos)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok[:, 0])
            pos = pos + 1
        return torch.stack(out).cpu().numpy().astype(np.int32)

    def _consume(self, toks: np.ndarray, active: List[int]):
        """Apply a chunk of generated tokens in order; a request that
        finishes stops taking tokens."""
        alive = set(active)
        for krow in toks:
            if not alive:
                break
            for slot in list(alive):
                req = self.slot_req[slot]
                t = int(krow[slot])
                req.generated.append(t)
                self.positions[slot] += 1
                self.next_token[slot] = t
                self._maybe_finish(slot)
                if self.slot_req[slot] is None:
                    alive.discard(slot)
