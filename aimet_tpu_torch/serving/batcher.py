"""Continuous batching over fixed decode slots — counterpart of
``aimet_tpu/serving/batcher.py``.

A fixed pool of cache slots; pending requests are admitted into free slots
in power-of-two waves, each request prefilled on its own (so its tokens do
not depend on its wave) and its cache rows copied into its slot in place;
every engine step decodes all slots together with per-slot cache
positions, in the model's mode; finished requests free their slots at
once.

Two engines drive it:

- ``step`` / ``run_until_done``: admit, decode ``step_chunk`` tokens
  eagerly, read them on the host, repeat;
- ``run_pipelined``: the decode carry (next token and position of every
  slot) lives on the device; chunk n + 1 (and any admission before it) is
  enqueued before chunk n's tokens are read, through pinned host memory
  and a CUDA event. On the card a chunk is one replay of a CUDA graph
  captured once per batcher (``_capture_chunk``), the counterpart of the
  JAX package's jitted ``lax.scan``, and a request's admission one replay
  of a graph captured once per padded prompt length; a capture that fails
  raises. On the CPU both run eagerly.

Tokens per request are the same from both engines: each request's greedy
chain depends only on its own prompt and cache rows. The pipelined engine
sees slot frees one chunk late, so a freed slot decodes discarded tokens
for one more chunk (its positions may pass the cache; nothing is written
outside it).

With ``use_native=True`` (the default, as in the JAX package) the
admission queue, slot lifecycle and termination run in the C++ scheduler
(``native/``), built with g++ at first use; a build that fails raises.
``use_native=False`` runs the same state machine in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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
                 use_native: bool = True, step_chunk: int = 1):
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
        # slots admitted by the pipelined engine whose registration waits
        # for the chunk's drain: they must not look free meanwhile
        self._reserved = set()
        self._by_uid: Dict[int, Request] = {}
        self._sched = None
        if use_native:
            from .. import native
            self._sched = native.NativeScheduler(num_slots, llm.max_len)
        # the pipelined engine's device carry, chunk output, host staging
        # and chunk graph (made at first use)
        self._carry = None
        self._graph = None
        self._graph_stream = None
        # the admission's staging cache, first tokens and graphs (by
        # padded prompt length), made at first use
        self._staging = None
        self._firsts = None
        self._admit_graphs = {}
        self.chunk_replays = self.admission_replays = 0

    # -- API ---------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        if self._sched is not None:
            uid = self._sched.submit(len(prompt), max_new_tokens, eos_id)
            req = Request(uid, list(prompt), max_new_tokens, eos_id)
            self._by_uid[uid] = req
            return req
        req = Request(self._uid, list(prompt), max_new_tokens, eos_id)
        self._uid += 1
        self.pending.append(req)
        return req

    @property
    def num_active(self) -> int:
        if self._sched is not None:
            return self._sched.num_active
        return sum(r is not None for r in self.slot_req)

    def run_until_done(self, max_steps: int = 10_000) -> int:
        """The step engine until no request is left; returns its steps."""
        steps = 0
        while self._has_work() and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def step(self) -> bool:
        """Admit pending requests into free slots, then decode
        ``step_chunk`` tokens for every active slot and read them."""
        wave = self._assemble_wave()
        if wave:
            firsts = self._prefill_batch([s for s, _ in wave],
                                         [r for _, r in wave])
            for (slot, req), tok in zip(wave, firsts):
                self.next_token[slot] = tok
                self._register_first(slot, req, tok)
        active = self._active_slots()
        if not active:
            return False
        if self._sched is not None:
            self.next_token[:], self.positions[:] = \
                self._sched.decode_state()
        self._consume(self._decode_tokens(), active, self.positions,
                      self._record_cb())
        return True

    def warm_admission(self, wave_sizes=(1, 2, 4, 8, 16),
                       prompt_len: int = 32, pipelined: bool = False):
        """Run the admission of every wave size (the power-of-two buckets of
        ``_wave_quota``) at ``prompt_len`` once, outside any
        latency-sensitive region; with ``pipelined=True`` the pipelined
        engine's admission, then one chunk on its carry, which captures
        the chunk graph on the card. Writes dummy rows into slot 0's cache
        and garbage rows at the free slots' positions: safe before real
        traffic (the slots are free; an admission rewrites a slot's rows
        up to its prompt, and its position masks the rest)."""
        dummy = [0] * min(prompt_len, self.llm.max_len - 1)
        if pipelined:
            self._ensure_carry()
        for n in wave_sizes:
            if n <= self.num_slots:
                self._admit([0] * n, [dummy] * n, graphs=pipelined)
        if pipelined:
            self._chunk_carry()
        if self.llm.device.type == "cuda":
            torch.cuda.synchronize(self.llm.device)

    def run_pipelined(self, max_steps: int = 10_000) -> int:
        """Drain all requests with the decode chain kept on the device and
        each chunk's token read overlapped with the next chunk's compute:
        chunk n + 1 (and any admission prefill) is enqueued from the device
        carry before chunk n's tokens are read.

        The price is one chunk of scheduling latency: admissions see
        slot-free information one chunk stale, and a freed slot decodes
        discarded tokens for one extra chunk. Tokens per request equal the
        step engine's. Returns the number of chunks dispatched."""
        record = self._record_cb()
        self._ensure_carry()
        self._load_carry()
        inflight = None            # (staged tokens, wave, active slots)
        steps = parity = 0
        while steps < max_steps:
            if inflight is None and not self._has_work():
                break
            wave = self._assemble_wave()
            if wave:
                self._admit_carry([s for s, _ in wave],
                                  [r.prompt for _, r in wave])
            active = self._active_slots()
            if not active and not wave:
                # nothing to decode this round: settle the chunk in flight
                # (its terminations may free work) and look again
                if inflight is not None:
                    self._drain(inflight, record)
                    inflight = None
                    continue
                break
            self._chunk_carry()
            steps += 1
            staged = self._stage(parity, bool(wave))
            parity ^= 1
            if inflight is not None:
                self._drain(inflight, record)
            inflight = (staged, wave, active)
        if inflight is not None:
            self._drain(inflight, record)
        return steps

    # -- the state machine ---------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is None and i not in self._reserved]

    def _active_slots(self) -> List[int]:
        """Slots that decode: with a request, or reserved by an admission
        whose first token is not read yet (the C++ scheduler counts those
        active too). The JAX package's Python path leaves the reserved ones
        out and so drops the second chunk of every request the pipelined
        engine admits."""
        if self._sched is not None:
            return list(self._sched.active_slots())
        return [i for i, r in enumerate(self.slot_req)
                if r is not None or i in self._reserved]

    def _has_work(self) -> bool:
        if self._sched is not None:
            return bool(self._sched.num_pending or self._sched.num_active)
        return bool(self.pending or self.num_active or self._reserved)

    @staticmethod
    def _wave_quota(n: int) -> int:
        """Largest power of two <= n: admission waves come in at most
        log2(num_slots) + 1 batch sizes."""
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _assemble_wave(self):
        """Pending requests for the free slots, as (slot, request) pairs:
        at most the slots free now, bucketed to a power of two."""
        if self._sched is not None:
            sched = self._sched
            free = self.num_slots - sched.num_active
            quota = (self._wave_quota(min(free, sched.num_pending))
                     if free and sched.num_pending else 0)
            wave = []
            for _ in range(quota):
                slot, uid = sched.admit()
                if slot < 0:
                    break
                wave.append((slot, self._by_uid[uid]))
            return wave
        free = self._free_slots()
        quota = (self._wave_quota(min(len(free), len(self.pending)))
                 if free and self.pending else 0)
        wave = [(slot, self.pending.pop(0)) for slot in free[:quota]]
        self._reserved.update(s for s, _ in wave)
        return wave

    def _register_first(self, slot: int, req: Request, tok: int):
        """A request's first token, from its admission's prefill."""
        self._reserved.discard(slot)
        req.generated.append(tok)
        self.slot_req[slot] = req
        self.positions[slot] = len(req.prompt)
        if self._sched is not None:
            if self._sched.start(slot, tok):
                self._finish_native(slot, req)
        else:
            self._maybe_finish(slot)

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

    def _finish_native(self, slot: int, req: Request):
        req.done = True
        self.slot_req[slot] = None
        self._sched.evict(req.uid)       # bound the registries
        self._by_uid.pop(req.uid, None)

    def _record_cb(self):
        """``record(slot, token) -> finished``: the termination rule of the
        scheduler in use."""
        if self._sched is not None:
            def record(slot, t):
                if self._sched.record(slot, t):
                    self._finish_native(slot, self.slot_req[slot])
                    return True
                return False
        else:
            def record(slot, t):
                self._maybe_finish(slot)
                return self.slot_req[slot] is None
        return record

    def _consume(self, toks: np.ndarray, active: List[int], positions_np,
                 record):
        """Apply a chunk of generated tokens (step_chunk, num_slots) in
        order; ``record(slot, tok) -> finished`` owns the termination
        rule, and a finished request takes no more tokens."""
        alive = set(active)
        for krow in toks:
            if not alive:
                break
            for slot in list(alive):
                req = self.slot_req[slot]
                t = int(krow[slot])
                req.generated.append(t)
                positions_np[slot] += 1
                self.next_token[slot] = t
                if record(slot, t):
                    alive.discard(slot)

    # -- admission -----------------------------------------------------------
    def _prefill_into_slot(self, slot: int, req: Request):
        """Admit one request into ``slot`` now (the step engine's state)."""
        tok = self._prefill_llm(req, slot)
        self.next_token[slot] = tok
        self._register_first(slot, req, tok)

    def _prefill_llm(self, req: Request, slot: int) -> int:
        """Prefill one request into ``slot``; returns its first token."""
        return self._prefill_batch([slot], [req])[0]

    def _prefill_batch(self, slots: List[int], reqs: List[Request]
                       ) -> List[int]:
        """Admit a wave eagerly (the step engine); returns the first tokens,
        read on the host."""
        self._admit(slots, [r.prompt for r in reqs])
        firsts = self._firsts.cpu()
        return [int(firsts[s]) for s in slots]

    def _admit_carry(self, slots: List[int], prompts: List[List[int]]):
        """The pipelined engine's admission: on the card one replay of an
        admission graph a request (one graph a padded prompt length,
        captured at first use); the first tokens stay in ``_firsts``."""
        self._admit(slots, prompts, graphs=True)

    def _padded_len(self, n: int) -> int:
        """A prompt's length rounded up to a multiple of 32 (as the JAX
        package pads a wave), unless that passes the cache: a bounded set
        of prefill shapes, one admission graph each."""
        t = -(-n // 32) * 32
        return t if t <= self.llm.max_len - 1 else n

    @torch.no_grad()
    def _admit(self, slots: List[int], prompts: List[List[int]],
               graphs: bool = False):
        """Admit a wave: each request prefilled on its own (``_admit_one``),
        eagerly or, with ``graphs`` on the card, as a graph replay. The
        prompts, right-padded to their own lengths rounded up to 32, their
        lengths and slots reach the device by one copy from pinned host
        memory, which does not wait for the stream.

        A request's prefill does not depend on the rest of its wave: on the
        card the GEMM routes, cuBLAS and PyTorch's reductions choose their
        kernels by the row count, so a prefill batched over the wave gives
        a request other bits in another wave, and a long greedy chain then
        other tokens."""
        self._ensure_admission()
        dev = self.llm.device
        cuda = dev.type == "cuda"
        widths = [self._padded_len(len(p)) for p in prompts]
        buf = torch.zeros((len(prompts), max(widths) + 2), dtype=torch.int64,
                          pin_memory=cuda)
        a = buf.numpy()
        for i, (slot, p) in enumerate(zip(slots, prompts)):
            a[i, :len(p)] = p
            a[i, -2:] = len(p), slot
        buf = buf.to(dev, non_blocking=True)
        for i, t in enumerate(widths):
            toks, meta = buf[i:i + 1, :t], buf[i, -2:]
            if not (graphs and cuda):
                self._admit_one(toks, meta)
                continue
            if t not in self._admit_graphs:
                st_toks, st_meta = toks.clone(), meta.clone()
                body = lambda x=st_toks, m=st_meta: self._admit_one(x, m)
                # the body is idempotent: its warm-up writes what the
                # replay writes
                self._admit_graphs[t] = (self._capture(body, body), st_toks,
                                         st_meta)
            graph, st_toks, st_meta = self._admit_graphs[t]
            st_toks.copy_(toks)
            st_meta.copy_(meta)
            graph.replay()
            self.admission_replays += 1

    def _ensure_admission(self):
        """The admission's device tensors, made once (admission graphs read
        and write them in place): a one-row staging cache and the first
        token of each slot (B,)."""
        if self._staging is None:
            self._staging = self.llm.new_caches(1)
            self._firsts = torch.zeros((self.num_slots,), dtype=torch.int64,
                                       device=self.llm.device)

    def _admit_one(self, toks, meta):
        """One request's admission, all on the device (the body of an
        admission graph): ``toks`` (1, T) its padded prompt, ``meta`` (2,)
        its length and slot. Prefill into the staging cache (the length
        keeps the padding out of the KV scales), the first token by argmax
        at the prompt's last position into ``_firsts[slot]``, the staging
        rows copied into the slot's (rows past the prompt are masked by
        the slot's position until decode overwrites them) and, where the
        pipelined engine has its carry, the slot's next token and
        position."""
        length, slot = meta[0:1], meta[1:2]
        logits, _ = self.llm.prefill(toks, self._staging,
                                     prompt_lengths=length)
        first = logits[0].index_select(0, length - 1).argmax(-1)    # (1,)
        for c, w in zip(self.caches, self._staging):
            c.k.index_copy_(0, slot, w.k)
            c.v.index_copy_(0, slot, w.v)
            c.k_scale.index_copy_(0, slot, w.k_scale)
            c.v_scale.index_copy_(0, slot, w.v_scale)
        self._firsts.index_copy_(0, slot, first)
        if self._carry is not None:
            tok, pos, _, _ = self._carry
            tok.index_copy_(0, slot, first[:, None])
            pos.index_copy_(0, slot, length.to(torch.int32))

    # -- decode ----------------------------------------------------------------
    @torch.no_grad()
    def _decode_tokens(self) -> np.ndarray:
        """The step engine's chunk: ``step_chunk`` eager decode steps on the
        device, one host read at the end. Returns (step_chunk, num_slots)
        tokens in order."""
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

    def _ensure_carry(self):
        """The pipelined engine's device tensors, made once (a chunk graph
        reads and writes them in place): next tokens (B, 1), positions
        (B,), the chunk's tokens (K, B), and two host staging buffers of
        K + 1 rows (the chunk's tokens, then a wave's first tokens), pinned
        on the card."""
        if self._carry is not None:
            return
        dev, B, K = self.llm.device, self.num_slots, self.step_chunk
        pin = dev.type == "cuda"
        self._carry = (
            torch.zeros((B, 1), dtype=torch.int64, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((K, B), dtype=torch.int64, device=dev),
            [torch.zeros((K + 1, B), dtype=torch.int64, pin_memory=pin)
             for _ in range(2)])

    def _load_carry(self):
        """The host's next tokens and positions into the device carry (once
        a run: the carry stays on the device between chunks)."""
        tok, pos, _, _ = self._carry
        tok.copy_(torch.from_numpy(self.next_token[:, None].astype(
            np.int64)))
        pos.copy_(torch.from_numpy(self.positions))

    @torch.no_grad()
    def _chunk_steps(self, tok, pos, out, caches=None):
        """``step_chunk`` decode steps from next tokens ``tok`` (B, 1) at
        positions ``pos`` (B,), both advanced in place, tokens into ``out``
        (K, B): all on the device, nothing read on the host (the body of
        the chunk graph)."""
        caches = self.caches if caches is None else caches
        for k in range(self.step_chunk):
            logits, _ = self.llm.decode(tok, caches, pos)
            nxt = logits[:, -1].argmax(-1)
            out[k].copy_(nxt)
            tok.copy_(nxt[:, None])
            pos.add_(1)

    def _chunk_carry(self) -> torch.Tensor:
        """One chunk on the device carry: on the card one replay of the
        chunk graph (captured at first use), on the CPU eagerly. Returns
        the (K, B) token buffer, rewritten by the next chunk."""
        tok, pos, out, _ = self._carry
        if self.llm.device.type != "cuda":
            self._chunk_steps(tok, pos, out)
            return out
        if self._graph is None:
            self._capture_chunk()
        self._graph.replay()
        self.chunk_replays += 1
        return out

    def _capture(self, warmup, body) -> "torch.cuda.CUDAGraph":
        """Capture ``body`` into a CUDA graph on the batcher's own stream.
        ``warmup`` runs eagerly on that stream first: it makes the
        wrappers' per-stream counters (zeroed) and cached tables outside
        the graph, which then reads them in place. Raises if the capture
        fails; nothing falls back to eager launches."""
        dev = self.llm.device
        if self._graph_stream is None:
            # kept for the batcher's life: its counters are the graphs'
            self._graph_stream = torch.cuda.Stream(dev)
        stream = self._graph_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warmup()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            body()
        return graph

    def _capture_chunk(self):
        """Capture ``_chunk_steps`` on the carry and slot caches. Its
        warm-up runs on copies of the carry (a chunk advances it): it
        writes the cache rows the first replay rewrites, with the same
        bytes."""
        tok, pos, out, _ = self._carry
        self._graph = self._capture(
            lambda: self._chunk_steps(tok.clone(), pos.clone(),
                                      torch.empty_like(out)),
            lambda: self._chunk_steps(tok, pos, out))

    def _stage(self, parity: int, firsts: bool):
        """Copy the chunk's tokens (and, after an admission, every slot's
        first token) into host staging buffer ``parity`` behind the chunk;
        returns (buffer, event or None). Two buffers alternate: a buffer is
        read before the copy two chunks later is enqueued."""
        _, _, out, host = self._carry
        buf, K = host[parity], self.step_chunk
        buf[:K].copy_(out, non_blocking=True)
        if firsts:
            buf[K].copy_(self._firsts, non_blocking=True)
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return buf, event

    def _drain(self, inflight, record):
        """Read a staged chunk (waiting for its event) and apply it: first
        the wave admitted with it, then its tokens."""
        (buf, event), wave, active = inflight
        if event is not None:
            event.synchronize()
        toks = buf.numpy()
        for slot, req in wave:
            self._register_first(slot, req, int(toks[self.step_chunk, slot]))
        # slots admitted with this chunk decoded real tokens (the carry held
        # their first token); slots freed while it was in flight decoded
        # discarded ones and are not recorded (slot_req is None by now)
        act = sorted(s for s in set(active) | {s for s, _ in wave}
                     if self.slot_req[s] is not None)
        self._consume(toks[:self.step_chunk], act, self.positions, record)
