"""Slot-scheduled continuous batching over one decode core (the port of
the JAX package's `repro/serving/scheduler.py`, under the same names).

Production traffic is a stream of ragged requests, not one fixed-shape
batch.  This module turns the plan-gated decode step into a request
server:

  * an **admission queue** (FIFO) of `Request`s;
  * **slots**: the step always runs at a fixed batch of `n_slots` lanes;
    a request joins a free slot, decodes in place, and is evicted on
    EOS / max-tokens — mid-decode — through the step's active-slot mask;
  * **paged KV**: attention caches live in a shared block pool
    (models.model.init_paged_cache); a host-side `BlockAllocator` hands
    fixed-size blocks to slots and reclaims them on eviction, so ragged
    lengths share one step program and one pool;
  * **piggy-backed prefill**: a joining request's prompt tokens stream
    through the *same* decode step, one per engine iteration, while the
    other slots keep generating;
  * a **sync-free token loop**: greedy traffic runs one step ahead of
    the host — step t's greedy tokens stay on the device and feed step
    t+1 through a `torch.where` (device tokens on continuing lanes, host
    prompt tokens elsewhere); the host reads step t's tokens only after
    step t+1 is enqueued, from a non-blocking copy into pinned memory
    behind a CUDA event, never with `.item()` on the critical path.
    Each step's host inputs (tokens, positions, active mask, block
    tables) go to the card as one non-blocking copy from pinned memory.
    Temperature requests need host logits between steps, so they flip
    the engine to synchronous retire;
  * **per-request telemetry**: TTFT, queue wait, decode tokens/s, plus
    engine-level queue depth / slot occupancy / block usage samples and
    a `decode_step_breakdown` (dispatch vs host-fetch vs telemetry time
    per step);
  * **adaptive planning** (optional): an engine given a
    `repro_torch.core.plan_service.PlanService` consults it every step
    at the live operating point (active-slot count, deepest position);
    when the bucket's table differs from the one being served, the engine
    **hot-swaps** the plan — the new plan's step is fetched from
    `DecodeCore.batch_step_for`'s bounded variant cache and warmed with a
    discarded all-inactive call (where a CUDA core captures its graph,
    off the critical decode step), then the step pointer flips;
  * **phase-split gating** (frozen-plan engines): a step whose live slots
    are all still prefilling runs under the prefill-phase table.

On a CUDA core every step replays one CUDA graph per distinct plan
(`decode_executables == 1` frozen, the number of distinct plans
adaptive); the KV pools are updated in place (`kv_donation_ok` is True
once a CUDA step has run, the port's counterpart of the JAX package's
donated cache).  On a CPU core the step runs eagerly.

Temperature sampling draws from a `torch.Generator` seeded by `seed`; it
cannot give the JAX package's `jax.random` draws.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models import period_slots
from ..models.model import init_paged_cache
from .core import DecodeCore, sample_token, token_shape


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus generation settings.

    Telemetry fields (t_*, tokens, ...) are engine-written; times are
    seconds on the engine clock.  `tokens` holds generated token ids
    (ints; audio: (n_codebooks,) int arrays)."""
    rid: Any
    prompt: Any                       # (P,) int32 (audio: (P, nb))
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: int | None = None
    # --- engine-written telemetry ---
    state: str = "new"                # new | queued | running | done
    done_reason: str | None = None    # eos | max_tokens
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None      # first generated token (TTFT ref)
    t_done: float | None = None
    tokens: list = dataclasses.field(default_factory=list)
    first_logits: Any = None          # recorded iff record_logits=True

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


class BlockAllocator:
    """Host-side free list over the paged KV pool's physical blocks.

    Allocation is all-or-nothing per request (the engine reserves the
    request's full horizon at admission, so a running request can never
    hit pool exhaustion mid-decode — admission control is the only
    back-pressure point)."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, -1, -1))
        self._free_set = set(self._free)
        self.peak_in_use = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(blocks)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return blocks

    def free(self, blocks: list[int]) -> None:
        """Return blocks to the pool.  A double-free or an id the pool
        never issued would corrupt the free list (a block could be handed
        to two slots), so both raise — before any mutation, so a bad call
        leaves the allocator untouched."""
        bad = [b for b in blocks
               if not (0 <= b < self.n_blocks) or b in self._free_set]
        if len(set(blocks)) != len(blocks):
            bad.extend(b for b in set(blocks)
                       if blocks.count(b) > 1 and b not in bad)
        if bad:
            raise ValueError(
                f"invalid free of block ids {sorted(set(bad))}: "
                f"double-free or id outside pool [0, {self.n_blocks})")
        self._free.extend(reversed(blocks))
        self._free_set.update(blocks)


class _Slot:
    """Mutable per-slot decode state (host-side only)."""

    def __init__(self, req: Request, blocks: list[int]):
        self.req = req
        self.blocks = blocks
        self.pos = 0          # tokens written into this slot's KV
        self.n_fed = 0        # prompt tokens consumed so far
        self.n_gen = 0        # tokens generated so far (counted at
                              # dispatch; retire attributes them)
        self.last_tok = None  # last retired token (host copy)
        self.dev_feed = False  # next feed comes from the previous
                               # step's on-device greedy tokens
        self.draining = False  # hit max_new_tokens at dispatch: excluded
                               # from further steps, evicted at retire

    @property
    def prefilling(self) -> bool:
        return self.n_fed < self.req.prompt_len

    def next_token(self):
        return (self.req.prompt[self.n_fed] if self.prefilling
                else self.last_tok)


class _InFlight:
    """One dispatched-but-not-retired step (the one-step-deep queue of the
    sync-free token loop): the device logits and greedy tokens, the pinned
    host copy of the tokens and the event behind it, and the records
    deciding which lanes' tokens belong to which requests."""

    __slots__ = ("logits", "greedy", "host", "event", "recs")

    def __init__(self, logits, greedy, host, event, recs):
        self.logits = logits
        self.greedy = greedy
        self.host = host      # pinned (n_slots,) int64, or None on CPU
        self.event = event    # CUDA event after the host copy, or None
        self.recs = recs      # [(lane, slot, is_first, is_final), ...]


class ContinuousBatchingEngine:
    """Request server: admission queue + slot-scheduled continuous
    batching + paged KV, over one `DecodeCore`.

    Every engine iteration (`step()`) advances all active slots by one
    token through the masked decode step: joining requests stream prompt
    tokens (piggy-backed prefill), running requests feed their last
    token, and finished requests leave their slot the moment EOS /
    max-tokens hits — the next queued request takes it on the following
    step."""

    def __init__(self, core: DecodeCore, n_slots: int, max_len: int,
                 block_size: int = 8, n_kv_blocks: int | None = None,
                 seed: int = 0, record_logits: bool = False,
                 plan_service=None, pipeline: bool = True,
                 telemetry_every: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        if core.cfg.family == "vlm":
            raise NotImplementedError(
                "continuous batching does not yet thread per-request "
                "image embeddings through cross-attention slots")
        if plan_service is not None and core.plan_table is None:
            raise ValueError(
                "adaptive planning needs a plan-gated core: build the "
                "DecodeCore with quantize=True so plan tables route the "
                "decode step (an unquantized core ignores verdicts)")
        self.core = core
        self.cfg = core.cfg
        self.device = core.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.record_logits = record_logits
        self.clock = clock
        self.needs_kv = any(s.mixer in ("attn", "mla")
                            for s in period_slots(core.cfg))
        self.max_blocks = max(1, math.ceil(max_len / block_size))
        if n_kv_blocks is None:
            n_kv_blocks = self.max_blocks * n_slots   # full provisioning
        self.allocator = BlockAllocator(n_kv_blocks if self.needs_kv
                                        else 0)
        self.cache = init_paged_cache(core.cfg, core.rc, n_slots,
                                      max(1, n_kv_blocks), block_size,
                                      device=self.device)
        self.block_tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[_Slot | None] = [None] * n_slots
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._t0: float | None = None
        # host -> device inputs: one int32 buffer per step (pos, active,
        # device-feed mask, tokens, block tables), staged through two
        # pinned buffers on a CUDA core
        self._cuda = self.device.type == "cuda"
        # one step's tokens: n_slots rows of `tok_width` ids (audio: one
        # per codebook)
        self.tok_shape = token_shape(core.cfg, n_slots)
        self.tok_width = math.prod(self.tok_shape[2:])
        width = n_slots * (3 + self.tok_width + self.max_blocks)
        self._staging = None
        self._pinned, self._pinned_done = [], []
        self._tok_host = []
        self._n_staged = self._n_fetched = 0
        if self._cuda:
            self._staging = torch.empty(width, dtype=torch.int32,
                                        device=self.device)
            self._pinned = [torch.empty(width, dtype=torch.int32,
                                        pin_memory=True) for _ in range(2)]
            self._pinned_done = [None, None]
            self._tok_host = [torch.empty(n_slots * self.tok_width,
                                          dtype=torch.long, pin_memory=True)
                              for _ in range(2)]
        # sync-free token loop: step t's host fetch overlaps step t+1's
        # dispatch.  Temperature sampling needs host logits before the
        # next feed, so any temperature>0 submit flips the engine to
        # synchronous retire (pipeline=False forces it outright).
        self.pipeline = pipeline
        self.telemetry_every = max(1, telemetry_every)
        self._sync = False
        self._inflight: _InFlight | None = None
        self._device_toks = None      # prev step's greedy (device)
        self.donation_ok: bool | None = None   # in-place cache probe
        # counters + per-step samples (the telemetry block)
        self.completed: list[Request] = []
        self.evictions = 0
        self.steps = 0
        self.queue_depth_samples: list[int] = []
        self.occupancy_samples: list[float] = []
        # decode_step_breakdown accumulators (seconds)
        self.dispatch_s = 0.0
        self.host_fetch_s = 0.0
        self.telemetry_s = 0.0
        # adaptive planning: current plan + hot-swap telemetry
        self.plan_service = plan_service
        self._plan = core.plan_table
        self._step_fn = None          # resolved lazily / on swap
        self._bucket: tuple[int, int] | None = None
        self.bucket_transitions = 0
        self.plan_swaps = 0
        self.swap_latencies_s: list[float] = []
        # phase-split gating (frozen-plan engines only — an attached
        # plan service owns the plan): a step whose live slots are ALL
        # still prefilling runs under the prefill-phase table, any
        # decoding slot makes it a decode-phase step.  Both variants
        # come from the core's bounded variant cache, so steady mixed
        # traffic serves from at most two captured programs.
        self._phase_tables = {"decode": core.plan_table,
                              "prefill": core.prefill_plan_table}
        self._phase = "decode"
        self.phase_switches = 0
        self.phase_steps = {"prefill": 0, "decode": 0}

    # --- admission ------------------------------------------------------

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    def _blocks_needed(self, req: Request) -> int:
        if not self.needs_kv:
            return 0
        return math.ceil((req.prompt_len + req.max_new_tokens)
                         / self.block_size)

    def submit(self, req: Request) -> None:
        """Queue a request (validates it can ever be admitted)."""
        horizon = req.prompt_len + req.max_new_tokens
        if horizon > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt_len + max_new_tokens = "
                f"{horizon} exceeds engine max_len {self.max_len}")
        if self._blocks_needed(req) > self.allocator.n_blocks:
            raise ValueError(
                f"request {req.rid} needs {self._blocks_needed(req)} KV "
                f"blocks; the pool only has {self.allocator.n_blocks}")
        req.prompt = np.asarray(req.prompt, np.int32)
        if req.temperature > 0.0:
            # the pipelined loop feeds on-device greedy tokens; a draw
            # needs host logits before the next feed, so temperature
            # traffic degrades to synchronous retire
            self._sync = True
        req.state = "queued"
        req.t_submit = self._now()
        self.queue.append(req)

    def _reset_slot_state(self, i: int) -> None:
        """Zero the joining slot's O(1) caches (mamba state and conv
        carry) in place: the captured step holds their addresses.
        Attention needs nothing: stale pool blocks are dead by
        construction (per-slot lengths mask them, and freed block ids are
        rewritten before they are read)."""
        for entry in self.cache:
            if "state" in entry:
                entry["state"][:, i].zero_()
                entry["conv"][:, i].zero_()

    def _admit(self) -> None:
        """FIFO admission: the queue head takes the first free slot if
        its full KV horizon fits in the pool (no skipping — head-of-line
        order keeps TTFT fairness); the slot's O(1) state is zeroed
        (`_reset_slot_state`)."""
        for i in range(self.n_slots):
            if not self.queue:
                return
            if self.slots[i] is not None:
                continue
            req = self.queue[0]
            blocks = self.allocator.alloc(self._blocks_needed(req))
            if blocks is None:
                return                      # pool pressure: wait
            self.queue.popleft()
            self.block_tables[i, :] = 0
            if blocks:
                self.block_tables[i, :len(blocks)] = blocks
            self._reset_slot_state(i)
            self.slots[i] = _Slot(req, blocks)
            req.state = "running"
            req.t_admit = self._now()

    # --- the engine iteration -------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def _token_batch(self) -> np.ndarray:
        """The host's token of each slot: (n_slots, tok_width) int32."""
        toks = np.zeros((self.n_slots, self.tok_width), np.int32)
        for i, st in enumerate(self.slots):
            if st is not None:
                tok = st.next_token()
                # a pipelined slot's last token may still be on the
                # device (retired next step); its lane takes the device
                # token in _inputs, so 0 is a dead value
                toks[i] = 0 if tok is None else tok
        return toks

    def _inputs(self, host_toks, pos, active, use_dev):
        """The step's device inputs from host arrays: (tokens (n, 1)
        int64 (audio: (n, 1, nb)), pos (n,) int32, active (n,) bool,
        block_tables (n, max_blocks) int32).  One host-to-device copy
        (non-blocking, from pinned memory on a CUDA core); the token feed
        takes the previous step's on-device greedy token where
        `use_dev`."""
        n, end = self.n_slots, 3 * self.n_slots + host_toks.size
        packed = np.concatenate([
            pos, active.astype(np.int32), use_dev.astype(np.int32),
            host_toks.reshape(-1), self.block_tables.reshape(-1)])
        if self._cuda:
            k = self._n_staged % 2
            self._n_staged += 1
            if self._pinned_done[k] is not None:
                self._pinned_done[k].synchronize()   # its last copy ran
            self._pinned[k].numpy()[:] = packed
            buf = self._staging
            buf.copy_(self._pinned[k], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._pinned_done[k] = done
        else:
            buf = torch.from_numpy(packed.astype(np.int32))
        host = buf[3 * n:end].long().view(self.tok_shape)
        if self._device_toks is not None:
            dev_mask = buf[2 * n:3 * n].bool().view(
                (n,) + (1,) * (host.dim() - 1))
            tokens = torch.where(dev_mask, self._device_toks, host)
        else:
            tokens = host
        return (tokens, buf[:n], buf[n:2 * n].bool(),
                buf[end:].view(n, self.max_blocks))

    def _wait_device(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def _consult_plan_service(self) -> None:
        """Ask the plan service for the current operating point's bucket
        verdicts; hot-swap the decode plan if they differ from the one
        being served (see `_swap_plan`)."""
        n_active = self.active_slots
        max_pos = max(s.pos for s in self.slots if s is not None)
        bucket, table = self.plan_service.lookup(n_active, max_pos)
        if bucket != self._bucket:
            if self._bucket is not None:
                self.bucket_transitions += 1
            self._bucket = bucket
        if table != self._plan:
            self._swap_plan(table)

    def _swap_plan(self, table) -> None:
        """Capture-then-swap: fetch the new plan's step from the core's
        bounded variant cache and warm it with a discarded all-inactive
        call (a CUDA core captures a new variant's graph *here*, between
        steps, never inside a decode step; inactive slots write nothing),
        then flip the step pointer.  The fetch+warm latency is the swap
        latency — near zero when the variant is already captured."""
        t0 = self.clock()
        fn = self.core.batch_step_for(table)
        zeros = np.zeros(self.n_slots, np.int32)
        tokens, pos, active, tables = self._inputs(
            self._token_batch(), zeros, zeros.astype(bool),
            zeros.astype(bool))
        _, self.cache = fn(self.cache, tokens, pos, active, tables)
        self._wait_device()
        self.swap_latencies_s.append(self.clock() - t0)
        self._plan = table
        self._step_fn = fn
        self.plan_swaps += 1

    def _select_phase_table(self) -> None:
        """Per-step phase gating for frozen-plan engines: serve a
        pure-prefill step (every live slot still feeding its prompt)
        under the prefill-phase plan table, anything else under the
        decode table.  A phase flip swaps the step pointer through the
        core's bounded variant cache — each phase's program is captured
        at most once."""
        live = [s for s in self.slots if s is not None and not s.draining]
        phase = ("prefill" if live and all(s.prefilling for s in live)
                 else "decode")
        if phase != self._phase:
            self._phase = phase
            self.phase_switches += 1
            self._plan = self._phase_tables[phase]
            self._step_fn = self.core.batch_step_for(self._plan)
        self.phase_steps[phase] += 1

    @property
    def _pipelined(self) -> bool:
        return self.pipeline and not self._sync

    def step(self) -> bool:
        """One engine iteration.  Returns False when idle (nothing
        active, nothing admissible, nothing in flight).

        Pipelined (the default, greedy traffic): enqueue step *t* on the
        device first, *then* wait for step *t-1*'s tokens — the host
        fetch of one step overlaps the device compute of the next.
        Synchronous (temperature traffic / pipeline=False): dispatch and
        retire the same step."""
        if not self._pipelined and self._inflight is not None:
            self._retire(self._inflight)    # mode flipped: flush first
        t0 = self.clock()
        self._admit()
        if self.steps % self.telemetry_every == 0:
            self.queue_depth_samples.append(len(self.queue))
            self.occupancy_samples.append(self.active_slots / self.n_slots)
        self.telemetry_s += self.clock() - t0
        if not any(s is not None and not s.draining for s in self.slots):
            if self._inflight is not None:
                self._retire(self._inflight)
                return True
            return False
        if self.plan_service is not None:
            self._consult_plan_service()
        elif self._phase_tables["prefill"] is not None:
            self._select_phase_table()
        if self._step_fn is None:
            self._step_fn = self.core.batch_step_for(self._plan)
        prev = self._inflight
        self._inflight = self._dispatch()
        if prev is not None:
            self._retire(prev, keep_inflight=True)
        if not self._pipelined:
            self._retire(self._inflight)
        return True

    def _dispatch(self) -> _InFlight:
        """Enqueue one decode step on the device and account for it.

        All per-slot bookkeeping (pos / fed / generated counts, max-token
        draining) happens here, at dispatch; `_retire` only attributes
        the finished tokens to requests."""
        t0 = self.clock()
        host_toks = self._token_batch()
        pos = np.array([0 if s is None else s.pos for s in self.slots],
                       np.int32)
        active = np.array([s is not None and not s.draining
                           for s in self.slots], bool)
        use_dev = np.array([s is not None and s.dev_feed
                            and not s.prefilling for s in self.slots],
                           bool)
        tokens, pos_t, active_t, tables = self._inputs(host_toks, pos,
                                                       active, use_dev)
        logits, self.cache = self._step_fn(self.cache, tokens, pos_t,
                                           active_t, tables)
        if self._cuda:
            self.donation_ok = True     # the pools were updated in place
        with torch.inference_mode():
            greedy = sample_token(self.cfg, logits, 0.0)
        host = event = None
        if self._cuda:
            host = self._tok_host[self._n_fetched % 2]
            self._n_fetched += 1
            host.copy_(greedy.reshape(-1), non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self._device_toks = greedy
        self.steps += 1
        recs = []
        for i, st in enumerate(self.slots):
            if st is None or st.draining:
                continue
            fed_prompt = st.prefilling
            st.pos += 1
            if fed_prompt:
                st.n_fed += 1
                if st.prefilling:
                    st.dev_feed = False
                    continue        # mid-prompt: sampled token discarded
            st.n_gen += 1
            st.dev_feed = True
            final = st.n_gen >= st.req.max_new_tokens
            if final:
                # final token: stop dispatching this lane now (the KV
                # horizon is exactly spent); the slot is evicted when
                # this step retires
                st.draining = True
            recs.append((i, st, st.n_gen == 1, final))
        self.dispatch_s += self.clock() - t0
        return _InFlight(logits, greedy, host, event, recs)

    def _retire(self, inf: _InFlight, keep_inflight: bool = False) -> None:
        """Wait for one dispatched step's tokens and attribute them:
        append to requests, stamp TTFT, record first-logits (one batched
        transfer for exactly the lanes that produced their first token),
        and evict EOS / max-token slots."""
        if not keep_inflight:
            self._inflight = None
        elif self._inflight is inf:
            self._inflight = None
        t0 = self.clock()
        if inf.event is not None:
            inf.event.synchronize()         # the step and its copy ran
            greedy = inf.host.numpy().reshape(self.n_slots, -1).copy()
        else:
            greedy = inf.greedy.reshape(self.n_slots, -1).numpy().copy()
        first_rows = {}
        if self.record_logits:
            idxs = [i for i, st, first, _ in inf.recs
                    if first and st.req.state != "done"]
            if idxs:
                rows = inf.logits[torch.tensor(idxs), -1].float().cpu()
                first_rows = dict(zip(idxs, rows.numpy()))
        self.host_fetch_s += self.clock() - t0
        now = self._now()
        for i, st, first, final in inf.recs:
            req = st.req
            if req.state == "done":
                continue    # evicted at an earlier retire (EOS lag):
                            # this lane's speculative token is discarded
            tok = self._sample_slot(i, st, inf.logits, greedy)
            st.last_tok = tok
            req.tokens.append(tok)
            if first:
                req.t_first = now
                if i in first_rows:
                    req.first_logits = first_rows[i]
            hit_eos = (req.eos_id is not None
                       and self.cfg.family != "audio"
                       and int(tok) == req.eos_id)
            if hit_eos or final:
                self._evict(i, "eos" if hit_eos else "max_tokens", now)
        if not self._pipelined:
            self._device_toks = None    # sync mode: host tokens only

    def _sample_slot(self, i: int, st: _Slot, logits, greedy):
        """Next token for slot i: the batchwide greedy argmax unless the
        request asked for temperature sampling (then a per-slot draw from
        the engine's torch.Generator — synchronous mode only, see
        `submit`).  An audio token is an (nb,) int32 array, one id per
        codebook."""
        audio = self.cfg.family == "audio"
        if st.req.temperature <= 0.0:
            return greedy[i].copy() if audio else np.int32(greedy[i, 0])
        with torch.inference_mode():
            probs = torch.softmax(logits[i, -1].float()
                                  / st.req.temperature, dim=-1)
            tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=self._gen)[:, 0]
        tok = tok.cpu().numpy().astype(np.int32)
        return tok if audio else np.int32(tok[0])

    def _evict(self, i: int, reason: str, now: float) -> None:
        st = self.slots[i]
        self.allocator.free(st.blocks)
        self.slots[i] = None
        self.evictions += 1
        st.req.state = "done"
        st.req.done_reason = reason
        st.req.t_done = now
        self.completed.append(st.req)

    # --- driving loops ----------------------------------------------------

    def run(self, requests: list[Request],
            arrival_times: list[float] | None = None,
            timeout_s: float = 300.0) -> dict:
        """Drive an open-loop arrival process to completion.

        `arrival_times[i]` is request i's arrival offset (seconds from
        run start) on the engine clock; None submits everything up
        front.  Returns `telemetry()`."""
        self._t0 = None
        t_start = self._now()           # pins the epoch
        target = len(self.completed) + len(requests)
        pending = sorted(zip(arrival_times or [0.0] * len(requests),
                             requests), key=lambda p: p[0])
        while len(self.completed) < target:
            now = self._now()
            if now - t_start > timeout_s:
                raise RuntimeError(
                    f"engine run exceeded {timeout_s}s with "
                    f"{len(pending)} arrivals pending")
            while pending and pending[0][0] <= now:
                self.submit(pending.pop(0)[1])
            if not self.step() and pending:
                # idle until the next arrival is due (open-loop clock)
                time.sleep(min(0.001, max(0.0, pending[0][0]
                                          - self._now())))
        return self.telemetry()

    def drain(self, timeout_s: float = 300.0) -> None:
        """Step until queue + slots are empty."""
        t0 = self._now()
        while self.step():
            if self._now() - t0 > timeout_s:
                raise RuntimeError(f"drain exceeded {timeout_s}s")

    # --- telemetry --------------------------------------------------------

    @property
    def decode_executables(self) -> int | None:
        """Captured programs of the masked batch step (expects exactly 1
        for frozen-plan traffic); None on a CPU core."""
        return self.core.batch_decode_executables

    def telemetry(self) -> dict:
        """Per-request + engine-aggregate serving telemetry (the JAX
        package's keys)."""
        reqs = []
        for r in self.completed:
            # a request can complete without ever generating a token
            # (t_first is None); its latency fields are None and it is
            # excluded from the TTFT percentiles
            decode_s = ((r.t_done - r.t_first)
                        if r.t_first is not None and len(r.tokens) > 1
                        else None)
            reqs.append({
                "rid": r.rid,
                "prompt_len": r.prompt_len,
                "new_tokens": len(r.tokens),
                "done_reason": r.done_reason,
                "queue_wait_s": (r.t_admit - r.t_submit
                                 if r.t_admit is not None else None),
                "ttft_s": (r.t_first - r.t_submit
                           if r.t_first is not None else None),
                "decode_tokens_per_s": (
                    (len(r.tokens) - 1) / decode_s
                    if decode_s and decode_s > 0 else None),
            })
        ttfts = [r["ttft_s"] for r in reqs if r["ttft_s"] is not None]
        total_tokens = sum(r["new_tokens"] for r in reqs)
        t_done = [r.t_done for r in self.completed]
        makespan = max(t_done) if t_done else 0.0
        dts = [r["decode_tokens_per_s"] for r in reqs
               if r["decode_tokens_per_s"]]
        agg = {
            "completed": len(self.completed),
            "evictions": self.evictions,
            "eos_evictions": sum(r["done_reason"] == "eos" for r in reqs),
            "steps": self.steps,
            "total_new_tokens": total_tokens,
            "engine_tokens_per_s": (total_tokens / makespan
                                    if makespan > 0 else None),
            "request_tokens_per_s_mean": (float(np.mean(dts))
                                          if dts else None),
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else None,
            "ttft_p50_s": float(np.percentile(ttfts, 50)) if ttfts
            else None,
            "ttft_p95_s": float(np.percentile(ttfts, 95)) if ttfts
            else None,
            "queue_depth_mean": (float(np.mean(self.queue_depth_samples))
                                 if self.queue_depth_samples else 0.0),
            "queue_depth_max": (int(max(self.queue_depth_samples))
                                if self.queue_depth_samples else 0),
            "slot_occupancy_mean": (float(np.mean(self.occupancy_samples))
                                    if self.occupancy_samples else 0.0),
            "n_slots": self.n_slots,
            "kv_blocks": {"total": self.allocator.n_blocks,
                          "block_size": self.block_size,
                          "peak_in_use": self.allocator.peak_in_use},
            "decode_executables": self.decode_executables,
            "kv_donation_ok": self.donation_ok,
            "phase_gating": {
                "enabled": (self.plan_service is None
                            and self._phase_tables["prefill"] is not None),
                "phase_switches": self.phase_switches,
                "phase_steps": dict(self.phase_steps),
            },
            "decode_step_breakdown": self._step_breakdown(),
        }
        return {"requests": reqs, "aggregate": agg,
                "adaptive": self._adaptive_telemetry()}

    def _step_breakdown(self) -> dict:
        """Where the per-step host budget goes: dispatch (input staging,
        token select, step call, bookkeeping), blocking host fetches
        (tokens / first-logits at retire), and telemetry sampling.
        Pipelined engines overlap the fetch of step t with the compute
        of step t+1, so fetch time here is host *blocked* time."""
        n = max(1, self.steps)
        return {
            "steps": self.steps,
            "pipelined": self._pipelined,
            "dispatch_s": round(self.dispatch_s, 6),
            "host_fetch_s": round(self.host_fetch_s, 6),
            "telemetry_s": round(self.telemetry_s, 6),
            "dispatch_ms_per_step": round(1e3 * self.dispatch_s / n, 4),
            "host_fetch_ms_per_step": round(1e3 * self.host_fetch_s / n,
                                            4),
            "telemetry_ms_per_step": round(1e3 * self.telemetry_s / n,
                                           4),
        }

    def _adaptive_telemetry(self) -> dict | None:
        """The telemetry()["adaptive"] block: bucket transitions, plan
        swaps + latency stats, the core's variant-cache state, and the
        plan service's per-bucket hit/flip counters.  None when the
        engine runs a frozen plan."""
        if self.plan_service is None:
            return None
        lat = self.swap_latencies_s
        return {
            "bucket_transitions": self.bucket_transitions,
            "plan_swaps": self.plan_swaps,
            "swap_latency_s": {
                "count": len(lat),
                "mean": float(np.mean(lat)) if lat else None,
                "max": float(max(lat)) if lat else None,
                "total": float(sum(lat)),
            },
            "plan_variants": self.core.plan_variants,
            "plan_evictions": self.core.plan_evictions,
            "active_plan_digest": (self._plan.digest
                                   if self._plan is not None else None),
            "service": self.plan_service.telemetry(),
        }


# --- synthetic open-loop traffic ------------------------------------------


def synthetic_requests(cfg, n: int, seed: int = 0,
                       prompt_len: tuple[int, int] = (4, 12),
                       new_tokens: tuple[int, int] = (4, 16),
                       temperature: float = 0.0) -> list[Request]:
    """Seeded ragged request set (uniform prompt/output length ranges,
    inclusive; audio prompts (P, n_codebooks)), drawn with numpy's
    RandomState exactly as the JAX package draws it — the same seed
    gives both packages the same requests."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        p = int(rng.randint(prompt_len[0], prompt_len[1] + 1))
        m = int(rng.randint(new_tokens[0], new_tokens[1] + 1))
        shape = ((p, cfg.audio.n_codebooks) if cfg.family == "audio"
                 else (p,))
        prompt = rng.randint(0, cfg.vocab, size=shape).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=m,
                            temperature=temperature))
    return reqs


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> list[float]:
    """Open-loop Poisson arrival offsets (seconds): exponential
    inter-arrivals at `rate` req/s.  rate <= 0 means all-at-once."""
    if rate <= 0:
        return [0.0] * n
    rng = np.random.RandomState(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate, size=n)))
