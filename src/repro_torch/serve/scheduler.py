"""Continuous-batching request scheduler (host-side, pure Python).

A copy of ``repro.serve.scheduler``, kept in the port so that the port
imports nothing of ``repro``.

The serving engine holds a fixed number of *slots* — rows of the batched
decode step and of the paged KV cache. Requests queue in FIFO order; a
request is admitted when a slot frees up and evicted the step it finishes.
Decode steps never stall on stragglers: a long request keeps its slot while
short requests cycle through the others (continuous batching).

Request-lifecycle hardening (the fault-tolerance layer, see
``repro_torch.serve.guard``):

  * ``submit`` validates requests up front — empty prompt, prompt longer
    than a cache page, non-positive ``max_new_tokens`` — and rejects with a
    clear ``ValueError`` instead of undefined slot behaviour later.
  * The admission queue is optionally bounded (``max_queue``): a full
    queue raises :class:`AdmissionError` with an explicit reason
    (backpressure/shedding) instead of growing without bound.
  * Requests may carry a deadline (``ttl_steps``, engine steps from
    submission); :meth:`expire` evicts overdue requests — queued or
    running — into the ``expired`` list so one stuck client cannot pin a
    slot forever.
  * Besides FINISHED, a request can end QUARANTINED (its slot produced
    non-finite values or corrupt KV bytes — ``SlotScheduler.quarantine``)
    or EXPIRED (deadline). Terminal requests record ``fail_reason``.

Invariants (checked by ``SlotScheduler.check``):
  * free slots and active slots partition [0, n_slots)
  * every active slot maps to exactly one RUNNING request
  * queued requests are QUEUED and hold no slot
  * finished/quarantined/expired requests are terminal and hold no slot
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["Request", "SlotScheduler", "AdmissionError", "QUEUED", "RUNNING",
           "FINISHED", "QUARANTINED", "EXPIRED", "PREFILL", "DECODE"]

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
QUARANTINED, EXPIRED = "quarantined", "expired"
_TERMINAL = (FINISHED, QUARANTINED, EXPIRED)
PREFILL, DECODE = "prefill", "decode"


class AdmissionError(RuntimeError):
    """A request was rejected at submission (backpressure). ``reason`` is a
    stable machine-readable tag (``queue_full``); the message says what the
    client should do (back off and retry, or raise ``max_queue``)."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class Request:
    """One generation request.

    A running request moves through two phases: **prefill**, while
    ``consumed`` (prompt tokens fed to the model) is short of the prompt —
    the engine feeds up to ``prefill_chunk`` prompt tokens per step — then
    **decode**, where each step appends one sampled token to ``output``
    until ``max_new_tokens`` (or ``eos_id``).

    ``ttl_steps``: optional deadline in engine steps measured from
    ``submit_step``; the scheduler expires the request (queued or running)
    once the deadline passes. ``fail_reason`` records why a request ended
    QUARANTINED or EXPIRED.
    """

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    state: str = QUEUED
    consumed: int = 0               # prompt tokens fed so far
    submit_step: int = 0
    ttl_steps: Optional[int] = None
    admit_step: int = -1
    first_token_step: int = -1      # engine step that sampled output[0]
    finish_step: int = -1
    fail_reason: str = ""

    @property
    def phase(self) -> str:
        """'prefill' while prompt tokens remain to feed, else 'decode'."""
        return PREFILL if self.consumed < len(self.prompt) else DECODE

    @property
    def done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return bool(self.output) and self.output[-1] == self.eos_id

    @property
    def ttft_steps(self) -> int:
        """Engine steps from admission to the first sampled token."""
        if self.first_token_step < 0:
            return -1
        return self.first_token_step - self.admit_step

    def overdue(self, step: int) -> bool:
        """True once ``ttl_steps`` engine steps have passed since submit."""
        return (self.ttl_steps is not None
                and step - self.submit_step >= self.ttl_steps)


class SlotScheduler:
    """FIFO admit / immediate-evict slot scheduler.

    ``max_queue``: bound on waiting requests (None = unbounded, the
    pre-hardening behaviour); a full queue rejects with
    :class:`AdmissionError` (the engine counts these as shed requests).
    ``max_prompt_len``: bound on prompt length (None = unchecked) — the
    engine passes its cache-page capacity so an oversized prompt fails at
    submit instead of corrupting a slot's position track.
    """

    def __init__(self, n_slots: int, max_queue: Optional[int] = None,
                 max_prompt_len: Optional[int] = None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.max_prompt_len = max_prompt_len
        self.free: List[int] = list(range(n_slots))
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.quarantined: List[Request] = []
        self.expired: List[Request] = []
        self._rid = itertools.count()

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               ttl_steps: Optional[int] = None, step: int = 0) -> Request:
        if not prompt:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens}: a request must ask for "
                f"at least one generated token")
        if self.max_prompt_len is not None \
                and len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the cache page "
                f"capacity {self.max_prompt_len}; split the prompt or "
                f"serve with a larger max_len")
        if ttl_steps is not None and ttl_steps < 1:
            raise ValueError(f"ttl_steps={ttl_steps}: deadline must be >= 1 "
                             f"engine step (or None)")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise AdmissionError(
                f"admission queue full ({len(self.queue)}/{self.max_queue} "
                f"waiting): shedding request instead of queueing unbounded "
                f"— back off and retry, or serve with a larger max_queue",
                reason="queue_full")
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      ttl_steps=ttl_steps, submit_step=step)
        self.queue.append(req)
        return req

    def admit(self, step: int = 0) -> List[Request]:
        """Move queued requests into free slots (FIFO). Returns the newly
        admitted requests, each with ``req.slot`` assigned."""
        admitted = []
        while self.queue and self.free:
            req = self.queue.popleft()
            slot = self.free.pop(0)
            req.slot, req.state, req.admit_step = slot, RUNNING, step
            self.active[slot] = req
            admitted.append(req)
        return admitted

    def _release(self, slot: int, step: int, state: str, into: List[Request],
                 reason: str = "") -> Request:
        req = self.active.pop(slot)
        req.state, req.finish_step, req.slot = state, step, None
        req.fail_reason = reason
        self.free.append(slot)
        into.append(req)
        return req

    def evict(self, slot: int, step: int = 0) -> Request:
        """Release a slot; its request is FINISHED and the slot is free."""
        return self._release(slot, step, FINISHED, self.finished)

    def quarantine(self, slot: int, step: int = 0,
                   reason: str = "poisoned") -> Request:
        """Release a slot whose launch produced poisoned values (NaN/Inf
        logits, corrupt KV bytes). The request ends QUARANTINED — it is
        NOT retried (its cache state is unrecoverable) and never joins
        ``finished``; the slot is free for the next admission once the
        engine scrubs its cache rows."""
        return self._release(slot, step, QUARANTINED, self.quarantined,
                             reason=reason)

    def expire(self, step: int) -> List[Request]:
        """Evict every overdue request (deadline ``ttl_steps`` passed since
        submission), queued or running, into ``expired``. Returns them."""
        out = []
        for slot, req in list(self.active.items()):
            if req.overdue(step):
                out.append(self._release(slot, step, EXPIRED, self.expired,
                                         reason="deadline_running"))
        still = deque()
        for req in self.queue:
            if req.overdue(step):
                req.state, req.finish_step = EXPIRED, step
                req.fail_reason = "deadline_queued"
                self.expired.append(req)
                out.append(req)
            else:
                still.append(req)
        self.queue = still
        return out

    def plan_chunks(self, max_chunk: int,
                    token_budget: Optional[int] = None) -> Dict[int, int]:
        """Per-slot token counts for the engine's next step — the
        prefill/decode mixing policy.

        Decode-phase slots always get 1 (their next sampled token is never
        starved by prefill work). Prefill-phase slots split ``token_budget``
        prompt tokens per step (None = unlimited), oldest admission first,
        each receiving up to ``max_chunk`` tokens; the oldest prefilling
        request always receives at least one token even when the budget is
        exhausted (liveness). A slot may be planned 0 tokens (budget
        starvation) — the engine masks it out of the launch entirely."""
        if max_chunk < 1:
            raise ValueError("max_chunk must be >= 1")
        plan: Dict[int, int] = {}
        prefilling = []
        for slot, req in self.active.items():
            if req.phase == DECODE:
                plan[slot] = 1
            else:
                prefilling.append(req)
        prefilling.sort(key=lambda r: (r.admit_step, r.rid))
        remaining = token_budget
        for i, req in enumerate(prefilling):
            want = min(max_chunk, len(req.prompt) - req.consumed)
            if remaining is None:
                give = want
            else:
                give = min(want, remaining)
                if i == 0:
                    give = max(give, 1)          # liveness floor
                remaining = max(0, remaining - give)
            plan[req.slot] = give
        return plan

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

    @property
    def occupancy(self) -> float:
        return len(self.active) / self.n_slots

    def check(self) -> None:
        """Assert the scheduler invariants (used by tests)."""
        assert sorted(self.free + list(self.active)) == sorted(
            set(self.free) | set(self.active)), "slot listed twice"
        assert set(self.free).isdisjoint(self.active), "free ∩ active"
        assert set(self.free) | set(self.active) == set(range(self.n_slots))
        for slot, req in self.active.items():
            assert req.slot == slot and req.state == RUNNING
            assert 0 <= req.consumed <= len(req.prompt), "consumed overran"
        for req in self.queue:
            assert req.slot is None and req.state == QUEUED
            assert req.consumed == 0 and not req.output
        for req in self.finished:
            assert req.slot is None and req.state == FINISHED
        for req in self.quarantined:
            assert req.slot is None and req.state == QUARANTINED
            assert req.fail_reason, "quarantine without a reason"
        for req in self.expired:
            assert req.slot is None and req.state == EXPIRED
            assert req.fail_reason.startswith("deadline")
