"""Request/stream protocol — the service API every layer speaks.

The paper's LLMaaS premise (§2) is that foreground interactions must
not wait behind background agents, so the request path is built around
STREAMS, not return values:

  ``GenerationRequest``  what an app asks for: prompt, budget, sampling
                         (seeded, temperature/top-k — defaults reproduce
                         the old greedy ``np.argmax`` path exactly),
                         optional priority override and deadline.
  ``GenerationStream``   the handle the app holds while the service
                         decodes: iterate tokens as they land, cancel
                         mid-generation, or block on ``result()``.
                         Records TTFT / per-token timestamps — the
                         QoS numbers decode-slice scheduling improves.

``LLMService.begin_call / decode_step / finish_call`` consume a
``GenerationRequest``; ``ServiceRouter`` produces ``GenerationStream``s
and runs generations in bounded decode slices so a newly arrived
foreground request preempts an in-flight background stream
(DESIGN.md §2).  This module is dependency-free bookkeeping: no jax,
no model, importable from any layer.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.analysis.markers import requires_lock
from repro_torch.analysis.runtime import witness_condition

# Priorities live here (not scheduler.py) so requests can name them
# without importing the router; scheduler re-exports for compat.
FOREGROUND = 0
BACKGROUND = 1


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    Defaults (``temperature=0``) reproduce the pre-stream greedy path
    token-for-token: plain ``np.argmax`` over the logits.  With
    ``temperature > 0`` the sampler draws from the (optionally top-k
    truncated) softmax using a per-request ``np.random.default_rng(seed)``
    so a (request, seed) pair is reproducible across runs.
    """
    temperature: float = 0.0
    top_k: int = 0                       # 0 = no truncation
    seed: Optional[int] = None

    def make_sampler(self) -> Callable[[np.ndarray], int]:
        """-> callable(logits) -> token id.  Stateful iff temperature>0
        (owns the request's RNG), so build one per generation."""
        if self.temperature <= 0.0:
            return lambda logits: int(np.argmax(logits))
        rng = np.random.default_rng(self.seed)
        temp, top_k = float(self.temperature), int(self.top_k)

        def sample(logits: np.ndarray) -> int:
            x = np.asarray(logits, np.float64) / temp
            if 0 < top_k < x.size:
                kth = np.partition(x, -top_k)[-top_k]
                x = np.where(x < kth, -np.inf, x)
            x -= x.max()
            p = np.exp(x)
            p /= p.sum()
            return int(rng.choice(x.size, p=p))
        return sample


@dataclass
class GenerationRequest:
    """One generation ask.  ``priority=None`` inherits the submitting
    session's priority; ``deadline`` is an absolute ``time.perf_counter``
    instant used to order same-priority admissions (EDF, then FIFO).

    ``exclusive=True`` asks the router never to share a decode batch:
    the request runs with the engine to itself (it may wait for the
    current batch to drain first).  For latency-critical calls that
    must not see batch-mates' per-step cost."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    priority: Optional[Union[int, str]] = None
    deadline: Optional[float] = None
    exclusive: bool = False


class GenerationStream:
    """Handle for one in-flight generation (producer: the router's
    dispatch; consumer: the app).  Thread-safe; tokens are observable
    as they land, so with a threaded router apps genuinely stream."""

    def __init__(self, ctx_id: int, request: GenerationRequest,
                 clock: Optional[Callable[[], float]] = None):
        # ``clock`` replaces wall time for every QoS timestamp (t_submit,
        # token times, t_done).  The loadgen virtual-clock driver injects
        # a simulation clock here so TTFT/TBT are deterministic in the
        # scenario seed; None keeps wall-clock behavior.
        self._now = clock or time.perf_counter
        self.ctx_id = ctx_id
        self.request = request
        self.t_submit = self._now()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.token_times: List[float] = []
        self.n_preempts = 0                 # times switched out mid-gen
        self._tokens: List[int] = []
        self._cv = witness_condition("requests.stream")
        self._done = False
        self._cancelled = False
        self._cancel_requested = False
        self._error: Optional[BaseException] = None

    # -- producer side (router dispatch) ------------------------------- #
    def push(self, tok: int):
        now = self._now()
        with self._cv:
            self._tokens.append(int(tok))
            self.token_times.append(now)
            if self.t_first_token is None:
                self.t_first_token = now
            self._cv.notify_all()

    @requires_lock("_cv")
    def _finish_locked(self, error: Optional[BaseException],
                       cancelled: bool):
        if self._done:
            return
        self._done = True
        self._cancelled = cancelled
        self._error = error
        self.t_done = self._now()
        self._cv.notify_all()

    def finish(self, error: Optional[BaseException] = None,
               cancelled: bool = False):
        with self._cv:
            self._finish_locked(error, cancelled)

    # -- consumer side -------------------------------------------------- #
    def cancel(self) -> bool:
        """Request cancellation.  Queued: the job never starts; running:
        decoding stops at the next slice boundary and the tokens decoded
        so far stay committed to the context.  Returns False if the
        stream had already finished."""
        with self._cv:
            self._cancel_requested = True
            return not self._done

    @property
    def cancel_requested(self) -> bool:
        with self._cv:
            return self._cancel_requested

    @property
    def done(self) -> bool:
        with self._cv:
            return self._done

    @property
    def cancelled(self) -> bool:
        with self._cv:
            return self._cancelled

    @property
    def error(self) -> Optional[BaseException]:
        with self._cv:
            return self._error

    @property
    def tokens(self) -> List[int]:
        with self._cv:
            return list(self._tokens)

    def __iter__(self) -> Iterator[int]:
        """Yield tokens in decode order, blocking until each lands;
        raises the job's error (if any) after the last token."""
        i = 0
        while True:
            with self._cv:
                while i >= len(self._tokens) and not self._done:
                    self._cv.wait()
                if i < len(self._tokens):
                    tok = self._tokens[i]
                    i += 1
                else:
                    if self._error is not None:
                        raise self._error
                    return
            yield tok

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the generation finishes; -> all decoded tokens
        (a cancelled stream returns the tokens decoded before cancel)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise TimeoutError("generation still running")
            if self._error is not None:
                raise self._error
            return list(self._tokens)

    # -- QoS timestamps -------------------------------------------------- #
    def ttft(self) -> Optional[float]:
        """Time-to-first-token from submission (None until it lands)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def tbt(self) -> List[float]:
        """Inter-token gaps (time-between-tokens), len = n_tokens - 1."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]
