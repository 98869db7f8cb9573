"""Serving substrate: prefill + batched greedy decode engine.

Port of ``repro.serve.engine``.  ``make_prefill`` is the forward under the
model's overlap context: with a :class:`~repro_torch.parallel.sharding.TPGroup`
active (``tp_group``) and the ``dma`` backend, its TP MLPs run the
copy-engine uniform-fused-1D path (for an MoE model: its shared experts'
and dense residual FFN's).  ``make_serve_step`` is ONE new token against
the model's cache (K and V per attention layer, the latent and the shared
rope key per MLA layer, the recurrent state of a Mamba, mLSTM or sLSTM
layer, and an encoder-decoder's cross K and V); :class:`DecodeEngine`
adds the minimal batch loop.  Each ``DecodeEngine.run`` starts from the
recurrent layers' initial state, where the reference's engine carries
the state one run leaves into the next (ROADMAP queue C, R7); an
attention cache needs no reset, since each run rewrites its positions
from 0 and masks the rest.
``DecodeEngine.run`` reports the reference's ``serve/run`` and
``serve/step`` spans and ``serve/steps`` and ``serve/tokens`` counters
(:mod:`repro_torch.obs`); its ``adapt=`` hook streams each batch's
request-load digest through the online-adaptation tier
(:class:`repro_torch.serve.adapt.AdaptiveTier`) and records the tuned
overlap schedule, which never changes what the model computes.

Under a group of processes (``tp_group`` of a
:class:`~repro_torch.parallel.group.RankGroup`) both run per rank, as a
``shard_map`` body: the state holds the rank's blocks of the embedding
and unembedding (its vocabulary rows and columns), the attention (its
heads), the MLPs and the experts
(:func:`~repro_torch.parallel.sharding.shard_params` by the model's
``rank_specs``); a prefill whose length the group divides keeps the
residual stream cut by sequence; each attention cache of 1024 positions
or more holds the rank's time slice, and so does an encoder-decoder's
cross K/V cache of 1024 encoder positions or more (:meth:`DecodeEngine.
encode` runs the encoder per rank and fills it).  The model's logits are the rank's
vocabulary block; the prefill and the serve step gather the blocks
(``Model.gather_vocab``, one all-gather), so every rank gets the same
whole logits and tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model, reset_recurrent
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.parallel.context import overlap_context


def make_serve_step(model: Model) -> Callable:
    """(state, cache, tokens (B,1), pos) -> (logits (B, 1, V), cache)."""

    def serve_step(state, cache, tokens, pos):
        with overlap_context(model.config.overlap):
            logits, cache = model.decode_step(state, cache, tokens, pos)
            return model.gather_vocab(logits), cache

    return serve_step


def make_prefill_cross(model: Model) -> Callable:
    """(state, cache, enc_frames (B, S_enc, d)) -> cache with an
    encoder-decoder's cross K/V filled (``Model.prefill_cross``) under the
    model's overlap context: the encoder's MLPs take the FiCCO path as
    the prefill's do."""

    def prefill_cross(state, cache, enc_frames):
        with overlap_context(model.config.overlap):
            return model.prefill_cross(state, cache, enc_frames)

    return prefill_cross


def make_prefill(model: Model) -> Callable:
    """(state, batch) -> logits (B, S, V) over the text tokens; the batch
    carries the stub frontends' ``prefix_embeds`` or ``enc_frames`` where
    the model takes them."""

    def prefill(state, batch):
        with overlap_context(model.config.overlap):
            logits, _ = model.forward(state, batch)
            return model.gather_vocab(logits)

    return prefill


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Tiny batched greedy engine over the serve step.

    Prompts are fed token-by-token through the decode path (prefill via
    decode keeps the engine simple and exercises the cache exactly as the
    dry-run shapes do).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        state,
        *,
        batch_size: int = 4,
        cache_len: int = 128,
        enc_len: int = 0,
        device=None,
        adapt=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.state = state
        self.batch = batch_size
        self.cache_len = cache_len
        # An encoder-decoder's cross K/V hold enc_len encoder positions
        # (a rank's block of them), filled by ``encode`` before run().
        self.cache = self.model.init_cache(
            batch_size, cache_len, enc_len=enc_len, device=self.device
        )
        self.step_fn = make_serve_step(self.model)
        # Online-adaptation tier (repro_torch.serve.adapt.AdaptiveTier):
        # when set, every run() streams its request-load digest through
        # the tier and records the tuned overlap schedule for the batch.
        self.adapt = adapt
        self.last_decision = None

    @torch.no_grad()
    def encode(self, enc_frames) -> None:
        """An encoder-decoder: run the encoder over (B, enc_len, d) frames
        and fill the cache's cross K/V (:func:`make_prefill_cross`), for
        every later :meth:`run`."""
        self.cache = make_prefill_cross(self.model)(
            self.state, self.cache, enc_frames)

    @torch.no_grad()
    def run(self, requests: list[Request]) -> list[Request]:
        if len(requests) > self.batch:
            raise ValueError(
                f"{len(requests)} requests for a batch of {self.batch}"
            )
        # A batch whose requests want zero new tokens (all
        # max_new_tokens=0, or an empty/dummy-pad-only batch) has
        # nothing to emit — skip the decode loop entirely instead of
        # burning max_prompt + max_new steps producing nothing.
        if not any(len(r.out) < r.max_new_tokens for r in requests):
            for r in requests:
                r.done = True
            return requests
        # left-align all prompts; pad batch with a dummy request
        reqs = list(requests) + [
            Request(np.zeros(1, np.int32), 0)
            for _ in range(self.batch - len(requests))
        ]
        max_prompt = max(len(r.prompt) for r in reqs)
        max_new = max((r.max_new_tokens for r in reqs), default=0)
        reset_recurrent(self.model.pattern, self.cache)
        reg = _metrics.get_metrics()
        steps_c = reg.counter("serve/steps")
        tokens_c = reg.counter("serve/tokens")
        overlap_args = {}
        if self.adapt is not None:
            self.last_decision = self.adapt.pick_for_requests(
                requests, self.cfg
            )
            # Surface the batch's overlap decision on the run span so a
            # merged fleet trace reads which schedule served which
            # batch without joining against the audit log.  The hook is
            # duck-typed (tests stub it), so only annotate when the
            # decision actually carries a schedule.
            sched = getattr(self.last_decision, "schedule", None)
            if sched is not None:
                overlap_args = {
                    "overlap_schedule": sched.value,
                    "overlap_tier": self.last_decision.source,
                }
        with _trace.span(
            "serve/run", "serve",
            n_requests=len(requests), batch=self.batch,
            max_prompt=max_prompt, max_new=max_new, **overlap_args,
        ):
            for pos in range(max_prompt + max_new):
                feed = []
                for r in reqs:
                    if pos < len(r.prompt):
                        feed.append(r.prompt[pos])
                    elif r.out:
                        feed.append(r.out[-1])
                    else:
                        feed.append(0)
                tok = torch.as_tensor(
                    np.asarray(feed, np.int64)[:, None], device=self.device
                )
                with _trace.span("serve/step", "serve", pos=pos) as sp:
                    logits, self.cache = self.step_fn(
                        self.state, self.cache, tok, pos
                    )
                    nxt = logits[:, 0].argmax(-1).cpu().numpy()
                    emitted = 0
                    for i, r in enumerate(reqs[: len(requests)]):
                        if (
                            pos >= len(r.prompt) - 1
                            and len(r.out) < r.max_new_tokens
                        ):
                            r.out.append(int(nxt[i]))
                            emitted += 1
                    sp.set(tokens=emitted)
                steps_c.inc()
                tokens_c.inc(emitted)
                if all(
                    len(r.out) >= r.max_new_tokens
                    for r in reqs[: len(requests)]
                ):
                    break
        for r in requests:
            r.done = True
        return requests


__all__ = ["make_serve_step", "make_prefill", "make_prefill_cross",
           "Request", "DecodeEngine"]
