"""LLMS core of the port: the paged serving path (paper Table 1 API)
and the multi-app router above it.

Public surface:
  scheduler.ServiceRouter / AppSession  (admission, decode slices,
                                         next-context hints, layer 4)
  LLMService / LLMSConfig / LLMCtxStub  (paper Table 1 API, facade)
  requests.GenerationRequest / SamplingParams
  executor.ModelExecutor                (model entries, layer 1)
  context_store.ContextStore            (persistent contexts, layer 2)
  residency.ResidencyEngine             (switch-in/out engine, layer 3)
  chunks.ChunkCodec / CompressedChunk   (chunk memory model, Fig. 4)
  compression.plan_buckets              (tolerance-aware planner, Eq. 3)
  lifecycle.LCTRUQueue                  (eviction order, §3.4)
"""
from repro_torch.core.requests import (  # noqa
    BACKGROUND, FOREGROUND, GenerationRequest, GenerationStream,
    SamplingParams)
from repro_torch.core.service import LLMService, LLMSConfig, LLMCtxStub  # noqa
from repro_torch.core.scheduler import (  # noqa
    AppSession, NextContextPredictor, ServiceRouter, parse_priority)
