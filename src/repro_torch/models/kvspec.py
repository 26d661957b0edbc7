"""KVSpec — the declarative per-family cache adapter (DESIGN.md §2).

Every model family publishes one :class:`KVSpec` via
``ModelBase.kv_spec()``.  The serving layers (``core/executor.py``,
``core/residency.py``, ``core/pagepool.py``) consume ONLY this spec:
no ``supports_*`` class booleans, no ``family == "dense"`` string
dispatch, no per-family ``init_cache`` kwarg forks.  A family joins the
service by describing its cache, not by being special-cased:

* ``seq_leaves`` + ``leaf_dims`` describe the token-indexed cache
  arrays the chunk codec slices along ``TOKEN_AXIS`` (dense ``k/v``,
  MLA latent ``ckv/kpe``, ...).
* ``state_leaves`` describe constant-size recurrent state (RWKV6
  ``wkv/tm/cm``, rglru ``conv/lru``, enc-dec cross blocks): whole-state
  snapshot/restore, charged to the same byte budget as chunks.
* capability bits (``chunkable``, ``recomputable``, ``batched_decode``,
  ``quant_resident``, ``paged``, ``pipelined_restore``) replace the old
  executor/residency family gates one-for-one.
* ``tolerance_class`` + ``min_bits`` feed the Eq.-3 switch-out planner:
  the planner never compresses a chunk below the family's floor (MLA
  latents and VLM image chunks carry no cross-head redundancy, so they
  stop at 8-bit where dense K/V may drop to 4/2).

The spec is immutable and cheap to build (no params needed), so
``registry.family_spec(cfg)`` is the capability-query surface for
tools, tests, and the router.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

# canonical cache layout names accepted by ``ModelBase.init_cache``
LAYOUT_WINDOW = "window"        # plain bf16 (or int8+scale) ring cache
LAYOUT_MIXED = "mixed"          # bf16 window + int8 quant-resident leaves


@dataclass(frozen=True)
class KVSpec:
    """Declarative cache/capability descriptor for one model family."""

    family: str
    # token-indexed cache leaves, sliced by ChunkCodec along TOKEN_AXIS
    seq_leaves: Tuple[str, ...] = ()
    # per-leaf trailing dims after (layers, batch, seq), e.g.
    # {"k": (n_kv_heads, head_dim)} or {"ckv": (kv_lora_rank,)}
    leaf_dims: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    # constant-size (token-count-independent) state leaves, handled by
    # whole-state snapshot/restore (WholeStateCodec)
    state_leaves: Tuple[str, ...] = ()
    # the executor can serve this family (it has a recompute/extend
    # entry usable as the prefill-append path)
    servable: bool = False
    # cache can be sliced into chunk payloads (LCTRU-managed tier)
    chunkable: bool = False
    # residency may REBUILD missing/corrupt chunks from resident text
    # (restore planning Eq. 4, fault recovery) — distinct from servable
    recomputable: bool = False
    # [B,1] batched decode entry exists and is token-identical to serial
    batched_decode: bool = False
    # 8-bit chunks may stay int8 in the working cache (mixed layout)
    quant_resident: bool = False
    # may decode over the unified paged KV pool
    paged: bool = False
    # restore may overlap chunk IO with recompute (Eq. 4 pipeline)
    pipelined_restore: bool = False
    # bucket-padding the prefill with dummy tokens is harmless (pure
    # KV families).  False for recurrent state: a pad token would be
    # folded into the carried state, so extends run at exact length.
    pad_safe: bool = True
    # cache layouts init_cache accepts; requesting anything else is a
    # clean ValueError
    layouts: Tuple[str, ...] = (LAYOUT_WINDOW,)
    # Eq.-3 planner class: "kv" (redundant dense K/V), "latent"
    # (MLA compressed latents), "image" (VLM cross-attention image
    # tokens), "state" (recurrent state — never chunk-quantized)
    tolerance_class: str = "kv"
    # compression floor (bits) the tolerance planner must respect
    min_bits: int = 2
    # init_cache clamps seq to cfg.max_seq (learned-position decoders)
    clamp_to_max_seq: bool = False
    # decode/prefill emit the Eq.-1 attention-density statistic
    density: bool = True
    # an int8(+scale) serving-cache variant exists for dry-run A/Bs
    int8_serving: bool = False
    # the §4 streaming long-context window applies to this family
    streaming_long: bool = False

    def __post_init__(self):
        if self.chunkable and not self.seq_leaves:
            raise ValueError(
                f"KVSpec({self.family}): chunkable requires seq_leaves")
        if self.servable and not (self.seq_leaves or self.state_leaves):
            raise ValueError(
                f"KVSpec({self.family}): servable requires cache leaves")
        if self.quant_resident and LAYOUT_MIXED not in self.layouts:
            raise ValueError(
                f"KVSpec({self.family}): quant_resident requires the "
                f"'{LAYOUT_MIXED}' layout")
        if self.paged and not (self.chunkable and self.batched_decode):
            raise ValueError(
                f"KVSpec({self.family}): paged requires chunkable + "
                "batched_decode")
        if self.pipelined_restore and not (self.chunkable
                                           and self.recomputable):
            raise ValueError(
                f"KVSpec({self.family}): pipelined_restore requires "
                "chunkable + recomputable")
        missing = [n for n in self.seq_leaves if n not in self.leaf_dims]
        if missing:
            raise ValueError(
                f"KVSpec({self.family}): leaf_dims missing {missing}")
