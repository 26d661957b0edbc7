"""What decides ``correct``: the program's outputs held against the
plain reference, number by number, each against its limit.

The program's side is what it served and what it left behind: each
call's tokens, and per context its Eq.-1 density sums, its chunks' bits
after every call, and the codes and scales of the chunks it keeps in
memory.  The reference replays each sampled context from the inputs
(``pb_ref_dense``) and reads the program's outputs only to judge them:

- ``max_gap_sigma``: over every served token compared, how far its
  reference logit lies below the reference's best, in standard
  deviations of the reference logits at that position (greedy
  decoding: the program should serve the reference's best, or a token
  within rounding of it);
- ``density_dev``: the largest gap between the program's Eq.-1 chunk
  densities and the reference's after a context's first call (its
  history's extend, ``attn_density``'s own output before any code or
  served token enters it), over the mean reference density (an
  unmeasured chunk, +inf, must be unmeasured on both sides);
- ``plan_mismatch``: the share of chunks whose final bits differ from
  the Eq.-3 plan the reference solves from the program's own densities
  (an exact check of the planner);
- ``code_dev``: the mean gap between the codes of the program's
  in-memory chunks and the reference's codes of the same chunk, as a
  share of the code range (qmax): a code off by one step at 8 bits, as
  rounding leaves many, weighs 1/127 of one off by one at 2 bits;
- ``scale_dev``: the largest median relative gap of a chunk's
  per-channel scales;
- counts: served tokens compared (at least the limit), calls that
  failed or never finished (none).

The control is the reference computed in fp8 in the program's place
(``subject_from_reference``), read by the same numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

import pb_codec


@dataclass
class CallRec:
    prompt: np.ndarray
    served: List[int]
    bits: Dict[int, int]               # the program's plan after the call
    in_window: bool = False
    obs: Dict = field(default_factory=dict)   # its residency decisions
    density: Optional[np.ndarray] = None      # chunk densities after it
    # the program's payload of each chunk after the call's switch-out:
    # the history the context's next call attends
    history: Dict[int, object] = field(default_factory=dict)


@dataclass
class Subject:
    """One side's outputs for one context."""
    chosen: List[List[int]]            # per call, the tokens it chose
    density: np.ndarray                # chunk densities after call 1
    bits: np.ndarray                   # final plan
    codes: Dict[int, Dict[str, np.ndarray]] = field(default_factory=dict)
    scales: Dict[int, Dict[str, np.ndarray]] = field(default_factory=dict)
    code_bits: Dict[int, int] = field(default_factory=dict)
    own_density: Optional[np.ndarray] = None   # the final ones


def history_values(history: Dict[int, object]
                   ) -> Dict[int, Dict[str, np.ndarray]]:
    """The program's encoded history as the next call attends it: per
    chunk and leaf (T, F) fp32, codes times scales rounded to bf16 as
    the program's dequantize writes its pages (16-bit payloads: their
    values).  The reference takes it in place of its own at the start
    of each call (``pb_ref_dense.DenseReference.load_history``)."""
    out = {}
    for i, cc in history.items():
        if getattr(cc, "bits", None) not in (16, 8, 4, 2) or not hasattr(
                cc, "n_tokens"):
            continue
        leaves = {}
        for n, (p, sc) in cc.data.items():
            if cc.bits == 16:
                v = np.asarray(p, np.float32)
            else:
                v = (pb_codec.unpack(p, cc.bits, cc.n_tokens).astype(
                    np.float32) * np.asarray(sc, np.float32))
                v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
            leaves[n] = v
        out[i] = leaves
    return out


def program_subject(calls: List[CallRec], ctx, cs: int) -> Subject:
    """The program's outputs for one context, read from its state after
    the window: what it served, its densities, its plan and its
    in-memory payloads (unpacked here)."""
    D = pb_codec.chunk_density(ctx.density_sum, ctx.density_cnt,
                               ctx.n_tokens, cs)
    bits = np.array([ctx.chunks[i].bits for i in range(len(D))])
    own = D
    codes, scales, code_bits = {}, {}, {}
    for i, cc in ctx.payload.items():
        if getattr(cc, "bits", None) not in (8, 4, 2) or not hasattr(
                cc, "n_tokens") or getattr(ctx.chunks[i], "quant", False):
            continue
        codes[i] = {n: pb_codec.unpack(p, cc.bits, cc.n_tokens)
                    for n, (p, _) in cc.data.items()}
        scales[i] = {n: np.asarray(s, np.float32)
                     for n, (_, s) in cc.data.items()}
        code_bits[i] = cc.bits
    return Subject([list(c.served) for c in calls], calls[0].density, bits,
                   codes, scales, code_bits, own)


@dataclass
class Readings:
    gaps: List[float] = field(default_factory=list)
    density: List[float] = field(default_factory=list)
    mismatch: List[float] = field(default_factory=list)
    codes_diff: float = 0.0
    codes_n: int = 0
    scale: List[float] = field(default_factory=list)

    def numbers(self) -> Dict[str, float]:
        return {
            "max_gap_sigma": max(self.gaps) if self.gaps else math.inf,
            "density_dev": max(self.density) if self.density else math.inf,
            "plan_mismatch": (max(self.mismatch) if self.mismatch
                              else math.inf),
            "code_dev": (self.codes_diff / self.codes_n if self.codes_n
                         else math.inf),
            "scale_dev": max(self.scale) if self.scale else math.inf,
            "tokens_compared": float(len(self.gaps)),
            # not held to a limit: read beside the others by control.py
            "mean_gap_sigma": (float(np.mean(self.gaps)) if self.gaps
                               else math.inf),
            "miss_share": (float(np.mean(np.asarray(self.gaps) > 0))
                           if self.gaps else math.inf),
        }


def read_context(rd: Readings, logits: List[torch.Tensor], sub: Subject,
                 ref_first: np.ndarray, ref_density: np.ndarray, ref_enc,
                 min_bits: int) -> None:
    """Fold one context's comparison into ``rd``.  ``logits``: the
    reference's per call (m, V); ``ref_first`` / ``ref_density``: its
    chunk densities after the first call and at the end; ``ref_enc``:
    its last encoding of each chunk (``pb_ref_dense.Encoded``)."""
    for lg, chosen in zip(logits, sub.chosen):
        if not chosen:
            continue
        best = lg.max(dim=-1).values
        sd = lg.std(dim=-1)
        got = lg[torch.arange(len(chosen)), torch.as_tensor(
            chosen, device=lg.device)]
        rd.gaps.extend(((best - got) / sd).tolist())
    Dr, Ds = ref_first, sub.density
    if len(Dr) != len(Ds) or np.any(np.isinf(Dr) != np.isinf(Ds)):
        rd.density.append(math.inf)
    else:
        fin = np.isfinite(Dr)
        scale = float(np.mean(Dr[fin])) if fin.any() else 1.0
        rd.density.append(float(np.max(np.abs(Ds[fin] - Dr[fin]) / scale,
                                       initial=0)))
    rd.mismatch.append(float(np.mean(
        pb_codec.plan(sub.own_density, min_bits=min_bits) != sub.bits)))
    for i, leaves in sub.codes.items():
        e = ref_enc.get(i)
        if e is None or e.bits != sub.code_bits[i]:
            continue
        for n, c in leaves.items():
            rc = e.codes[n].cpu().numpy()
            rd.codes_diff += float(np.abs(rc - c).sum()) / pb_codec.qmax(
                e.bits)
            rd.codes_n += rc.size
            rs = e.scales[n].cpu().numpy()
            rel = np.abs(sub.scales[i][n] - rs) / np.maximum(rs, 1e-6)
            rd.scale.append(float(np.median(rel)))


def subject_from_reference(logits: List[torch.Tensor], first: np.ndarray,
                           density: np.ndarray, enc, min_bits: int
                           ) -> Subject:
    """A replay (the fp8 control) as a subject: its greedy choices, its
    densities, its own Eq.-3 plan and its codes."""
    chosen = [lg.argmax(dim=-1).tolist() for lg in logits]
    codes = {i: {n: c.cpu().numpy() for n, c in e.codes.items()}
             for i, e in enc.items()}
    scales = {i: {n: s.cpu().numpy() for n, s in e.scales.items()}
              for i, e in enc.items()}
    return Subject(chosen, first, pb_codec.plan(density, min_bits=min_bits),
                   codes, scales, {i: e.bits for i, e in enc.items()},
                   density)


def verdict(numbers: Dict[str, float], limits: Dict[str, Dict]) -> bool:
    """Each number within its limit: ``max`` numbers at or below, ``min``
    numbers at or above."""
    ok = True
    for name, lim in limits.items():
        v = numbers.get(name, math.nan)
        if "max" in lim:
            ok &= bool(v <= lim["max"])
        if "min" in lim:
            ok &= bool(v >= lim["min"])
    return ok
