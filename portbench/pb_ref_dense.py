"""The plain reference of a served dense (GQA, SwiGLU, RoPE) model under
the LLMS service: plain PyTorch, float32 with TF32 off, one layer's
weights converted at a time.  It imports nothing of the program.

``replay`` follows one context through its calls, as the service defines
them, from the benchmark's inputs (the weights, the history and each
call's prompt) and the tokens the program served:

- a call appends its prompt and feeds each served token but the last
  (the last one's K/V row stays zero: the service never feeds it);
- the prompt is one extend padded to its token bucket: the pads (token 0
  at the working cache's last position) are queries over the visible
  keys and enter the Eq.-1 density as the service's extend counts them;
- Eq. 1: an extend adds, per key, the attention it received over heads
  and visible queries divided by their number; a decode step adds the
  key's attention over heads divided by the heads; both averaged over
  layers; every visible key counts one pass;
- at switch-out each chunk whose bits or covered length changed, or that
  is new, is encoded again from the values the next call attends
  (per-channel codes over the chunk, ``pb_codec``), and those values
  become the dequantized ones.

Which bits each chunk takes at a switch-out is the program's choice (its
plan after each call, read from its state): the reference follows it, so
that both attend the same kind of history, and judges the choice apart
against its own Eq.-3 plan (``pb_judge``).  With ``precision="fp8"`` every
product runs on e4m3-rounded operands (rows of activations, columns of
weights, each scaled to its own maximum): the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

import pb_codec

FP8_MAX = 448.0


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, scaled to its maximum along
    ``dim``."""
    s = torch.clamp_min(t.abs().amax(dim=dim, keepdim=True), 1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Arith:
    """The products of one precision: ``fp32`` or the ``fp8`` control."""

    def __init__(self, precision: str):
        assert precision in ("fp32", "fp8"), precision
        self.fp8 = precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _q8(x, -1) @ _q8(w, 0)
        return x @ w

    def op(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """An operand of an attention product."""
        return _q8(t, dim) if self.fp8 else t


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE: x (R, heads, hd) at positions (R,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float64,
                                   device=x.device) * (-math.log(theta) / half))
    ang = (pos.to(torch.float64)[:, None] * freqs).to(torch.float32)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


@dataclass
class Geometry:
    """The service's working-cache geometry (``core/executor.py``)."""
    cs: int
    n_slots: int
    buckets: List[int]
    pad_slot: int

    @classmethod
    def of(cls, chunk_tokens: int, max_ctx_len: int) -> "Geometry":
        n_slots = math.ceil(max_ctx_len / chunk_tokens) * chunk_tokens
        b, buckets = chunk_tokens, []
        while b < n_slots:
            buckets.append(b)
            b *= 2
        buckets.append(n_slots)
        return cls(chunk_tokens, n_slots, buckets,
                   n_slots + buckets[-1] - 1)

    def bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)


@dataclass
class Encoded:
    bits: int
    covered: int
    codes: Dict[str, torch.Tensor]        # leaf -> (T, F) int32
    scales: Dict[str, torch.Tensor]       # leaf -> (F,) fp32


@dataclass
class CallOut:
    logits: torch.Tensor                  # (m, V) fp32: row j scores token j


@dataclass
class RefContext:
    K: torch.Tensor                       # (L, S, KV, hd) fp32, attended
    V: torch.Tensor
    n: int = 0
    dsum: Optional[np.ndarray] = None
    dcnt: Optional[np.ndarray] = None
    enc: Dict[int, Encoded] = field(default_factory=dict)


class DenseReference:
    min_bits = 2        # the family's Eq.-3 floor (its KVSpec)

    def __init__(self, cfg, params, geom: Geometry, precision="fp32"):
        self.cfg, self.params, self.geom = cfg, params, geom
        self.ar = Arith(precision)
        self.dev = params["embed"].device

    def _layer(self, l: int) -> Dict[str, torch.Tensor]:
        return {k: v[l].to(torch.float32)
                for k, v in self.params["layers"].items()}

    def new_context(self) -> RefContext:
        c = self.cfg
        S = self.geom.n_slots + self.geom.buckets[-1]
        shp = (c.n_layers, S, c.n_kv_heads, c.head_dim)
        return RefContext(torch.zeros(shp, device=self.dev),
                          torch.zeros(shp, device=self.dev),
                          dsum=np.zeros(S), dcnt=np.zeros(S))

    # ------------------------------------------------------------------ #
    def call(self, ctx: RefContext, prompt: np.ndarray, served: List[int]
             ) -> CallOut:
        """One call: the prompt's extend, then a decode step for each
        served token but the last.  -> the logits that chose each served
        token (none for a call that serves none)."""
        cfg, ar, dev = self.cfg, self.ar, self.dev
        M, m, n0 = len(prompt), len(served), ctx.n
        feeds = list(served[:-1]) if m else []
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(feeds, np.int64)])
        R = len(toks)
        n_pad = self.geom.bucket(M) - M
        pos = np.arange(n0, n0 + R)
        seq_len = n0 + M
        limit = pos + 1                        # keys a real row sees
        extra = int(n_pad > 0)
        rows_tok = np.concatenate([toks, np.zeros(extra, np.int64)])
        rows_pos = np.concatenate([pos, np.full(extra, self.geom.pad_slot)])
        rows_lim = np.concatenate([limit, np.full(extra, seq_len)])
        S = int(rows_lim.max())
        # the extend's queries: the prompt, and the pads (one row
        # standing for n_pad identical ones)
        ext_w = np.zeros(len(rows_tok))
        ext_w[:M] = 1.0
        if n_pad:
            ext_w[-1] = n_pad
        t_pos = torch.as_tensor(rows_pos, device=dev)
        kidx = torch.arange(S, device=dev)
        vis = kidx[None, :] < torch.as_tensor(rows_lim, device=dev)[:, None]
        w_ext = torch.as_tensor(ext_w, dtype=torch.float32, device=dev)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        G = H // KV
        ext_mass = torch.zeros(S, device=dev)
        dec_mass = torch.zeros((max(len(feeds), 0), S), device=dev)
        x = self.params["embed"][torch.as_tensor(rows_tok, device=dev)
                                 ].to(torch.float32)
        real = slice(0, R)
        for l in range(cfg.n_layers):
            pl = self._layer(l)
            h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
            q, k, v = ar.mm(h, pl["wq"]), ar.mm(h, pl["wk"]), ar.mm(h, pl["wv"])
            if cfg.qkv_bias:
                q, k, v = q + pl["bq"], k + pl["bk"], v + pl["bv"]
            q = rope(q.reshape(-1, H, hd), t_pos, cfg.rope_theta)
            k = rope(k.reshape(-1, KV, hd), t_pos, cfg.rope_theta)
            v = v.reshape(-1, KV, hd)
            ctx.K[l, n0:n0 + R] = k[real]
            ctx.V[l, n0:n0 + R] = v[real]
            keys, vals = ctx.K[l, :S], ctx.V[l, :S]
            s = torch.einsum("rngd,snd->ngrs",
                             ar.op(q.reshape(-1, KV, G, hd)),
                             ar.op(keys)) / math.sqrt(hd)
            s = s.masked_fill(~vis[None, None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("ngrs,snd->rngd", ar.op(p), ar.op(vals, 0))
            x = x + ar.mm(o.reshape(-1, H * hd), pl["wo"])
            h = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
            g = ar.mm(h, pl["w_gate"])
            x = x + ar.mm(g * torch.sigmoid(g) * ar.mm(h, pl["w_up"]),
                          pl["w_down"])
            pk = p.sum(dim=(0, 1))                      # (rows, S) over heads
            nvalid = (w_ext[:, None] * vis).sum(0).clamp_min(1.0)
            ext_mass += (w_ext[:, None] * pk).sum(0) / (H * nvalid)
            if feeds:
                dec_mass += pk[M:R] / H
        L = cfg.n_layers
        self._acc(ctx, ext_mass / L, seq_len)
        for j in range(len(feeds)):
            self._acc(ctx, dec_mass[j] / L, n0 + M + j + 1)
        ctx.n = n0 + M + m
        if not m:
            return CallOut(torch.zeros((0, cfg.vocab), device=dev))
        idx = [M - 1] + list(range(M, R))
        xf = rms_norm(x[idx], self.params["ln_f"].to(torch.float32),
                      cfg.norm_eps)
        if getattr(self, "_head32", None) is None:
            self._head32 = (self.params["embed"].T if cfg.tie_embeddings
                            else self.params["head"]).to(torch.float32)
        return CallOut(ar.mm(xf, self._head32))

    @staticmethod
    def _acc(ctx: RefContext, mass: torch.Tensor, n_visible: int):
        mm = mass.double().cpu().numpy()
        ctx.dsum[:len(mm)] += mm
        ctx.dcnt[:n_visible] += 1

    # ------------------------------------------------------------------ #
    def switch_out(self, ctx: RefContext, bits: Dict[int, int]):
        """Encode every chunk whose bits or covered length changed, or
        that is new, at the given bits; the next call attends its
        dequantized values."""
        cs = self.geom.cs
        for i in range(math.ceil(ctx.n / cs)):
            covered = min(ctx.n - i * cs, cs)
            e = ctx.enc.get(i)
            if e is not None and e.bits == bits[i] and e.covered == covered:
                continue
            codes, scales = {}, {}
            for name, leaf in (("k", ctx.K), ("v", ctx.V)):
                blk = leaf[:, i * cs:(i + 1) * cs]            # (L, T, KV, hd)
                T = blk.shape[1]
                flat = blk.permute(1, 0, 2, 3).reshape(T, -1)
                c, s = pb_codec.quantize(flat, bits[i])
                codes[name], scales[name] = c, s
                deq = pb_codec.dequantize(c, s).reshape(
                    T, blk.shape[0], *blk.shape[2:]).permute(1, 0, 2, 3)
                leaf[:, i * cs:(i + 1) * cs] = deq
            ctx.enc[i] = Encoded(bits[i], covered, codes, scales)

    def load_history(self, ctx: RefContext,
                     values: Dict[int, Dict[str, np.ndarray]]):
        """Put the program's encoded history (``pb_judge.history_values``)
        in place of the reference's own, chunk by chunk, over the
        positions the context holds."""
        cs, L = self.geom.cs, self.cfg.n_layers
        KV, hd = self.cfg.n_kv_heads, self.cfg.head_dim
        for i, leaves in values.items():
            T = min(cs, ctx.n - i * cs)
            if T <= 0:
                continue
            for name, leaf in (("k", ctx.K), ("v", ctx.V)):
                v = torch.from_numpy(np.ascontiguousarray(
                    leaves[name][:T])).to(self.dev)
                leaf[:, i * cs:i * cs + T] = v.reshape(
                    T, L, KV, hd).permute(1, 0, 2, 3)

    def density(self, ctx: RefContext) -> np.ndarray:
        return pb_codec.chunk_density(ctx.dsum, ctx.dcnt, ctx.n, self.geom.cs)
