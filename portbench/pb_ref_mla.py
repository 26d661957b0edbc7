"""The plain reference of a served MLA + MoE model (DeepSeek-V2 family)
under the LLMS service's slot engine: plain PyTorch, float32 with TF32
off, one layer's weights converted at a time.  It imports nothing of the
program.

The model, as published: queries of nope + rope head dims, one latent a
token (an RMS-normed ``kv_lora_rank`` vector and a shared roped key),
keys and values up-projected from it per head (computed here in the
equivalent absorbed form), softmax over (q_nope . k_nope + q_pe . k_pe)
/ sqrt(nope + rope); an FFN of routed experts (softmax router, top-k by
iterated argmax, gate weights not renormalized) beside the shared
experts.  The service's configuration adds capacity dispatch: the rows of
one call go through the router in groups of ``group_size``, and an
expert takes at most C = max(4, min(ceil(gs k f / E), gs)) of a group's
choices in the order of the top-k rounds and the rows, the rest dropped
(the pads of a bucket are rows of the group).  A decode step routes one
row alone, where nothing drops.

The slot engine, as the service defines it, and as each call went, from
what the harness saw the program decide (its residency decisions, not
its values: ``pb_cell.Observer``):

- a switch-in either keeps the slot the context parked (nothing
  restored: the next call attends what the last one left) or rebuilds
  it: chunks resident in memory from their payload, missing ones either
  read from disk (its copy, which a recompute at restore does not
  rewrite) or recomputed from their tokens at their positions (the
  whole chunk, holes left out, padded to the token bucket) over the
  restored rest, and then encoded again;
- the call's prompt is one extend padded to its bucket; each served
  token but the last is fed as a decode step;
- at switch-out the chunks the program encoded again are encoded from
  the slot's values, and written to disk.

Every chunk of this family is kept at 8 bits (its Eq.-3 floor).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

import pb_codec
from pb_ref_dense import Arith, CallOut, Encoded, Geometry, rms_norm, rope


@dataclass
class MLAContext:
    ckv: torch.Tensor                 # (L, S, r) the slot's values
    kpe: torch.Tensor                 # (L, S, rope)
    n: int = 0
    dsum: Optional[np.ndarray] = None
    dcnt: Optional[np.ndarray] = None
    mem: Dict[int, Encoded] = field(default_factory=dict)
    disk: Dict[int, Encoded] = field(default_factory=dict)
    holes: set = field(default_factory=set)
    tokens: List[int] = field(default_factory=list)

    @property
    def enc(self):
        return self.mem


def capacity(gs: int, moe) -> int:
    c = math.ceil(gs * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(4, min(c, gs))


class MLAReference:
    min_bits = 8        # the family's Eq.-3 floor (its KVSpec)

    def __init__(self, cfg, params, geom: Geometry, precision="fp32"):
        self.cfg, self.params, self.geom = cfg, params, geom
        self.ar = Arith(precision)
        self.dev = params["embed"].device

    EXPERTS = ("w_gate", "w_up", "w_down")

    def _layer(self, l):
        """Layer l's weights in fp32; the routed experts' stay in their
        served type here and are converted one expert at a time."""
        return {k: v[l] if k in self.EXPERTS else v[l].to(torch.float32)
                for k, v in self.params["layers"].items()}

    def new_context(self) -> MLAContext:
        c, m = self.cfg, self.cfg.mla
        S = self.geom.n_slots + self.geom.buckets[-1]
        z = lambda w: torch.zeros((c.n_layers, S, w), device=self.dev)  # noqa: E731
        return MLAContext(z(m.kv_lora_rank), z(m.qk_rope_head_dim),
                          dsum=np.zeros(S), dcnt=np.zeros(S))

    def _head(self):
        if getattr(self, "_head32", None) is None:
            self._head32 = self.params["head"].to(torch.float32)
        return self._head32

    # ------------------------------------------------------------------ #
    def _moe(self, pl, h: torch.Tensor, groups: Sequence[np.ndarray]):
        """The FFN of rows ``h`` (R, d); each entry of ``groups`` is a set
        of row indices dispatched together (with capacity)."""
        moe, ar, dev = self.cfg.moe, self.ar, self.dev
        E = moe.n_experts
        gates = torch.softmax(ar.mm(h, pl["router"]), dim=-1)     # (R, E)
        rows_k, exp_k, gate_k = [], [], []
        for rows in groups:
            rows = np.asarray(rows)
            gs = min(moe.group_size, len(rows))
            cap = capacity(gs, moe)
            for g0 in range(0, len(rows), gs):
                blk = torch.as_tensor(rows[g0:g0 + gs], device=dev)
                rem = gates[blk].clone()
                count = torch.zeros(E, device=dev)
                for _ in range(moe.top_k):
                    idx = rem.argmax(dim=-1)
                    gk = rem.gather(1, idx[:, None])[:, 0]
                    rem.scatter_(1, idx[:, None], 0.0)
                    onehot = torch.nn.functional.one_hot(idx, E).float()
                    pos = torch.cumsum(onehot, 0) - onehot + count
                    count = count + onehot.sum(0)
                    keep = (pos * onehot).sum(-1) < cap
                    rows_k.append(blk[keep])
                    exp_k.append(idx[keep])
                    gate_k.append(gk[keep])
        rows_k, exp_k, gate_k = (torch.cat(rows_k), torch.cat(exp_k),
                                 torch.cat(gate_k))
        y = torch.zeros_like(h)
        for e in torch.unique(exp_k).tolist():
            sel = exp_k == e
            r = rows_k[sel]
            xe = h[r]
            wg, wu, wd = (pl[n][e].to(torch.float32) for n in self.EXPERTS)
            a = ar.mm(xe, wg)
            o = ar.mm(a * torch.sigmoid(a) * ar.mm(xe, wu), wd)
            y.index_add_(0, r, o * gate_k[sel][:, None])
        a = ar.mm(h, pl["s_gate"])
        return y + ar.mm(a * torch.sigmoid(a) * ar.mm(h, pl["s_up"]),
                         pl["s_down"])

    def _forward(self, ctx: MLAContext, toks: np.ndarray, pos: np.ndarray,
                 limit: np.ndarray, write: np.ndarray, groups,
                 ext_rows: Optional[np.ndarray] = None,
                 dec_rows: Sequence[int] = (), out_rows: Sequence[int] = ()):
        """Rows ``toks`` at ``pos`` through every layer; row r attends the
        keys below ``limit[r]``; rows where ``write`` writes its latents.
        -> (logits of ``out_rows``, the extend's key density over rows
        ``ext_rows``, each of ``dec_rows``' key mass), layer means."""
        cfg, m, ar, dev = self.cfg, self.cfg.mla, self.ar, self.dev
        H, r_, nope, rp = (cfg.n_heads, m.kv_lora_rank, m.qk_nope_head_dim,
                           m.qk_rope_head_dim)
        S = int(limit.max())
        t_pos = torch.as_tensor(pos, device=dev)
        vis = (torch.arange(S, device=dev)[None, :]
               < torch.as_tensor(limit, device=dev)[:, None])
        wr = torch.as_tensor(np.nonzero(write)[0], device=dev)
        wpos = t_pos[wr]
        x = self.params["embed"][torch.as_tensor(toks, device=dev)
                                 ].to(torch.float32)
        ext_mass = torch.zeros(S, device=dev)
        dec_mass = torch.zeros((len(dec_rows), S), device=dev)
        if ext_rows is not None:
            w_ext = torch.zeros(len(toks), device=dev)
            w_ext[torch.as_tensor(ext_rows, device=dev)] = 1.0
            nvalid = (w_ext[:, None] * vis).sum(0).clamp_min(1.0)
        scale = 1.0 / math.sqrt(nope + rp)
        dr = torch.as_tensor(list(dec_rows), dtype=torch.long, device=dev)
        for l in range(cfg.n_layers):
            pl = self._layer(l)
            h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
            q = ar.mm(h, pl["wq"]).reshape(-1, H, nope + rp)
            q_nope, q_pe = q[..., :nope], rope(q[..., nope:], t_pos,
                                               cfg.rope_theta)
            kv = ar.mm(h, pl["w_dkv"])
            ckv = rms_norm(kv[:, :r_], pl["ln_kv"], cfg.norm_eps)
            kpe = rope(kv[:, None, r_:], t_pos, cfg.rope_theta)[:, 0]
            ctx.ckv[l, wpos] = ckv[wr]
            ctx.kpe[l, wpos] = kpe[wr]
            keys_c, keys_p = ctx.ckv[l, :S], ctx.kpe[l, :S]
            w_uk = pl["w_uk"].reshape(r_, H, nope)
            q_abs = torch.einsum("rhn,chn->rhc", q_nope, w_uk)
            s = (torch.einsum("rhc,sc->hrs", ar.op(q_abs), ar.op(keys_c))
                 + torch.einsum("rhp,sp->hrs", ar.op(q_pe), ar.op(keys_p))
                 ) * scale
            s = s.masked_fill(~vis[None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            c = torch.einsum("hrs,sc->rhc", ar.op(p), ar.op(keys_c, 0))
            w_uv = pl["w_uv"].reshape(r_, H, m.v_head_dim)
            o = torch.einsum("rhc,chv->rhv", c, w_uv)
            x = x + ar.mm(o.reshape(len(toks), -1), pl["wo"])
            h = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
            x = x + self._moe(pl, h, groups)
            pk = p.sum(0)                                  # (rows, S)
            if ext_rows is not None:
                ext_mass += (w_ext[:, None] * pk).sum(0) / (H * nvalid)
            if len(dec_rows):
                dec_mass += pk[dr] / H
        L = cfg.n_layers
        logits = None
        if len(out_rows):
            xf = rms_norm(x[list(out_rows)],
                          self.params["ln_f"].to(torch.float32), cfg.norm_eps)
            logits = ar.mm(xf, self._head())
        return logits, ext_mass / L, dec_mass / L

    # ------------------------------------------------------------------ #
    def _pad(self, n: int) -> int:
        return self.geom.bucket(n) - n

    def switch_in(self, ctx: MLAContext, obs: Dict):
        """Rebuild the slot as the program did, unless it kept it."""
        if obs.get("fast", False) or ctx.n == 0:
            if ctx.n == 0:
                ctx.ckv.zero_()
                ctx.kpe.zero_()
            return
        cs = self.geom.cs
        ctx.ckv.zero_()
        ctx.kpe.zero_()
        resident = set(obs["resident"])
        re = sorted(obs.get("recompute", ()))
        for i in sorted(set(ctx.mem) | set(ctx.disk)):
            if i in resident:
                self._insert(ctx, i, ctx.mem[i])
            elif i not in re:
                ctx.mem[i] = ctx.disk[i]
                self._insert(ctx, i, ctx.mem[i])
        if re:
            feed = [p for i in re for p in range(i * cs, (i + 1) * cs)
                    if p not in ctx.holes]
            n_pad = self._pad(len(feed))
            toks = np.array([ctx.tokens[p] if p < len(ctx.tokens) else 0
                             for p in feed] + [0] * n_pad)
            pos = np.array(feed + [self.geom.pad_slot] * n_pad)
            limit = np.minimum(pos + 1, ctx.n)
            write = np.array([True] * len(feed) + [False] * n_pad)
            self._forward(ctx, toks, pos, limit, write, [np.arange(len(toks))])
            for i in re:
                ctx.mem[i] = self._encode(ctx, i, 8)

    def _insert(self, ctx, i, e: Encoded):
        cs = self.geom.cs
        for name, leaf in (("ckv", ctx.ckv), ("kpe", ctx.kpe)):
            vals = pb_codec.dequantize(e.codes[name], e.scales[name])
            leaf[:, i * cs:(i + 1) * cs] = vals.reshape(
                cs, leaf.shape[0], -1).permute(1, 0, 2)

    def _encode(self, ctx, i, bits) -> Encoded:
        cs = self.geom.cs
        codes, scales = {}, {}
        for name, leaf in (("ckv", ctx.ckv), ("kpe", ctx.kpe)):
            blk = leaf[:, i * cs:(i + 1) * cs].permute(1, 0, 2).reshape(cs, -1)
            codes[name], scales[name] = pb_codec.quantize(blk, bits)
        return Encoded(bits, min(ctx.n - i * cs, cs), codes, scales)

    def call(self, ctx: MLAContext, prompt: np.ndarray, served: List[int],
             obs: Dict) -> CallOut:
        self.switch_in(ctx, obs)
        M, m, n0 = len(prompt), len(served), ctx.n
        n_pad = self._pad(M)
        feeds = list(served[:-1]) if m else []
        toks = np.concatenate([np.asarray(prompt, np.int64), np.zeros(n_pad,
                               np.int64), np.asarray(feeds, np.int64)])
        pos = np.concatenate([np.arange(n0, n0 + M),
                              np.full(n_pad, self.geom.pad_slot),
                              np.arange(n0 + M, n0 + M + len(feeds))])
        limit = np.concatenate([np.arange(n0 + 1, n0 + M + 1),
                                np.full(n_pad, n0 + M),
                                np.arange(n0 + M + 1, n0 + M + len(feeds) + 1)])
        write = np.ones(len(toks), bool)
        write[M:M + n_pad] = False
        E = M + n_pad
        groups = [np.arange(E)] + [np.array([E + j]) for j in range(len(feeds))]
        out_rows = ([M - 1] + list(range(E, E + len(feeds)))) if m else []
        logits, ext, dec = self._forward(
            ctx, toks, pos, limit, write, groups, ext_rows=np.arange(E),
            dec_rows=list(range(E, E + len(feeds))), out_rows=out_rows)
        self._acc(ctx, ext, n0 + M)
        for j in range(len(feeds)):
            self._acc(ctx, dec[j], n0 + M + j + 1)
        ctx.tokens.extend(int(t) for t in prompt)
        ctx.tokens.extend(int(t) for t in served)
        ctx.n = n0 + M + m
        if m:
            ctx.holes.add(ctx.n - 1)
            return CallOut(logits)
        return CallOut(torch.zeros((0, self.cfg.vocab), device=self.dev))

    @staticmethod
    def _acc(ctx, mass: torch.Tensor, n_visible: int):
        mm = mass.double().cpu().numpy()
        ctx.dsum[:len(mm)] += mm
        ctx.dcnt[:n_visible] += 1

    def switch_out(self, ctx: MLAContext, bits: Dict[int, int], obs: Dict):
        """Encode the chunks the program encoded again, from the slot's
        values, and write them to disk."""
        for i in sorted(obs["reencoded"]):
            ctx.mem[i] = self._encode(ctx, i, bits[i])
            ctx.disk[i] = ctx.mem[i]

    def density(self, ctx: MLAContext) -> np.ndarray:
        return pb_codec.chunk_density(ctx.dsum, ctx.dcnt, ctx.n, self.geom.cs)
