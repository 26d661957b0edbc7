"""KNOWN-BAD reproduction of the old executor's family string dispatch.

Before the KVSpec redesign, core/executor.py gated chunked caches and
recompute on the family NAME (the old :121/:201 gates below), so every
new model family meant editing the executor, the residency engine, and
the init_cache kwarg forks in lockstep.  The family checker must flag
every one of these shapes (family/string-dispatch)."""


class OldExecutor:
    def __init__(self, model, cfg):
        self.model = model
        self.cfg = cfg

    def init_cache(self, mixed_quant=False):
        mc = self.model.cfg
        # old executor.py:121 — chunked cache only for the families the
        # author remembered to list
        if mc.family in ("dense", "moe", "mla_moe", "vlm"):
            chunked = True
        else:
            chunked = False
        # old executor.py:201 — quant-resident fork keyed by name
        if mc.family == "mla_moe" and mixed_quant:
            return self._latent_cache()
        if mc.family != "rwkv6":
            return self._kv_cache(chunked)
        return self._state_cache()

    def can_recompute(self):
        fam = self.model.cfg.family
        return fam not in ("rwkv6", "rglru_hybrid", "encdec")

    def _latent_cache(self):
        return {}

    def _kv_cache(self, chunked):
        return {"chunked": chunked}

    def _state_cache(self):
        return {}
