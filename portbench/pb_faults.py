"""Faults planted under the timed path, for the test that sees ``correct``
come out false (``tests/test_portbench_faults.py``).  Each takes the
``pb_cell.Cell`` just set up and breaks the program underneath it for
the window; none is used by a benchmark run.

- ``state_unchanged``: a decode step leaves the cache as it was (its new
  K/V or latent row is never written);
- ``token_altered``: every fifth token the service samples is replaced
  where it is produced.
"""
from __future__ import annotations


def state_unchanged(cell):
    import repro_torch.models.common as common
    import repro_torch.models.dense as dense
    common.ring_update = lambda cache, new, pos, ring=False: cache
    dense.scatter_token = lambda *a, **k: None


def token_altered(cell):
    svc = cell.svc
    begin = svc.begin_call
    vocab = cell.cfg.vocab

    def begin_call(stub, request):
        st = begin(stub, request)
        sample, n = st.sampler, [0]

        def altered(logits):
            n[0] += 1
            tok = sample(logits)
            return (tok + 1) % vocab if n[0] % 5 == 0 else tok
        st.sampler = altered
        return st
    svc.begin_call = begin_call


FAULTS = {"state_unchanged": state_unchanged, "token_altered": token_altered}
