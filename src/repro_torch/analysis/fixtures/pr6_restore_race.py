"""Reproduction of the restore-vs-AoT race (fixed in the real
tree): a restore path calls ``read_chunk_file`` on a store path while
a same-key ahead-of-time write may still be in flight — the read can
catch the file mid-``os.replace``.  The fixed code orders the read
behind ``self.swapper.wait(key)`` (or routes it through
``swapper.submit`` so the pool's same-key chaining orders it).  The
analyzer must flag the read as ``lock/unordered-store-read``.

Fixture module: never imported by the engine.
"""


def read_chunk_file(path):
    with open(path, "rb") as f:        # fixture stand-in
        return f.read()


class BadRestore:
    def __init__(self, store, swapper):
        self.store = store
        self.swapper = swapper

    def restore_chunk(self, key):
        # BUG: no `self.swapper.wait(key)` before the read —
        # an in-flight AoT write's os.replace races this open().
        raw = read_chunk_file(self.store._path(key))
        return raw

    def restore_chunk_fixed(self, key):
        self.swapper.wait(key)
        raw = read_chunk_file(self.store._path(key))
        return raw
