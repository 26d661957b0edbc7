"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports JAX or the JAX package; and its entry points
run on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


# the modules of the router slice: each is scanned above and imports
# without triton or a card
ROUTER_SLICE = (
    "repro_torch.core.scheduler", "repro_torch.data.pipeline",
    "repro_torch.trace.synth", "repro_torch.loadgen",
    "repro_torch.loadgen.spec", "repro_torch.loadgen.metrics",
    "repro_torch.loadgen.scenarios", "repro_torch.loadgen.driver",
    "repro_torch.launch.serve", "repro_torch.configs.smollm_360m",
    "repro_torch.configs.opt_6_7b", "repro_torch.configs.qwen2_5_14b",
    "repro_torch.configs.qwen3_32b", "repro_torch.configs.deepseek_67b")


# the modules of the MLA + MoE slice (deepseek-v2-lite-16b)
MLA_SLICE = ("repro_torch.models.mla", "repro_torch.models.moe_layer",
             "repro_torch.configs.deepseek_v2_lite",
             "repro_torch.models.registry")


# the modules of the RWKV6 + zoo slice (rwkv6-1.6b, ZooService)
RWKV6_SLICE = ("repro_torch.models.rwkv6", "repro_torch.configs.rwkv6_1p6b",
               "repro_torch.core.zoo", "repro_torch.core.chunks",
               "repro_torch.core")


# the modules of the training slice (launch/train.py, the optimizer,
# checkpoints, SyntheticLM, every family's loss)
TRAIN_SLICE = ("repro_torch.train", "repro_torch.train.optimizer",
               "repro_torch.train.checkpoint", "repro_torch.launch.train",
               "repro_torch.data.pipeline", "repro_torch.models.common",
               "repro_torch.models.dense", "repro_torch.models.vlm",
               "repro_torch.models.encdec", "repro_torch.models.rglru",
               "repro_torch.models.rwkv6")


# the static analyzer (stdlib only: tests/test_torch_analysis.py runs it
# with torch, numpy, JAX and the reference refused)
ANALYSIS_SLICE = tuple(
    f"repro_torch.analysis.{m}" for m in (
        "findings", "astpass", "config", "lockcheck", "sharedstate",
        "jitcheck", "familycheck", "baseline", "runner", "__main__",
        "fixtures", "fixtures.pr3_deadlock", "fixtures.pr6_restore_race",
        "fixtures.family_dispatch")) + ("repro_torch.analysis",)


# the dry-run tooling (launch/dryrun.py, the mesh description, the
# sharding rules, the configs' ASSIGNED and SHAPES)
DRYRUN_SLICE = ("repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                "repro_torch.sharding", "repro_torch.sharding.rules",
                "repro_torch.configs", "repro_torch.models.api")


def _module_path(mod: str) -> pathlib.Path:
    rel = pathlib.Path(*mod.split(".")[1:])
    path = PORT / rel.with_suffix(".py")
    return path if path.exists() else PORT / rel / "__init__.py"


@pytest.mark.parametrize("mod", ROUTER_SLICE + MLA_SLICE + RWKV6_SLICE
                         + TRAIN_SLICE + ANALYSIS_SLICE + DRYRUN_SLICE)
def test_router_slice_modules_are_scanned(mod):
    assert _module_path(mod) in _sources()


def _imports_cleanly(mods) -> None:
    """A fresh interpreter with ``triton`` unimportable and no card
    imports every module of ``mods``, and neither JAX nor the JAX
    package is loaded by it."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"for m in {tuple(mods)!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton') and sys.modules[m])\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_router_slice_imports_without_triton_or_card():
    _imports_cleanly(ROUTER_SLICE)


def test_mla_slice_imports_without_triton_or_card():
    """``mla.py``, ``moe_layer.py`` and the config import as the router
    slice does, and ``build_model`` builds the family on the CPU only
    when asked."""
    _imports_cleanly(MLA_SLICE)


def test_rwkv6_slice_imports_without_triton_or_card():
    """``rwkv6.py``, its config, ``zoo.py`` (and the core package that
    exports it) import as the router slice does."""
    _imports_cleanly(RWKV6_SLICE)


def test_train_slice_imports_without_triton_or_card():
    """The training substrate (``train/``, ``launch/train.py``,
    ``SyntheticLM``) and the families' losses import as the router
    slice does."""
    _imports_cleanly(TRAIN_SLICE)


def test_dryrun_slice_imports_without_triton_or_card():
    """The dry-run tooling imports as the router slice does."""
    _imports_cleanly(DRYRUN_SLICE)


def test_dryrun_run_defaults_to_the_card(monkeypatch):
    """``launch.dryrun.main`` with ``--run`` runs its cells on the card
    unless ``--device cpu`` is given, and raises before any cell without
    one; without ``--run`` it allocates nothing and needs no card."""
    from repro_torch.launch import dryrun
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                     "--run", "--out", ""])
    rec, = dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                        "--out", ""])
    assert rec["status"] == "ok" and "one_card" not in rec


def test_train_main_defaults_to_the_card(monkeypatch):
    """``launch.train.main`` trains on the card unless ``--device cpu``
    is given."""
    from repro_torch.launch import train
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--ckpt-every", "0"])


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("def f():\n    from repro.core import chunks\n"
                 "import jax.numpy as jnp\n")
    assert {m for m, _ in _imported_roots(p)} == {"repro", "jax"}


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("arch", ["llama2-7b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b"])
def test_build_model_defaults_to_the_card(monkeypatch, arch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    _no_card(monkeypatch)
    cfg = reduced(get_config(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_chunk_codec_defaults_to_the_card(monkeypatch):
    from repro_torch.core.chunks import ChunkCodec
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChunkCodec(("k", "v"), 16)
    assert ChunkCodec(("k", "v"), 16, "cpu").device.type == "cpu"


def test_llmservice_defaults_to_the_card(monkeypatch, tmp_path):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    sc = LLMSConfig(max_ctx_len=64, swap_dir=str(tmp_path))
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMService(model, params, sc)
    with LLMService(model, params, sc, device="cpu") as svc:
        _, toks = svc.callLLM(svc.newLLMCtx(), [1, 2, 3], max_new_tokens=2)
    assert len(toks) == 2


@pytest.mark.parametrize("kw,what", [
    (dict(paged_pool=False), "slot engine"),
    (dict(policy="swap"), "whole-state"),
    (dict(policy="lmk"), "whole-state"),
])
def test_slot_and_whole_state_configurations_serve(kw, what):
    """The configurations once refused here (the slot engine, the
    whole-state policies ``swap`` and ``lmk``) serve on the CPU: two
    contexts, three calls each, with the same tokens as the JAX
    package's service on the same weights, and no paged pool."""
    from _torch_parity import services
    js, ts, cfg = services(budget=12_000, **kw)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, 10).tolist() for _ in range(6)]
    with js, ts:
        out = []
        for svc in (js, ts):
            stubs = [svc.newLLMCtx() for _ in range(2)]
            out.append([svc.callLLM(stubs[i % 2], p, 3)[1]
                        for i, p in enumerate(prompts)])
        assert not ts.paged and not ts.stats()["paged_pool"], what
    assert out[1] == out[0]
    assert all(len(t) == 3 for t in out[1])


def test_every_reference_family_builds():
    """``build_model`` builds every family of the reference's registry
    on the CPU (no family is refused), each from the config of the
    reference's registry that has it, with the reference's KVSpec."""
    from repro.models.registry import FAMILY_CLASSES as JFAMILIES
    from repro.models.registry import family_spec as jfamily_spec
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models.registry import FAMILY_CLASSES, build_model
    assert sorted(FAMILY_CLASSES) == sorted(JFAMILIES)
    built = {}
    for cfg in REGISTRY.values():
        model = build_model(reduced(cfg), device="cpu")
        assert type(model) is FAMILY_CLASSES[cfg.family]
        assert model.device.type == "cpu"
        assert model.kv_spec().__dict__ == jfamily_spec(reduced(
            cfg)).__dict__
        built[cfg.family] = model
    assert sorted(built) == sorted(JFAMILIES)


def test_quant_resident_service_constructs(tmp_path):
    """quant_resident=True is ported: the service builds the int8 QUANT
    arenas beside the bf16 ones and serves a call on the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    sc = LLMSConfig(max_ctx_len=64, swap_dir=str(tmp_path),
                    quant_resident=True)
    with LLMService(model, params, sc, device="cpu") as svc:
        arenas = svc.res.pool.arenas
        assert arenas["k8"].dtype == torch.int8
        assert arenas["v8s"].dtype == torch.float32
        _, toks = svc.callLLM(svc.newLLMCtx(), [1, 2, 3], max_new_tokens=2)
    assert len(toks) == 2
