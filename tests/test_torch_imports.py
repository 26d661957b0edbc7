"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports JAX or the JAX package; and its entry points
run on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib

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


def test_build_model_defaults_to_the_card(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    _no_card(monkeypatch)
    cfg = reduced(get_config("llama2-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


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
    (dict(quant_resident=True), "quant"),
])
def test_unported_configurations_are_refused(kw, what, tmp_path):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cpu")
    sc = LLMSConfig(max_ctx_len=64, swap_dir=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMService(model, {}, sc, device="cpu")


def test_other_families_are_refused():
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("llama2-7b").with_overrides(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
