"""Guards on the port: it imports neither jax nor the reference package,
and its entry points refuse to fall back to the CPU silently."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"paged_decode.py", "wkv6.py", "mamba_scan.py", "ssm.py",
            "moe.py", "rwkv6_1p6b.py", "jamba_v0p1_52b.py",
            "deepseek_v3_671b.py", "scheduler.py", "flash_attention.py",
            "engine.py", "chip_smoke.py", "loss.py", "step.py", "train.py",
            "profile_train.py"} <= names
    assert {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob(
        "*.cu")} >= {"paged_decode.cu", "paged_decode_mla.cu", "wkv6.cu",
                     "mamba_scan.cu", "flash_attention.cu"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_entry_points_default_to_the_card(capsys):
    _no_card()
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    from repro_torch.serve import make_engine

    cfg = smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(cfg)
    model = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(cfg, model, max_len=64)
    assert make_engine(cfg, model, max_len=64, device="cpu").device.type \
        == "cpu"
    outs = serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "9", "--new-tokens",
                       "3", "--report"])
    assert [len(o) for o in outs] == [3, 3]
    assert "report: decode_kernel=plain" in capsys.readouterr().out
