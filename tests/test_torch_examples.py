"""The port's walkthroughs (`gf3x_torch/examples/`, counterparts of gf3x's
examples/*.py) on the CPU: each `main` runs with device='cpu' into a
temporary directory and passes its own assertions (bit-exact payloads,
CRC, the ARQ session completing); each refuses to run without a card when
it is asked for the default device; none imports jax or gf3x."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gf3x_torch.examples import EXAMPLES, run

REPO = Path(__file__).resolve().parent.parent
EXAMPLE_DIR = REPO / "gf3x_torch" / "examples"

# what each walkthrough leaves in its directory
WRITES = {"end_to_end": ["tx.wav", "rx.wav", "end_to_end.py", "ber.png"],
          "arq_file_transfer": ["arq_round0.wav", "arq_round1.wav"],
          "adaptive_link": ["probe_rx.wav", "loaded_rx.wav"],
          "live_stream": ["report.bin"]}


def test_every_gf3x_example_has_a_port():
    """One module per script of examples/, under the same name."""
    assert sorted(EXAMPLES) == sorted(
        p.stem for p in (REPO / "examples").glob("*.py"))
    assert all((EXAMPLE_DIR / f"{name}.py").is_file() for name in EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    """The walkthrough's `main` on the CPU: its assertions hold and it
    leaves its files."""
    mod = importlib.import_module(f"gf3x_torch.examples.{name}")
    mod.main(str(tmp_path), device="cpu")
    for f in WRITES[name]:
        if f.endswith(".png") and importlib.util.find_spec(
                "matplotlib") is None:
            continue
        assert (tmp_path / f).is_file(), f
    assert capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_is_cuda_without_fallback(name, tmp_path):
    """With no device given, the walkthrough asks for the card: without one
    it exits non-zero before writing anything, from `main` and from its
    command line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"gf3x_torch.examples.{name}")
    for call in (lambda: mod.main(str(tmp_path / "a")),
                 lambda: run(mod.main, "", [str(tmp_path / "b")]),
                 lambda: run(mod.main, "", [str(tmp_path / "c"), "--device",
                                            "cuda"])):
        with pytest.raises(SystemExit) as e:
            call()
        assert e.value.code not in (0, None)
    assert not any(tmp_path.iterdir())


def test_examples_import_neither_jax_nor_gf3x():
    """No module under gf3x_torch/examples/ imports jax, gf3x or bench, and
    importing them all loads neither."""
    for path in EXAMPLE_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "gf3x",
                                               "bench") for n in names), \
                (path.name, names)
    code = ("import sys; " + "; ".join(
        f"import gf3x_torch.examples.{name}" for name in EXAMPLES)
        + "; import gf3x_torch.parallel; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gf3x', 'bench')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
