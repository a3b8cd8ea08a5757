"""Running the reference's examples in-process, for the port's example
tests: ``load_example`` imports ``examples/<name>.py`` (or another folder's
script) as a fresh module, whatever the working directory (the tests then
monkeypatch names in it: its clock, its runtime class), ``run_main`` runs
its ``main()`` under a given ``sys.argv`` and returns the lines it
printed."""
import importlib.util
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]


def load_example(name: str, folder: str = "examples"):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv: List[str], monkeypatch, capsys) -> List[str]:
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    mod.main()
    return capsys.readouterr().out.splitlines()


def printed(capsys) -> List[str]:
    return capsys.readouterr().out.splitlines()
