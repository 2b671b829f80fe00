"""The mutation tools' edits still find the text they change.

Each ``torch_tools/*_mutants.py`` breaks a copy of the port by replacing a
text in a source with another, and stops with ``RuntimeError`` when the
text does not occur exactly once.  A source edited since the tool was
written can strand a mutant that way, and the tool then checks nothing.
This test replays every mutant's edits, in order, against the sources held
in memory, as the tools apply them to their copies (each edit against the
source as the earlier ones left it), and writes nothing.  It needs no card.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flashattention_tpu_torch")
TOOLS = os.path.join(REPO, "torch_tools")


def _csrc(edits):
    return [(os.path.join("csrc", source), text, repl) for source, text, repl in edits]


# Each tool's MUTANTS entry -> its edits as (path under flashattention_tpu_torch/,
# text, replacement), in the order the tool applies them.
EDITS_OF = {
    "bwd_mutants": lambda entry: _csrc(entry[1]),
    "quant_mutants": lambda entry: _csrc(entry[1]),
    "tc_mutants": lambda entry: _csrc(entry[1]),
    "window_mutants": lambda entry: _csrc(entry[1]),
    "dropout_mutants": lambda entry: list(entry[3]),
    "draft_mutants": lambda entry: [(os.path.join("csrc", "paged_decode.cu"), text, repl)
                                    for text, repl in entry],
    "f32_mutants": lambda entry: [(os.path.join("csrc", entry[0]), text, repl)
                                  for text, repl in entry[1]],
}


def _load(tool):
    spec = importlib.util.spec_from_file_location(f"_mutant_tool_{tool}",
                                                  os.path.join(TOOLS, f"{tool}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MUTANTS = {tool: _load(tool).MUTANTS for tool in EDITS_OF}
CASES = [(tool, name) for tool, mutants in _MUTANTS.items() for name, entry in mutants.items()
         if EDITS_OF[tool](entry)]


def test_every_tool_is_replayed():
    """Every mutation tool in torch_tools/ is covered, each with mutants."""
    tools = {f[:-3] for f in os.listdir(TOOLS) if f.endswith("_mutants.py")}
    assert tools == set(EDITS_OF)
    assert all(any(t == tool for t, _ in CASES) for tool in tools)


@pytest.mark.parametrize("tool,name", CASES, ids=[f"{t}:{n}" for t, n in CASES])
def test_mutant_edits_apply(tool, name):
    sources = {}
    for path, text, repl in EDITS_OF[tool](_MUTANTS[tool][name]):
        if path not in sources:
            with open(os.path.join(PKG, path)) as fh:
                sources[path] = fh.read()
        assert text != repl, f"{path}: an edit that changes nothing"
        found = sources[path].count(text)
        assert found == 1, f"{path}: expected one {text!r}, found {found}"
        sources[path] = sources[path].replace(text, repl)
