"""The port's own YAML reader (`adt_str_tpu_torch/config.py:parse_yaml`)
against the JAX package's loader (PyYAML with the YAML 1.2 float grammar).

The machine with the card has no PyYAML, so the port reads `configs/`
itself: every file there must give the same dict as the JAX package's
`load_config_from_yaml`, value types included, and anything outside the
subset those files use must raise a ValueError that names the file and line.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from adt_str_tpu import config as jconfig
from adt_str_tpu_torch import config as tconfig

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of the same types (1, 1.0 and True compare equal in Python)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_config_file_is_covered():
    assert len(CONFIGS) >= 17


@pytest.mark.parametrize("adt_data", ["unset", "set"])
@pytest.mark.parametrize("path", CONFIGS)
def test_reader_matches_pyyaml_on_every_config(path, adt_data, monkeypatch):
    if adt_data == "set":
        monkeypatch.setenv("ADT_DATA", "/data/adt")
    else:
        monkeypatch.delenv("ADT_DATA", raising=False)
    ours, ref = tconfig.load_config_from_yaml(REPO / path), jconfig.load_config_from_yaml(REPO / path)
    assert _same(ours, ref), (ours, ref)
    text = (REPO / path).read_text()
    if "${oc.env:ADT_DATA}" in text:
        assert ("/data/adt" in repr(ours)) == (adt_data == "set")


def _load_both(tmp_path, text: str):
    path = tmp_path / "case.yaml"
    path.write_text(text)
    return tconfig.load_config_from_yaml(path), jconfig.load_config_from_yaml(path)


@pytest.mark.parametrize("text", ["8e-4", "1e-5", "1.0", ".5", "-.inf", "5.0e-5", "+3", "1.", "2E+3", ".NaN"])
def test_yaml12_float_grammar(tmp_path, text):
    ours, ref = _load_both(tmp_path, f"training:\n  value: {text}  # a comment\n")
    assert _same(ours, ref), (ours, ref)
    assert isinstance(ours["training"]["value"], float if text != "+3" else int)


@pytest.mark.parametrize("form", ["${oc.env:ADT_YAML_TEST}", "${ADT_YAML_TEST}"])
def test_env_vars_are_substituted_before_parsing(tmp_path, monkeypatch, form):
    monkeypatch.setenv("ADT_YAML_TEST", "/mnt/x")
    text = f'a:\n  quoted: "{form}/oneshot"\n  bare: {form}/p\n  lr: 1e-4\n'
    ours, ref = _load_both(tmp_path, text)
    assert _same(ours, ref)
    assert ours == {"a": {"quoted": "/mnt/x/oneshot", "bare": "/mnt/x/p", "lr": 1e-4}}


def test_reader_reads_what_pyyaml_writes(tmp_path):
    """Block sequences, indentless as PyYAML writes them, and its quoting."""
    import yaml

    raw = {"serving": {"buckets": [1, 2, 4], "port": 0, "host": "127.0.0.1"}, "x": {"on": "yes", "f": 1e-5,
           "empty": [], "n": None, "deep": {"list": ["a", "b: c", 2.5]}}, "z": 3}
    ours, ref = _load_both(tmp_path, yaml.safe_dump(raw))
    assert _same(ours, ref) and _same(ours, raw), (ours, raw)
    ours, ref = _load_both(tmp_path, "a:\n  seq:\n    - 1\n    - two\n  k: v\nb:\n- 3\n")
    assert _same(ours, ref) and ours == {"a": {"seq": [1, "two"], "k": "v"}, "b": [3]}


def test_scalars_flow_sequences_and_nesting(tmp_path):
    text = (
        "# header\n\nx:\n  s: 'it''s'\n  d: \"a # not a comment\"\n  n: null\n  t: ~\n  b: true\n"
        "  seq: [1, 2.5, foo, 'q', null]\n  empty: []\n  nested:\n    deeper: -7\n  after: bare words\ny:\n"
    )
    ours, ref = _load_both(tmp_path, text)
    assert _same(ours, ref), (ours, ref)
    assert ours["y"] is None and ours["x"]["nested"] == {"deeper": -7}


@pytest.mark.parametrize(
    "text, line, what",
    [
        ("a: 1\nb: &anchor 2\n", 2, "anchor"),
        ("a:\n  b: |\n    text\n", 2, "block scalar"),
        ("a: {b: 1}\n", 1, "flow mapping"),
        ("a:\n\tb: 1\n", 2, "tab"),
        ("a:\n  b: 1\n  c: 2\n  b: 3\n", 4, "duplicate key 'b'"),
        ("a: 1\nb: *alias\n", 2, "alias"),
        ("a:\n  - 1\n  - b: 2\n", 3, "mapping inside a value"),
        ("a:\n- 1\n-\n  - 2\n", 3, "`- scalar` items only"),
        ("a: one\n  two\n", 2, "multi-line scalar"),
        ("a: yes\n", 1, "YAML 1.1 and 1.2"),
    ],
    ids=["anchor", "block-scalar", "flow-mapping", "tab-indent", "duplicate-key", "alias", "mapping-in-a-sequence",
         "nested-sequence", "multi-line-scalar", "yes-no"],
)
def test_reader_refuses_what_it_does_not_take(tmp_path, text, line, what):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"bad\.yaml:{line}: .*{what}"):
        tconfig.load_config_from_yaml(path)


def test_from_yaml_loads_without_pyyaml():
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "from adt_str_tpu_torch.config import FrameworkConfig\n"
        "cfg = FrameworkConfig.from_yaml('configs/serve/ENSTserving.yaml')\n"
        "assert cfg.model.use_pallas_mel and cfg.serving.buckets == (1, 2, 4, 8, 16, 32, 64)\n"
        "assert 'yaml' not in {m.split('.')[0] for m in sys.modules if sys.modules[m] is not None}\n"
        "print(cfg.inference.checkpoint_path)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "checkpoints/setting-1"


def test_serve_cli_gets_past_its_config_without_pyyaml(tmp_path):
    """`python -m adt_str_tpu_torch.serve <yaml>` with PyYAML blocked reads
    its config and stops at the missing checkpoint."""
    code = (
        "import runpy, sys\n"
        "sys.modules['yaml'] = None\n"
        f"sys.argv = ['serve', {str(REPO / 'configs/serve/ENSTserving.yaml')!r}, '--device', 'cpu']\n"
        "runpy.run_module('adt_str_tpu_torch.serve', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode != 0
    assert "Loading checkpoint: checkpoints/setting-1" in out.stdout
    assert "FileNotFoundError" in out.stderr and "checkpoints/setting-1" in out.stderr, out.stderr[-2000:]
    assert "ImportError" not in out.stderr and "No module named" not in out.stderr
