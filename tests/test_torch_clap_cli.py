"""The port's curation CLIs (`python -m adt_str_tpu_torch.scripts.*`) against
the root `scripts/`, on the CPU.

`augment_data_with_clap` runs in a subprocess with `--device cpu` on a YAML
in `tmp_path` whose `${oc.env:CLAP_MODEL_DIR}` / `${oc.env:ADT_DATA}` point
at a checkpoint the port wrote (`config.json` + `model.safetensors`, small
widths at the real input geometry) and at a tree of 48 kHz WAVs; root
`scripts/augment_data_with_clap.py` runs on a copy of the tree, and both
must write the same `<class>/<bin>/` tree.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from adt_str_tpu.clap import curation as jcur
from adt_str_tpu.config import ClapConfig as JClapConfig
from adt_str_tpu.config import load_merged_config as jload_merged_config
from adt_str_tpu.config import make_dataclass_from as jmake_dataclass_from
from adt_str_tpu_torch.clap import model as tmodel
from adt_str_tpu_torch.config import ClapConfig, load_merged_config, make_dataclass_from
from adt_str_tpu_torch.scripts import augment_data_with_clap, convert_augmented_to_hdf5, copy_originals_to_augmented
from adt_str_tpu_torch.synth.bank import load_bank_hdf5
from test_torch_clap import REAL_INPUT_AUDIO, archs
from test_torch_curation import CLAP_SR, build_tree, tree

REPO = Path(__file__).resolve().parent.parent
CLAP_YAML = REPO / "configs" / "preprocess" / "clap.yaml"


def yaml_for() -> str:
    """`configs/preprocess/clap.yaml` with the trees of `build_tree`."""
    return CLAP_YAML.read_text().replace("/SampleToUse", "/library").replace("/GM/GM_Mapped_Reduced", "/GM_ref")


def run(args, env_vars, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env_vars}
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_clap_config_matches_jax(monkeypatch):
    monkeypatch.setenv("CLAP_MODEL_DIR", "/models/clap")
    monkeypatch.setenv("ADT_DATA", "/data")
    ours = load_merged_config(CLAP_YAML)
    theirs = jload_merged_config(CLAP_YAML)
    cfg = make_dataclass_from(ClapConfig, ours.get("clap_config", {}), ours.get("shared", {}))
    jcfg = jmake_dataclass_from(JClapConfig, theirs.get("clap_config", {}), theirs.get("shared", {}))
    assert vars(cfg) == vars(jcfg)
    assert (cfg.model_name, cfg.sample_rate, cfg.batch_size) == ("/models/clap", 48_000, 32)
    assert cfg.sample_pack_root == "/data/SampleToUse"


def test_augment_cli_writes_the_root_scripts_tree(tmp_path):
    (ta, tt), _ = archs(REAL_INPUT_AUDIO)
    model_dir = tmodel.save_checkpoint(tmp_path / "model", tmodel.random_state_dict(ta, tt, seed=5), ta, tt)
    for name in ("port", "jax"):
        build_tree(tmp_path / name, sr=CLAP_SR)
    cfg = tmp_path / "clap.yaml"
    cfg.write_text(yaml_for())
    run(["-m", "adt_str_tpu_torch.scripts.augment_data_with_clap", str(cfg), "--device", "cpu"],
        {"CLAP_MODEL_DIR": str(model_dir), "ADT_DATA": str(tmp_path / "port")})
    run(["scripts/augment_data_with_clap.py", str(cfg)],
        {"CLAP_MODEL_DIR": str(model_dir), "ADT_DATA": str(tmp_path / "jax")})
    ours, theirs = tree(tmp_path / "port" / "GM_ref_clap_augmented"), tree(tmp_path / "jax" / "GM_ref_clap_augmented")
    assert len(ours) == 3 and ours == theirs


def test_num_bins_fails_before_the_model_loads(tmp_path, monkeypatch, capsys):
    def no_load(*args, **kwargs):
        raise AssertionError("the model was loaded")

    monkeypatch.setattr(augment_data_with_clap.ClapWrapper, "from_dir", no_load)
    cfg = tmp_path / "clap.yaml"
    cfg.write_text(yaml_for())
    with pytest.raises(SystemExit) as exc:
        augment_data_with_clap.main([str(cfg), "--num_bins", "7", "--device", "cpu"])
    assert exc.value.code == 2 and "num_bins must be" in capsys.readouterr().err


def test_augment_cli_needs_a_device_without_cuda(tmp_path, monkeypatch):
    (ta, tt), _ = archs(REAL_INPUT_AUDIO)
    model_dir = tmodel.save_checkpoint(tmp_path / "model", tmodel.random_state_dict(ta, tt, seed=5), ta, tt)
    monkeypatch.setenv("CLAP_MODEL_DIR", str(model_dir))
    monkeypatch.setenv("ADT_DATA", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "clap.yaml"
    cfg.write_text(yaml_for())
    with pytest.raises(RuntimeError, match="no CUDA"):
        augment_data_with_clap.main([str(cfg)])


def test_copy_originals_and_hdf5_clis_match_jax(tmp_path):
    """The gold bins, then the bank file: the same tree and the same
    datasets as the JAX package's functions, and the port's bank loader
    reads it."""
    for name in ("port", "jax"):
        ref, _ = build_tree(tmp_path / name, sr=CLAP_SR)
        (tmp_path / name / "aug" / "35" / "100-90").mkdir(parents=True)
        shutil.copy2(ref / "35" / "ref_35.wav", tmp_path / name / "aug" / "35" / "100-90" / "lib.wav")
    copy_originals_to_augmented.main([str(tmp_path / "port" / "GM_ref"), "--augmented_root",
                                      str(tmp_path / "port" / "aug")])
    jcur.copy_originals_to_augmented(str(tmp_path / "jax" / "GM_ref"), tmp_path / "jax" / "aug")
    assert tree(tmp_path / "port" / "aug") == tree(tmp_path / "jax" / "aug")
    assert len(tree(tmp_path / "port" / "aug")) == 3

    out = convert_augmented_to_hdf5.main([str(tmp_path / "port" / "aug"), str(tmp_path / "port" / "bank"),
                                          "--sample_rate", "24000"])
    jout = jcur.convert_augmented_to_hdf5(str(tmp_path / "jax" / "aug"), str(tmp_path / "jax" / "bank"), 24000)
    assert out.name == "bank@24000.hdf5"
    with h5py.File(out) as a, h5py.File(jout) as b:
        for key in ("paths", "labels", "bins", "sample_rates", "lengths"):
            np.testing.assert_array_equal(a["index"][key][()], b["index"][key][()])
        for path in a["index"]["paths"][()]:
            label, bin_label, name = Path(path.decode()).parts
            np.testing.assert_array_equal(a[label][bin_label][Path(name).stem][()],
                                          b[label][bin_label][Path(name).stem][()])
    bank = load_bank_hdf5(str(out), max_len=24000)
    assert set(bank.pitches()) == {35, 42} and bank.bin_count.sum() == 3
    with pytest.raises(FileExistsError):
        convert_augmented_to_hdf5.main([str(tmp_path / "port" / "aug"), str(tmp_path / "port" / "bank"),
                                        "--sample_rate", "24000"])
